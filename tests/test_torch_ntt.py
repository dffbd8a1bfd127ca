"""The port's plain matmul NTT (byte split, float64 matmul, integer
recombine: the plain version of the CUDA kernel) against the Pallas
kernel in interpret mode and the XLA matmul path, both directions, at
TILE + 17 rows as tests/test_ntt_pallas.py runs them.  Exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringo_tpu import backend  # noqa: F401  (x64 before tracing)
from ringo_tpu.ops.ntt_pallas import TILE, PallasNTT
from ringo_tpu.rings.rns import RnsRing, ntt_friendly_primes
from ringo_tpu_torch.ops import ntt_matmul
from ringo_tpu_torch.rings.rns import RnsRing as PortRing

D = 256


@pytest.fixture(scope="module")
def rings():
    primes = ntt_friendly_primes(30, 2 * D, 3)
    return RnsRing(D, primes), PortRing(D, primes, "cpu")


def _rand_poly(ring, n, seed):
    rng = np.random.default_rng(seed)
    res = rng.integers(
        0, np.array(ring.primes, dtype=np.uint64).reshape(-1, 1, 1),
        size=(ring.L, n, D), dtype=np.uint64)
    res[:, 0, :3] = np.array(ring.primes, dtype=np.uint64)[:, None] - 1
    res[:, 1, :] = 0
    return ring.from_u64(res)


@pytest.mark.parametrize("fn", ["ntt_mform", "intt_imform"])
def test_plain_matches_pallas_and_xla(rings, fn):
    ref, port = rings
    mm = ref._matmul_ntt()
    n = TILE + 17
    x = _rand_poly(ref, n, 7)
    want = np.asarray(getattr(mm, fn)(jnp.asarray(x)))
    pallas = np.asarray(getattr(PallasNTT(mm), fn)(jnp.asarray(x),
                                                   interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got = getattr(port, fn)(PortRing.from_planes(x))
    np.testing.assert_array_equal(PortRing.to_planes(got).numpy(), want)


def test_kernel_tables_match_reference(rings):
    """The port holds the same int8 planes and correction column as the
    Pallas kernel; the CUDA kernel's layout of the planes (contraction
    index last, k = 4*j + a) round-trips to them."""
    ref, port = rings
    mm, pm = ref._matmul_ntt(), port._matmul_ntt()
    for name in ("fwd", "inv"):
        ref_planes = getattr(mm, f"{name}_planes")
        tab = getattr(pm, name)
        np.testing.assert_array_equal(tab.planes.numpy(), ref_planes)
        pk = tab.planes_k.numpy()
        np.testing.assert_array_equal(
            ntt_matmul.planes_from_kernel_layout(pk), ref_planes)
        j, a = np.arange(D)[:, None], np.arange(4)[None, :]
        np.testing.assert_array_equal(
            pk[:, :, (4 * j + a).ravel()],
            np.swapaxes(ref_planes, 1, 2)[:, :, (a * D + j).ravel()])
        np.testing.assert_array_equal(tab.corr.numpy(),
                                      getattr(mm, f"{name}_corr")[:, 0, :])


def test_ring_ops_match_reference(rings):
    ref, port = rings
    rng = np.random.default_rng(5)
    a, b = _rand_poly(ref, 9, 1), _rand_poly(ref, 9, 2)
    ta, tb = PortRing.from_planes(a), PortRing.from_planes(b)
    planes = lambda t: PortRing.to_planes(t).numpy()
    np.testing.assert_array_equal(planes(port.add(ta, tb)), ref.add(a, b))
    np.testing.assert_array_equal(planes(port.mul_mont(ta, tb)),
                                  ref.mul_mont(a, b))
    vals = rng.integers(-(1 << 51), 1 << 51, (4, D))
    vals[0, :3] = [0, -1, (1 << 51) - 1]
    np.testing.assert_array_equal(
        planes(port.embed_int64(torch.from_numpy(vals))),
        np.asarray(ref.embed_int64(jnp.asarray(vals))))
    assert port.to_bytes(PortRing.to_planes(ta)) == ref.to_bytes(a)


def test_cuda_wrapper_refuses_cpu_tensors(rings):
    _, port = rings
    mm = port._matmul_ntt()
    v = torch.zeros((port.L, 4, D), dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt_matmul.ntt_mform_cuda(v, mm.fwd, mm.q32)


# ---- the kernel's division-free reduction and its layout of the map

def _commit_rings():
    from ringo_tpu_torch import jindo
    from ringo_tpu_torch.fields import ZP255
    p = jindo.new_parameters(ZP255, 1 << 10, 1)
    return {"ring_q": p.ring_q, "ring_q_out": p.ring_q_out}


@pytest.mark.parametrize("name", ["ring_q", "ring_q_out"])
def test_barrett_reduce_equals_mod(name):
    """A numpy emulation of the kernel's epilogue reduction, 32-bit halves
    and all, with the constants MatmulNTT hands the kernel, equals % q at
    the edges and on 10^5 random sums below 2^56, for every prime."""
    ring = _commit_rings()[name]
    mu = ring._matmul_ntt().fwd.mu.numpy().view(np.uint64)
    rng = np.random.default_rng(56)
    for q, m in zip(ring.primes, mu):
        s = np.concatenate([
            np.array([0, q - 1, q, q + 1, 2 * q - 1, (1 << 56) - 1,
                      (1 << 56) - q], dtype=np.uint64),
            rng.integers(0, 1 << 56, 100_000, dtype=np.uint64)])
        got = ntt_matmul.barrett_reduce(s, q, int(m))
        np.testing.assert_array_equal(got, s % np.uint64(q))


@pytest.mark.parametrize("q", [(1 << 30) + 3 * 512 + 1, (1 << 24) + 1,
                               (1 << 24) - 3, (1 << 20) + 7, 12289])
def test_barrett_reduce_both_branches(q):
    """Above 2^24 the 32 x 64-bit product, at and below it the full one."""
    m = int(ntt_matmul.barrett_mu([q]).view(np.uint64)[0])
    assert m == (1 << (88 if q > (1 << 24) else 64)) // q
    rng = np.random.default_rng(q)
    s = np.concatenate([
        np.array([0, q - 1, q, (1 << 56) - 1], dtype=np.uint64),
        rng.integers(0, 1 << 56, 100_000, dtype=np.uint64)])
    np.testing.assert_array_equal(ntt_matmul.barrett_reduce(s, q, m),
                                  s % np.uint64(q))


def test_kernel_layout_round_trip():
    rng = np.random.default_rng(3)
    planes = rng.integers(0, 128, (2, 4 * D, 5 * D)).astype(np.int8)
    pk = ntt_matmul.kernel_layout(planes)
    assert pk.shape == (2, 5 * D, 4 * D) and pk.flags.c_contiguous
    assert pk[1, 7, 4 * 5 + 2] == planes[1, 2 * D + 5, 7]
    np.testing.assert_array_equal(
        ntt_matmul.planes_from_kernel_layout(pk), planes)
    # the matching operand: a row of int32 residues read as bytes
    x = rng.integers(0, 1 << 31, (3, D)).astype(np.int32)
    by = x.view(np.uint8).reshape(3, 4 * D).astype(np.int64)
    split = np.concatenate([(x.astype(np.int64) >> (8 * a)) & 0xFF
                            for a in range(4)], axis=1)
    np.testing.assert_array_equal(by @ pk[0].T.astype(np.int64),
                                  split @ planes[0].astype(np.int64))


@pytest.mark.parametrize("n", [1, 6, 65])
def test_plain_matches_xla_at_ragged_rows(rings, n):
    ref, port = rings
    mm = ref._matmul_ntt()
    x = _rand_poly(ref, max(n, 2), 11)[:, :, :n]
    for fn in ("ntt_mform", "intt_imform"):
        want = np.asarray(getattr(mm, fn)(jnp.asarray(x)))
        got = getattr(port, fn)(PortRing.from_planes(x))
        np.testing.assert_array_equal(PortRing.to_planes(got).numpy(), want)
