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
    """The CUDA kernel reads the same int8 planes, transposed, and the
    same correction column as the Pallas kernel."""
    ref, port = rings
    mm, pm = ref._matmul_ntt(), port._matmul_ntt()
    for name in ("fwd", "inv"):
        ref_planes = getattr(mm, f"{name}_planes")
        tab = getattr(pm, name)
        np.testing.assert_array_equal(tab.planes.numpy(), ref_planes)
        np.testing.assert_array_equal(tab.planes_t.numpy(),
                                      np.swapaxes(ref_planes, 1, 2))
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
