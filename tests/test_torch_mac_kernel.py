"""The Ajtai MAC kernel (csrc/mac.cu, ops/mac_matmul.py ``mod_mac_cuda``)
on the CPU, where the kernel cannot run:

* a model of the kernel's steps in numpy, as the CUDA source runs them:
  the launch's tiles (``mac_matmul.tiles``), the key pieces made from the
  residues key' by three Shoup products as the bytes of 2^8a * key' mod q
  (A rows 4j + b), in the contraction order 4k + a, x's words entering as
  their unsigned bytes, the int32 plane sums accumulated per tile and per
  chunk of 8 k (asserted below 2^31 after every chunk), rows and k past
  the tensor as the zeros TMA fills, and the epilogue's reduction of
  sum_b 2^8b T_b with the wrapper's constants (``mac_consts``); held
  against the plain ``mod_mac`` and the JAX package's ``mod_mac`` at
  J = 1, n = 1, n not a multiple of 8, K not a multiple of the chunk, two
  key-row and two column tiles, q - 1 in one key row and one input lane,
  and K = KERNEL_MAX_K at a tiny d;
* the Shoup product and the reduction at their extremes;
* ``key_slice`` on residues against slicing the planes, ``mod_mac`` by
  device, the wrapper's argument checks, and the tile constants against
  the CUDA source.

Exact equality throughout."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringo_tpu import backend as ref_backend  # noqa: F401  (x64 before tracing)
from ringo_tpu.ops import mac_matmul as ref_mac
from ringo_tpu.rings.rns import RnsRing, ntt_friendly_primes
from ringo_tpu_torch.bench_mac import TOP_PRIMES
from ringo_tpu_torch.ops import mac_matmul
from ringo_tpu_torch.rings.rns import RnsRing as PortRing

M32 = 0xFFFFFFFF
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "ringo_tpu_torch", "csrc", "mac.cu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shoup(w, c, cs, q):
    """csrc/mac.cu ``shoup`` on uint64 arrays of 32-bit words."""
    w = w.astype(np.uint64)
    r = (w * np.uint64(c) - ((w * np.uint64(cs)) >> np.uint64(32)) * np.uint64(q)
         ) & np.uint64(M32)
    return np.minimum(r, (r - np.uint64(q)) & np.uint64(M32))


def reduce_mu(s, q, mu):
    """csrc/mac.cu ``reduce`` on Python ints (object arrays) s < 2^64:
    qhat = (s * mu) >> 64 is floor(s / q) or one less (s * (2^64 / q - mu)
    < 2^64), so r = s - qhat * q, computed mod 2^32, is below 2q and one
    conditional subtraction gives s mod q."""
    s = np.asarray(s, dtype=object)
    r = (s - ((s * mu) >> 64) * q) & M32
    return np.where(r >= q, r - q, r)


def kernel_model(primes, kres, x):
    """csrc/mac.cu step for step: key' residues kres uint64 [L, J, K, d],
    x uint64 [L, K, n, d] -> uint64 [L, J, n, d]."""
    consts = mac_matmul.mac_consts(primes)
    L, J, K, d = kres.shape
    n = x.shape[2]
    N, n_tiles, j_tiles, Jt = mac_matmul.tiles(J, n)
    assert 4 * Jt <= 64 and N in mac_matmul.TILE_WIDTHS
    KC = mac_matmul.KC
    Kp = -(-K // KC) * KC
    out = np.zeros((L, J, n, d), dtype=np.uint64)
    for l in range(L):
        q, mu, c1, c1s, c2, c2s, c3, c3s = (int(v) for v in consts[l])
        for jt in range(j_tiles):
            j0 = jt * Jt
            w = np.zeros((Jt, Kp, d), dtype=np.uint64)      # TMA's zeros
            part = kres[l, j0:j0 + Jt]
            w[:part.shape[0], :K] = part
            f = [w, shoup(w, c1, c1s, q), shoup(w, c2, c2s, q),
                 shoup(w, c3, c3s, q)]
            # A rows 4j + b: byte b of f_a at contraction byte 4k + a
            A = np.zeros((64, Kp, 4, d), dtype=np.int64)
            for b in range(4):
                for a in range(4):
                    A[b:4 * Jt:4, :, a] = (f[a] >> np.uint64(8 * b)) & np.uint64(255)
            for nt in range(n_tiles):
                n0 = nt * N
                xt = np.zeros((Kp, N, d), dtype=np.uint64)
                part = x[l, :, n0:n0 + N]
                xt[:K, :part.shape[1]] = part
                xb = np.stack([(xt >> np.uint64(8 * a)) & np.uint64(255)
                               for a in range(4)], axis=1).astype(np.int64)
                T = np.zeros((64, N, d), dtype=np.int64)
                for c in range(Kp // KC):
                    ks = slice(c * KC, (c + 1) * KC)
                    T += np.einsum("rkae,kane->rne", A[:, ks], xb[ks])
                    assert T.max() < 1 << 31          # int32 accumulators
                jv, nv = min(Jt, J - j0), min(N, n - n0)
                for j in range(jv):
                    s = sum(T[4 * j + b, :nv].astype(object) << (8 * b)
                            for b in range(4))
                    assert max(s.flat) < 1 << 64
                    out[l, j0 + j, n0:n0 + nv] = reduce_mu(
                        s, q, mu).astype(np.uint64)
    return out


def _residues(primes, rng, *shape):
    q = np.array(primes, dtype=np.uint64).reshape(-1, *([1] * len(shape)))
    return rng.integers(0, q, size=(len(primes), *shape), dtype=np.uint64)


def _planes(res):
    """uint64 residues [L, ...] -> the JAX package's u32 digit planes."""
    return np.stack([res & np.uint64(0xFFFF), res >> np.uint64(16)]
                    ).astype(np.uint32)


def _primes(bits, d, L):
    """L primes 1 mod 2d just above 2^bits, or for bits 31 the two largest
    below 2^31 that are 1 mod 512."""
    return TOP_PRIMES[:L] if bits == 31 else ntt_friendly_primes(bits, 2 * d, L)


# (J, K, n, prime bits, L, d): J = 1 and n = 1; K not a multiple of 8 and
# n not one of 8; two key-row tiles and two column tiles; the commit's
# inner MAC at a tiny d; K = KERNEL_MAX_K with the largest primes
CASES = [(1, 7, 1, 22, 2, 4), (3, 20, 13, 26, 3, 4), (21, 9, 81, 31, 2, 2),
         (10, 545, 65, 25, 3, 2), (1, mac_matmul.KERNEL_MAX_K, 1, 31, 1, 2)]


@pytest.mark.parametrize("J,K,n,bits,L,d", CASES)
def test_kernel_model_matches_plain_and_jax(J, K, n, bits, L, d):
    primes = _primes(bits, d, L)
    rng = np.random.default_rng(J * 1000 + K + n)
    key = _residues(primes, rng, J, K, d)
    x = _residues(primes, rng, K, n, d)
    q1 = np.array(primes, dtype=np.uint64) - np.uint64(1)
    key[:, 0] = q1[:, None, None]                  # q - 1 in one key row
    x[:, :, 0, 0] = q1[:, None]                    # and in one input lane
    if K == mac_matmul.KERNEL_MAX_K:               # the bounds: q - 1 throughout
        key[:] = q1[:, None, None, None]
        x[:] = q1[:, None, None, None]
    port = PortRing(d, primes, "cpu")
    kt = torch.from_numpy(key.astype(np.int32))
    xt = torch.from_numpy(x.astype(np.int32))
    kres = mac_matmul.folded(port, kt)
    got = kernel_model(primes, kres.numpy().astype(np.uint64), x)
    plain = mac_matmul.mod_mac(port, kres, xt)
    np.testing.assert_array_equal(got, plain.numpy().astype(np.uint64))
    ring = RnsRing(d, primes)
    kp = ref_mac.fold_key(ring, jnp.asarray(_planes(key)), jnp)
    want = np.asarray(ref_mac.mod_mac(ring, kp, jnp.asarray(_planes(x)), jnp))
    np.testing.assert_array_equal(_planes(got), want)


def test_shoup_and_reduction_at_extremes():
    for bits in (22, 25, 28, 30, 31):
        for q in _primes(bits, 256, 2):
            qn, mu, *pairs = (int(v) for v in mac_matmul.mac_consts([q])[0])
            assert qn == q
            w = np.array([0, 1, q - 1, q - 2, 1 << 30, M32], dtype=np.uint64)
            for a, (c, cs) in enumerate(zip(pairs[::2], pairs[1::2]), 1):
                assert c == (1 << (8 * a)) % q
                got = shoup(w, c, cs, q)
                assert [int(v) for v in got] == [int(v) * c % q for v in w]
            s = [0, 1, q - 1, q, 2 * q - 1, (1 << 55) + 12345, (1 << 60) - 1,
                 (q - 1) * (1 << 34), (1 << 64) - 1,
                 sum((2 ** 31 - 1) << (8 * b) for b in range(4))]
            got = reduce_mu(np.array(s, dtype=object), q, mu)
            assert list(got) == [v % q for v in s]


def test_key_slice_on_residues_equals_sliced_planes():
    d, primes = 4, ntt_friendly_primes(26, 8, 3)
    port = PortRing(d, primes, "cpu")
    rng = np.random.default_rng(5)
    key = torch.from_numpy(_residues(primes, rng, 6, 11, d).astype(np.int32))
    x = torch.from_numpy(_residues(primes, rng, 11, 2, d).astype(np.int32))
    pl, rows = torch.tensor([0, 2]), torch.tensor([1, 4, 5])
    sub = PortRing(d, [primes[0], primes[2]], "cpu")
    kres = mac_matmul.folded(port, key)
    res = mac_matmul.key_slice(kres, pl, rows)
    assert res.is_contiguous() and res.shape == (2, 3, 11, d)
    idx = (torch.arange(mac_matmul.P7)[:, None] * 6 + rows[None]).reshape(-1)
    planes = mac_matmul.key_planes(port, kres)[pl][:, :, idx]
    np.testing.assert_array_equal(mac_matmul.key_planes(sub, res).numpy(),
                                  planes.numpy())
    np.testing.assert_array_equal(
        mac_matmul.mod_mac(sub, res, x[pl]).numpy(),
        mac_matmul.mod_mac(port, kres, x)[pl][:, rows].numpy())


def test_cpu_dispatch_and_argument_checks():
    d, primes = 256, ntt_friendly_primes(25, 512, 2)
    port = PortRing(d, primes, "cpu")
    rng = np.random.default_rng(9)
    key = torch.from_numpy(_residues(primes, rng, 2, 5, d).astype(np.int32))
    x = torch.from_numpy(_residues(primes, rng, 5, 3, d).astype(np.int32))
    kres = mac_matmul.folded(port, key)
    assert kres.dtype == torch.int32 and kres.is_contiguous()
    launches = dict(mac_matmul.backend.LAUNCHES)
    got = mac_matmul.mod_mac(port, kres, x.transpose(1, 2).contiguous().transpose(1, 2))
    np.testing.assert_array_equal(got.numpy(),
                                  mac_matmul.mod_mac_plain(port, kres, x).numpy())
    assert mac_matmul.backend.LAUNCHES == launches
    with pytest.raises(TypeError):
        mac_matmul.mod_mac_cuda(port, kres.long(), x)
    with pytest.raises(TypeError):
        mac_matmul.mod_mac_cuda(port, kres, x.long())
    with pytest.raises(TypeError):
        mac_matmul.mod_mac_cuda(port, mac_matmul.fold_key(port, key), x)
    with pytest.raises(ValueError):
        mac_matmul.mod_mac_cuda(port, kres[:, :, :4], x)
    with pytest.raises(ValueError):
        mac_matmul.mod_mac_cuda(port, kres[..., :128].contiguous(),
                                x[..., :128])
    with pytest.raises(ValueError):
        mac_matmul.mod_mac_cuda(port, kres, x[..., 1:255])
    with pytest.raises(ValueError):
        mac_matmul.folded(port, torch.zeros((2, 1, mac_matmul.MAX_K + 1, 1),
                                            dtype=torch.int32))
    big = mac_matmul.KERNEL_MAX_K + 1
    with pytest.raises(ValueError):
        mac_matmul.mod_mac_cuda(port, torch.zeros((2, 1, big, d), dtype=torch.int32),
                                torch.zeros((2, big, 1, d), dtype=torch.int32))
    with pytest.raises(ValueError, match="card"):
        mac_matmul.mod_mac_cuda(port, kres, x)    # right arguments, CPU tensors


def test_tiles_match_the_cuda_source():
    with open(CSRC) as f:
        src = f.read()
    widths = re.search(r"const int widths\[\d+\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(w) for w in widths.split(",")) == mac_matmul.TILE_WIDTHS
    for name, attr in (("KC", "KC"), ("MAX_JT", "MAX_JT"),
                       ("MAX_K", "KERNEL_MAX_K")):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert int(m.group(1)) == getattr(mac_matmul, attr), name
    assert [mac_matmul.tiles(J, n) for J, n in
            [(10, 65), (6, 1), (15, 36), (21, 513), (1, 260)]] == [
        (80, 1, 1, 10), (8, 1, 1, 6), (48, 1, 1, 15), (80, 7, 2, 11),
        (80, 4, 1, 1)]
