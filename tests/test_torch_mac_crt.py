"""The port's Ajtai MAC (float64 matmul over folded key planes) against
the JAX package's int8 mod_mac, and its CrtShiftEmbed against the JAX
one.  Exact equality."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringo_tpu import backend  # noqa: F401  (x64 before tracing)
from ringo_tpu.ops import mac_matmul as ref_mac
from ringo_tpu.rings.rns import RnsRing, ntt_friendly_primes
from ringo_tpu.rings.rns_device import CrtShiftEmbed as RefCrt
from ringo_tpu_torch.ops import mac_matmul
from ringo_tpu_torch.rings.rns import RnsRing as PortRing
from ringo_tpu_torch.rings.rns_device import CrtShiftEmbed


def _rand(ring, rng, *batch):
    res = rng.integers(0, np.array(ring.primes, dtype=np.uint64).reshape(
        -1, *([1] * (len(batch) + 1))), size=(ring.L, *batch, ring.d),
        dtype=np.uint64)
    return ring.from_u64(res)


@pytest.mark.parametrize("J,K,n", [(3, 7, 2), (10, 45, 3)])
def test_mod_mac_matches_jax(J, K, n):
    d = 256
    primes = ntt_friendly_primes(25, 2 * d, 3)
    ring, port = RnsRing(d, primes), PortRing(d, primes, "cpu")
    rng = np.random.default_rng(J * 100 + K)
    key = _rand(ring, rng, J, K)
    x = _rand(ring, rng, K, n)
    # extreme residues: q - 1 everywhere in one key row and one input lane
    q1 = (np.array(primes, dtype=np.uint32) - 1)
    key[0, :, 0] = (q1 & 0xFFFF)[:, None, None]
    key[1, :, 0] = (q1 >> 16)[:, None, None]
    x[0, :, 0, 0] = (q1 & 0xFFFF)[:, None]
    x[1, :, 0, 0] = (q1 >> 16)[:, None]
    kp = ref_mac.fold_key(ring, jnp.asarray(key), jnp)
    want = np.asarray(ref_mac.mod_mac(ring, kp, jnp.asarray(x), jnp))
    planes = mac_matmul.fold_key(port, PortRing.from_planes(key))
    corr = mac_matmul.fold_corr(planes)
    np.testing.assert_array_equal(planes.numpy().astype(np.int8),
                                  np.asarray(kp))
    np.testing.assert_array_equal(corr.numpy(),
                                  np.asarray(ref_mac.fold_corr(kp)))
    got = mac_matmul.mod_mac(port, mac_matmul.folded(port, PortRing.from_planes(key)),
                             PortRing.from_planes(x))
    np.testing.assert_array_equal(PortRing.to_planes(got).numpy(), want)


@pytest.mark.parametrize("shift", [0, 7, 16, 41])
def test_crt_shift_embed_matches_jax(shift):
    D = 32
    rng = random.Random(42 + shift)
    src_p = ntt_friendly_primes(25, 2 * D, 3)
    dst_p = ntt_friendly_primes(22, 2 * D, 2)
    src, dst = RnsRing(D, src_p), RnsRing(D, dst_p)
    res = np.zeros((src.L, 4, D), dtype=np.uint64)
    for l, p in enumerate(src.primes):
        res[l] = np.array([[rng.randrange(p) for _ in range(D)]
                           for _ in range(4)], dtype=np.uint64)
        res[l, 0, :4] = [0, 1, p // 2, p - 1]
    poly = src.from_u64(res)
    want = np.asarray(RefCrt(src, dst, shift)(poly))
    port = CrtShiftEmbed(PortRing(D, src_p, "cpu"), PortRing(D, dst_p, "cpu"),
                         shift)
    got = port(PortRing.from_planes(poly))
    np.testing.assert_array_equal(PortRing.to_planes(got).numpy(), want)


def test_crt_same_ring_matches_jax():
    D = 32
    primes = ntt_friendly_primes(22, 2 * D, 2)
    ring = RnsRing(D, primes)
    rng = np.random.default_rng(3)
    poly = _rand(ring, rng, 5)
    want = np.asarray(RefCrt(ring, ring, 29)(poly))
    pr = PortRing(D, primes, "cpu")
    got = CrtShiftEmbed(pr, pr, 29)(PortRing.from_planes(poly))
    np.testing.assert_array_equal(PortRing.to_planes(got).numpy(), want)
    assert isinstance(got, torch.Tensor)
