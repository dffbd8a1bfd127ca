"""The port's BGV/BFV scheme (ringo_tpu_torch/schemes/bgv.py) against
``ringo_tpu.schemes.bgv`` on the CPU: with the same seed, the same primes,
secret key, ciphertext (c0, c1), error, Delta*m through ``set_bigints``
and decryption at log_n = 8 and 10;
the port's residues cross over through ``RnsRing.to_planes``.  Exact."""

import numpy as np
import pytest
import torch

from ringo_tpu.schemes import bgv as ref_bgv
from ringo_tpu_torch.rings.rns import RnsRing
from ringo_tpu_torch.schemes import BGV, BGVParams

from torch_buckler_cases import one_torch_thread  # noqa: F401

T = (1 << 16) + 1
Q_BITS = [60, 60, 60, 60]


def _pair(log_n: int, seed: bytes):
    rp = ref_bgv.BGVParams(log_n, Q_BITS, T)
    pp = BGVParams(log_n, Q_BITS, T, device="cpu")
    return (ref_bgv.BGV(rp, seed=seed), BGV(pp, seed=seed))


def _message(n: int, seed: int):
    m = np.random.default_rng(seed).integers(0, T, n)
    m[:4] = [0, 1, T - 1, T // 2]
    return m


@pytest.mark.parametrize("log_n", [8, 10])
def test_encryption_matches_reference(log_n):
    ref, port = _pair(log_n, b"bgv-%d" % log_n)
    assert port.params.primes == ref.params.primes
    assert port.params.q == ref.params.q and port.params.delta == ref.params.delta
    assert all(p < 1 << 31 for p in port.params.primes)
    rsk, psk = ref.gen_secret_key(), port.gen_secret_key()
    np.testing.assert_array_equal(psk.coeffs.numpy(), rsk.coeffs)
    m = _message(1 << log_n, log_n)
    rc0, rc1, re = ref.encrypt(rsk, m)
    pc0, pc1, pe = port.encrypt(psk, m)
    np.testing.assert_array_equal(pe.numpy(), re)
    for rc, pc in ((rc0, pc0), (rc1, pc1)):
        assert pc.dtype == torch.int32 and pc.shape == (8, 1 << log_n)
        np.testing.assert_array_equal(RnsRing.to_planes(pc).numpy(),
                                      np.asarray(rc).astype(np.int64))
    dm = [port.params.delta * int(v) % port.params.q for v in m]
    np.testing.assert_array_equal(
        RnsRing.to_planes(port.rec.set_bigints(dm)).numpy(),
        ref.rec.set_bigints(dm).astype(np.int64))
    got = port.decrypt(psk, pc0, pc1)
    np.testing.assert_array_equal(got.numpy(), ref.decrypt(rsk, rc0, rc1))
    np.testing.assert_array_equal(got.numpy(), m)


def test_ciphertexts_cross_over_between_the_packages():
    """Each package decrypts the other's ciphertext (the planes crossed
    through ``from_planes`` / ``to_planes``); a wrong key does not."""
    ref, port = _pair(8, b"cross")
    rsk, psk = ref.gen_secret_key(), port.gen_secret_key()
    m = _message(1 << 8, 3)
    rc0, rc1, _ = ref.encrypt(rsk, m)
    pc0, pc1, _ = port.encrypt(psk, m)
    from_ref = [RnsRing.from_planes(c) for c in (rc0, rc1)]
    np.testing.assert_array_equal(port.decrypt(psk, *from_ref).numpy(), m)
    to_ref = [RnsRing.to_planes(c).numpy().astype(np.uint32) for c in (pc0, pc1)]
    np.testing.assert_array_equal(ref.decrypt(rsk, *to_ref), m)
    other = BGV(port.params, seed=b"another key").gen_secret_key()
    assert not np.array_equal(port.decrypt(other, pc0, pc1).numpy(), m)


def test_the_same_seed_gives_the_same_ciphertext_and_another_does_not():
    a, b, c = (BGV(BGVParams(8, Q_BITS, T, device="cpu"), seed=s)
               for s in (b"s", b"s", b"t"))
    m = _message(1 << 8, 5)
    ea = a.encrypt(a.gen_secret_key(), m)
    eb = b.encrypt(b.gen_secret_key(), m)
    ec = c.encrypt(c.gen_secret_key(), m)
    assert all(torch.equal(x, y) for x, y in zip(ea, eb))
    assert not torch.equal(ea[1], ec[1])
