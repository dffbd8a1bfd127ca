"""The ring and CRT operations that the port's evaluate and verify add,
against the JAX package on its numpy path and against Python big ints:
``sub``, ``mul_scalar_mont``, ``from_u64``, untrusted planes, the host
reconstructor, ``balanced_mag``, the exact norm columns, and the stages of
evaluate (partial, response, and the batch combine across a forced chunk
split, as tests/test_combine_seeds.py holds the JAX one).  Exact equality."""

import random

import numpy as np
import pytest
import torch

from ringo_tpu import jindo
from ringo_tpu.fields import ZP255
from ringo_tpu.rings.rns import RnsReconstructor as RefReconstructor, \
    RnsRing as RefRing, ntt_friendly_primes
from ringo_tpu.rings.rns_device import CrtShiftEmbed as RefCrt, \
    norm_cols_to_int as ref_cols_to_int
import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch.fields import ZP255 as PORT_ZP255
from ringo_tpu_torch.rings.rns import RnsReconstructor, RnsRing
from ringo_tpu_torch.rings.rns_device import CrtShiftEmbed, norm_cols_to_int

D = 32
PRIMES = {"three26": ntt_friendly_primes(26, 2 * D, 3),
          "two30": ntt_friendly_primes(30, 2 * D, 2),
          "four22": ntt_friendly_primes(22, 2 * D, 4)}


def _rand_res(primes, rng, *batch):
    """uint64 residues [L, *batch, D] with 0, 1, q/2 and q-1 planted."""
    res = np.stack([rng.integers(0, q, (*batch, D), dtype=np.uint64)
                    for q in primes])
    for l, q in enumerate(primes):
        res[l].reshape(-1)[:4] = [0, 1, q // 2, q - 1]
    return res


def _rand_res_d(primes, rng, *shape):
    """uint64 residues [L, *shape]."""
    return np.stack([rng.integers(0, q, shape, dtype=np.uint64) for q in primes])


def _pair(name, seed, *batch):
    primes = PRIMES[name]
    ref, port = RefRing(D, primes), RnsRing(D, primes, "cpu")
    res = _rand_res(primes, np.random.default_rng(seed), *batch)
    return ref, port, ref.from_u64(res), torch.from_numpy(res.astype(np.int32))


def _planes(t):
    return RnsRing.to_planes(t).numpy()


@pytest.mark.parametrize("name", PRIMES)
def test_sub_and_scalar_mont_match(name):
    ref, port, a_ref, a = _pair(name, 1, 3)
    _, _, b_ref, b = _pair(name, 2, 3)
    np.testing.assert_array_equal(_planes(port.sub(a, b)), ref.sub(a_ref, b_ref))
    np.testing.assert_array_equal(_planes(port.sub(a, a)), ref.sub(a_ref, a_ref))
    for value in (1, 1 << 7, 1 << 41, (1 << 61) - 1):
        s_ref, s = ref.scalar_rns_mont(value), port.scalar_rns_mont(value)
        np.testing.assert_array_equal(
            s.numpy(), s_ref[0].astype(np.int64) | (s_ref[1].astype(np.int64) << 16))
        np.testing.assert_array_equal(
            _planes(port.mul_scalar_mont(a, s)), ref.mul_scalar_mont(a_ref, s_ref))


def test_from_u64_and_bytes_match():
    ref, port, a_ref, a = _pair("two30", 3, 2)
    u = ref.to_u64(a_ref) | (np.uint64(7) << np.uint64(40))   # high bits dropped
    np.testing.assert_array_equal(RnsRing.from_u64(u).numpy(), ref.from_u64(u))
    np.testing.assert_array_equal(
        RnsRing.from_u64(torch.from_numpy(u.view(np.int64))).numpy(), ref.from_u64(u))
    assert port.to_bytes(RnsRing.to_planes(a)) == ref.to_bytes(a_ref)
    assert port.to_bytes(a_ref) == ref.to_bytes(a_ref)        # numpy planes too


def test_untrusted_planes():
    _, port, a_ref, a = _pair("three26", 4, 2)
    planes = a_ref.astype(np.int64)
    res, ok = port.from_untrusted_planes(planes)
    assert bool(ok) and torch.equal(res, a)
    q0 = port.primes[0]
    for lane in (q0, q0 + 5, (1 << 32) - 1, 1 << 31):
        bad = planes.copy()
        bad[0, 0, 0, 0], bad[1, 0, 0, 0] = lane & 0xFFFF, lane >> 16
        res, ok = port.from_untrusted_planes(bad)
        assert not bool(ok)
        assert int(res[0, 0, 0]) == lane % q0 and res.dtype == torch.int32
    for digit, value in ((0, 1 << 16), (1, 1 << 16), (0, -1)):
        bad = planes.copy()
        bad[digit, 1, 1, 1] = value
        res, ok = port.from_untrusted_planes(torch.from_numpy(bad))
        assert not bool(ok)
        assert 0 <= int(res[1, 1, 1]) < port.primes[1]


@pytest.mark.parametrize("name", PRIMES)
def test_reconstructor_matches(name):
    ref, port, a_ref, a = _pair(name, 5)
    want = RefReconstructor(ref).reconstruct(a_ref)
    got = RnsReconstructor(port).reconstruct(a)
    assert got == [int(v) for v in want]
    Q = port.modulus
    assert all(-((Q + 1) >> 1) <= v < Q >> 1 for v in got)      # balanced
    assert [v % port.primes[0] for v in got] == a[0].tolist()


def _mag_ints(mag, neg):
    vals = [sum(int(m.reshape(-1)[i]) << (16 * k) for k, m in enumerate(mag))
            for i in range(mag[0].numel())]
    return [-v if s else v for v, s in zip(vals, neg.reshape(-1).tolist())]


@pytest.mark.parametrize("name,shift", [("three26", 0), ("two30", 0),
                                        ("four22", 0), ("three26", 13)])
def test_balanced_mag_matches(name, shift):
    ref, port, a_ref, a = _pair(name, 6, 4)
    want_mag, want_neg = RefCrt(ref, ref, shift).balanced_mag(a_ref)
    crt = CrtShiftEmbed(port, port, shift)
    mag, neg = crt.balanced_mag(a)
    assert len(mag) == crt.W
    np.testing.assert_array_equal(torch.stack(mag).numpy(), want_mag)
    np.testing.assert_array_equal(neg.numpy(), want_neg)
    if shift == 0:
        assert _mag_ints(mag, neg) == RnsReconstructor(port).reconstruct(
            a.reshape(port.L, -1))
    else:
        full = RnsReconstructor(port).reconstruct(a.reshape(port.L, -1))
        assert _mag_ints(mag, neg) == [v >> shift for v in full]


@pytest.mark.parametrize("name", PRIMES)
def test_norm_sq_cols_match_and_are_the_exact_norm(name):
    ref, port, a_ref, a = _pair(name, 7, 5)
    _, _, b_ref, b = _pair(name, 8, 2, 3)
    want = RefCrt(ref, ref, 0).norm_sq_cols([a_ref, b_ref])
    crt = CrtShiftEmbed(port, port, 0)
    got = crt.norm_sq_cols([a, b])
    assert got.dtype == torch.int64 and got.shape == (2 * crt.W - 1,)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    rec = RnsReconstructor(port)
    exact = sum(v * v for t in (a, b)
                for v in rec.reconstruct(t.reshape(port.L, -1)))
    assert norm_cols_to_int(got.tolist()) == exact == ref_cols_to_int(want)


def test_norm_sq_cols_lift_between_rings():
    """The verifier's outer norm: CrtShiftEmbed(ring_out, ring, 0)."""
    _, src, _, a = _pair("two30", 9, 6)
    dst = RnsRing(D, PRIMES["three26"], "cpu")
    got = CrtShiftEmbed(src, dst, 0).norm_sq_cols([a])
    exact = sum(v * v for v in RnsReconstructor(src).reconstruct(
        a.reshape(src.L, -1)))
    assert norm_cols_to_int(got.tolist()) == exact


# ------------------------------------------------------- stages of evaluate

@pytest.fixture(scope="module")
def stage_setup():
    t = 3
    ref_p = jindo.new_parameters(ZP255, 1 << 8, t)
    p = tj.new_parameters(PORT_ZP255, 1 << 8, t)
    prv = tj.Prover(p, b"Jindo!", seed=b"combine-test", device="cpu")
    return ref_p, p, prv


def _signed_seeds(p, rng, t):
    B, R, d = p.cols + 1, p.rows, p.degree
    K = p.mlwe_rank + p.in_msis_rank
    return (rng.integers(-1000, 1000, (t, B, R, d)).astype(np.int64),
            rng.integers(-6, 7, (t, B, K, d)).astype(np.int64))


def _ref_encode(ring, signed):
    return ring.ntt(ring.mform(ring.embed_int64(signed)))


@pytest.mark.parametrize("chunk", [2, 1, None])
def test_chunked_combine_matches_per_opening_oracle(stage_setup, chunk):
    ref_p, p, prv = stage_setup
    t = p.batch
    ring, ring_out = ref_p.ring_q, ref_p.ring_q_out
    rng = np.random.default_rng(42)
    e_all, nz_all = _signed_seeds(p, rng, t)
    ics = _rand_res_d(ring_out.primes, rng, t, p.in_com_dcmp_len, p.degree)
    bos = _rand_res_d(ring_out.primes, rng, t, p.degree)
    bqs = _rand_res_d(ring.primes, rng, t, p.degree)

    tt = lambda a: torch.from_numpy(np.moveaxis(a, 0, 1).astype(np.int32))
    got = prv._combine_seeds(torch.from_numpy(e_all), torch.from_numpy(nz_all),
                             tt(ics), tt(bos), tt(bqs), chunk=chunk)

    # per-opening multiply-accumulate with the reference's ring operations
    acc = None
    for i in range(t):
        terms = (
            ring_out.mul_mont(ring_out.from_u64(ics[:, i]),
                              ring_out.from_u64(bos[:, i])[:, :, None, :]),
            ring.mul_mont(_ref_encode(ring, e_all[i]),
                          ring.from_u64(bqs[:, i])[:, :, None, None, :]),
            ring.mul_mont(_ref_encode(ring, nz_all[i]),
                          ring.from_u64(bqs[:, i])[:, :, None, None, :]))
        acc = terms if acc is None else (
            ring_out.add(acc[0], terms[0]), ring.add(acc[1], terms[1]),
            ring.add(acc[2], terms[2]))
    for g, w in zip(got, acc):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_planes(g), w)


def test_partial_and_response_match_the_reference_loops(stage_setup):
    """Reference stage_partial / stage_response, numpy branches
    (ringo_tpu/jindo/prover.py): loops of mul_mont accumulations."""
    ref_p, p, prv = stage_setup
    ring = ref_p.ring_q
    rng = np.random.default_rng(43)
    B, R, d = p.cols + 1, p.rows, p.degree
    K = p.mlwe_rank + p.in_msis_rank
    enc = _rand_res_d(ring.primes, rng, B, R, d)
    mlwe = _rand_res_d(ring.primes, rng, B, K, d)
    left = _rand_res_d(ring.primes, rng, R, d)
    chals = _rand_res_d(ring.primes, rng, p.cols, d)
    tt = lambda a: torch.from_numpy(a.astype(np.int32))
    enc_r, mlwe_r = ring.from_u64(enc), ring.from_u64(mlwe)
    left_r, chals_r = ring.from_u64(left), ring.from_u64(chals)

    want = None
    for j in range(R):
        term = ring.mul_mont(left_r[:, :, j, :][:, :, None, :], enc_r[:, :, :, j, :])
        want = term if want is None else ring.add(want, term)
    np.testing.assert_array_equal(_planes(prv._partial(tt(left), tt(enc))), want)

    resp_e, resp_m = enc_r[:, :, p.cols], mlwe_r[:, :, p.cols]
    for j in range(p.cols):
        cj = chals_r[:, :, j, :][:, :, None, :]
        resp_e = ring.add(resp_e, ring.mul_mont(cj, enc_r[:, :, j]))
        resp_m = ring.add(resp_m, ring.mul_mont(cj, mlwe_r[:, :, j]))
    got_e, got_m = prv._response(tt(chals), tt(enc), tt(mlwe))
    np.testing.assert_array_equal(_planes(got_e), resp_e)
    np.testing.assert_array_equal(_planes(got_m), resp_m)


def test_batch_round_trip_is_accepted_by_the_reference_verifier(stage_setup):
    """commit_many of 3 -> evaluate -> verify on the port (N = 2^8), the
    proof and commitments carried as bytes to the JAX package's verifier
    under its numpy backend; a tampered one is rejected by both."""
    ref_p, p, prv = stage_setup
    rnd = random.Random(7)
    vs = [tj.sample_field_digits(p.spec, n, prv.uniform) for n in (256, 256, 100)]
    out = prv.commit_many(vs)
    coms, opens = [c for c, _ in out], [o for _, o in out]
    x = rnd.randrange(ZP255.p)
    ys, pf = prv.evaluate(x, vs, coms, opens)
    vrf = tj.Verifier(p, b"Jindo!", device="cpu", ck=prv.ck)
    assert vrf.verify(x, coms, ys, pf) is True
    ref_vrf = jindo.Verifier(ref_p, b"Jindo!")
    ref_coms = [jindo.Commitment.from_bytes(ref_p, c.to_bytes()) for c in coms]
    data = pf.to_bytes(p)
    assert ref_vrf.verify(x, ref_coms, ys, jindo.Proof.from_bytes(ref_p, data)) is True
    ys_bad = [ys[0], ys[1] ^ 1, ys[2]]
    assert vrf.verify(x, coms, ys_bad, pf) is False
    assert ref_vrf.verify(x, ref_coms, ys_bad,
                          jindo.Proof.from_bytes(ref_p, data)) is False
    swapped = [coms[1], coms[0], coms[2]]
    assert vrf.verify(x, swapped, ys, pf) is False
