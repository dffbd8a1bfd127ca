"""The port's stage NTT engine (ringo_tpu_torch/ops/ntt.py) with its two
plans against the JAX package on numpy planes (no JAX compile):

* the RNS plan: ``RnsRing.ntt`` / ``intt`` on int32 residues against
  ``ringo_tpu.rings.rns.RnsRing`` on the BGV ring's primes
  2^30 + 1 + i*2d at d = 2^8 and 2^10, with ``mform``, ``imform``,
  ``neg``, ``mul_mont_add``, ``mul_mont_sub``, ``set_bigints`` and the
  downstream prime search;
* the two engines against each other on a Jindo ring at d = 256:
  ``ntt(mform(x)) == ntt_mform(x)`` and the inverse pair;
* ``NTTPlan`` on 16-bit digit planes against ``ringo_tpu.ops.ntt`` on
  ZP220 and ZP240, both directions, negacyclic and cyclic.

Every comparison is exact."""

import random

import numpy as np
import pytest
import torch

from ringo_tpu.fields import spec as ref_spec
from ringo_tpu.ops import ntt as ref_ntt
from ringo_tpu.rings import rns as ref_rns
from ringo_tpu_torch import jindo
from ringo_tpu_torch.fields import ZP255, limb, spec as port_spec
from ringo_tpu_torch.ops import ntt as port_ntt
from ringo_tpu_torch.rings import rns

from torch_buckler_cases import one_torch_thread  # noqa: F401

BGV_L = 8


def _rings(d: int):
    primes = rns.ntt_friendly_primes(30, 2 * d, BGV_L)
    return ref_rns.RnsRing(d, primes), rns.RnsRing(d, primes, "cpu")


def _residues(primes, batch, d, seed):
    """uint64 residues [L, *batch, d] below each prime; the first lanes
    hold 0, 1 and q - 1."""
    rng = np.random.default_rng(seed)
    q = np.array(primes, dtype=np.uint64).reshape(-1, *([1] * (len(batch) + 1)))
    x = rng.integers(0, q, (len(primes), *batch, d), dtype=np.uint64)
    x.reshape(len(primes), -1)[:, :3] = np.stack(
        [np.zeros_like(q.ravel()), np.ones_like(q.ravel()), q.ravel() - 1], 1)
    return x


def _port(x):
    return torch.from_numpy(x.astype(np.int64)).to(torch.int32)


def _same(ref_ring, ref_planes, port_res):
    np.testing.assert_array_equal(
        ref_ring.to_u64(np.asarray(ref_planes)).astype(np.int64),
        port_res.to(torch.int64).numpy())


def test_bgv_primes_match_reference():
    for d in (1 << 8, 1 << 10, 1 << 13):
        assert rns.ntt_friendly_primes(30, 2 * d, BGV_L) == \
            ref_rns.ntt_friendly_primes(30, 2 * d, BGV_L)
        assert rns.ntt_friendly_primes(30, 2 * d, 3, upstream=False) == \
            ref_rns.ntt_friendly_primes(30, 2 * d, 3, upstream=False)
    primes = rns.ntt_friendly_primes(30, 2 << 13, BGV_L)
    assert all(p < 1 << 31 and p % (2 << 13) == 1 for p in primes)
    for search in (rns.ntt_friendly_primes, ref_rns.ntt_friendly_primes):
        with pytest.raises(ValueError, match="exhausted"):
            search(4, 16, 5, upstream=False)


@pytest.mark.parametrize("d", [1 << 8, 1 << 10])
def test_ntt_and_intt_match_reference(d):
    ref, port = _rings(d)
    x = _residues(port.primes, (3,), d, d)
    xr, xp = ref.from_u64(x), _port(x)
    yr, yp = ref.ntt(xr), port.ntt(xp)
    assert yp.dtype == torch.int32 and yp.shape == xp.shape
    _same(ref, yr, yp)
    _same(ref, ref.intt(yr), port.intt(yp))
    assert torch.equal(port.intt(yp), xp)
    # a polynomial of one dimension, as BGV transforms them
    _same(ref, ref.ntt(xr[:, :, 1]), port.ntt(xp[:, 1]))


@pytest.mark.parametrize("d", [1 << 8, 1 << 10])
def test_montgomery_forms_neg_and_fused_products_match_reference(d):
    ref, port = _rings(d)
    a, b, c = (_residues(port.primes, (2,), d, d + i) for i in range(3))
    ar, br, cr = ref.from_u64(a), ref.from_u64(b), ref.from_u64(c)
    ap, bp, cp = _port(a), _port(b), _port(c)
    for f in ("mform", "imform", "neg"):
        _same(ref, getattr(ref, f)(ar), getattr(port, f)(ap))
    _same(ref, ref.mul_mont_add(ar, br, cr), port.mul_mont_add(ap, bp, cp))
    _same(ref, ref.mul_mont_sub(cr, ar, br), port.mul_mont_sub(cp, ap, bp))
    assert torch.equal(port.imform(port.mform(ap)), ap)
    # the negacyclic product: intt(ntt(mform(a)) * ntt(b)), the BGV one
    prod = port.intt(port.mul_mont(port.mform(port.ntt(ap)), port.ntt(bp)))
    _same(ref, ref.intt(ref.mul_mont(ref.mform(ref.ntt(ar)), ref.ntt(br))),
          prod)


def test_set_bigints_matches_reference():
    ref, port = _rings(1 << 8)
    rng = random.Random(8)
    Q = port.modulus
    vals = [0, 1, Q - 1, Q // 2] + [rng.randrange(Q) for _ in range(60)]
    got = rns.RnsReconstructor(port).set_bigints(vals)
    assert got.dtype == torch.int32 and got.shape == (BGV_L, len(vals))
    _same(ref, ref_rns.RnsReconstructor(ref).set_bigints(vals), got)
    back = rns.RnsReconstructor(port).reconstruct(got)
    assert [v % Q for v in back] == vals


def test_stage_engine_equals_the_matmul_ntt_at_degree_256():
    """The Jindo commit's ring (d = 256): the stage engine and the matmul
    NTT (the plain version of the CUDA kernel) give the same values."""
    ring = jindo.new_parameters(ZP255, 1 << 10, 1).ring_q.on("cpu")
    x = _port(_residues(ring.primes, (5,), ring.d, 256))
    y = ring.ntt_mform(x)
    assert torch.equal(ring.ntt(ring.mform(x)), y)
    assert torch.equal(ring.intt(ring.imform(y)), ring.intt_imform(y))
    assert torch.equal(ring.intt_imform(y), x)


@pytest.mark.parametrize("negacyclic", [True, False])
@pytest.mark.parametrize("name,n", [("ZP220", 64), ("ZP240", 128)])
def test_nttplan_matches_reference(name, n, negacyclic):
    rs, ps = getattr(ref_spec, name), getattr(port_spec, name)
    ref_plan = ref_ntt.NTTPlan(rs, n, negacyclic)
    plan = port_ntt.NTTPlan(ps, n, negacyclic, device="cpu")
    for t in ("tw", "twinv"):
        np.testing.assert_array_equal(getattr(plan, t).numpy(),
                                      np.asarray(getattr(ref_plan, t)))
    rng = random.Random(n)
    vals = [0, 1, ps.p - 1] + [rng.randrange(ps.p) for _ in range(3 * n - 3)]
    x = limb.ints_to_digits(vals, ps.w).reshape(ps.w, 3, n)
    xr = x.numpy().astype(np.uint32)
    y = port_ntt.ntt_fwd(plan, x)
    np.testing.assert_array_equal(y.numpy(), ref_ntt.ntt_fwd(ref_plan, xr))
    np.testing.assert_array_equal(port_ntt.ntt_inv(plan, y).numpy(),
                                  ref_ntt.ntt_inv(ref_plan, np.asarray(
                                      ref_ntt.ntt_fwd(ref_plan, xr))))
    assert torch.equal(port_ntt.ntt_inv(plan, y), x)
    with pytest.raises(ValueError):
        port_ntt.NTTPlan(ps, 3 * n, negacyclic, device="cpu")
