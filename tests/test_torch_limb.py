"""The port's digit-plane engine (ringo_tpu_torch.fields.limb, int64
lanes) against the JAX package's numpy engine, on all seven reference
fields.  Every quantity is an integer: exact equality."""

import numpy as np
import pytest
import torch

from ringo_tpu.fields import REFERENCE_FIELDS, limb as ref
from ringo_tpu_torch.fields import REFERENCE_FIELDS as PORT_FIELDS
from ringo_tpu_torch.fields import limb

N = 257


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _operands(spec, seed):
    rng = np.random.default_rng(seed)
    p = spec.p
    vals_a = [int.from_bytes(rng.bytes(2 * spec.w), "little") % p
              for _ in range(N)]
    vals_b = [int.from_bytes(rng.bytes(2 * spec.w), "little") % p
              for _ in range(N)]
    # borrow / carry edges: 0, 1, p - 1, equal operands, a = b +/- 1
    edges = [(0, 0), (0, 1), (1, 0), (p - 1, p - 1), (p - 1, 0), (0, p - 1),
             (p - 1, 1), (5, 5), (1 << 16, (1 << 16) - 1),
             ((1 << 16) - 1, 1 << 16)]
    for i, (x, y) in enumerate(edges):
        vals_a[i], vals_b[i] = x % p, y % p
    return (ref.ints_to_digits(vals_a, spec.w),
            ref.ints_to_digits(vals_b, spec.w))


@pytest.mark.parametrize("name", sorted(REFERENCE_FIELDS))
def test_limb_ops_match_reference(name):
    spec = REFERENCE_FIELDS[name]
    assert PORT_FIELDS[name].p == spec.p and PORT_FIELDS[name].w == spec.w
    a, b = _operands(spec, sum(name.encode()))
    q = spec.p_digits.reshape(spec.w, 1)
    ta, tb = _t(a), _t(b)
    eq = np.testing.assert_array_equal
    eq(limb.add(ta, tb, q).numpy(), ref.add(a, b, q))
    eq(limb.sub(ta, tb, q).numpy(), ref.sub(a, b, q))
    eq(limb.neg(ta, q).numpy(), ref.neg(a, q))
    eq(limb.mont_mul(ta, tb, q, spec.qinv16).numpy(),
       ref.mont_mul(a, b, q, spec.qinv16))
    eq(limb.geq(ta, tb).numpy(), ref.geq(a, b))
    eq(limb.eq(ta, tb).numpy(), ref.eq(a, b))
    qd, r = limb.divmod_small(ta, spec.b)
    rq, rr = ref.divmod_small(a, spec.b)
    eq(qd.numpy(), rq)
    eq(r.numpy(), rr)
    assert limb.digits_to_ints(ta) == ref.digits_to_ints(a)
    eq(limb.ints_to_digits(ref.digits_to_ints(a), spec.w).numpy(), a)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_nonzero_idx_matches_reference(density):
    rng = np.random.default_rng(int(density * 100))
    mask = rng.random(4099) < density
    for size in (1, 64, 5000):
        np.testing.assert_array_equal(
            limb.nonzero_idx(torch.from_numpy(mask), size).numpy(),
            ref.nonzero_idx(np, mask, size))


def test_put_drop_drops_sentinels():
    dst = torch.zeros(10, dtype=torch.int64)
    idx = torch.tensor([3, 7, 10, 10])
    out = limb.put_drop(dst, idx, torch.tensor([1, 2, 3, 4]))
    np.testing.assert_array_equal(out.numpy(),
                                  [0, 0, 0, 1, 0, 0, 0, 2, 0, 0])
