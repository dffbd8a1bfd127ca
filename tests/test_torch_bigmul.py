"""The port's big-field arithmetic (ops/bigmul.py, ops/horner.py) against
the JAX package's on its numpy path and against Python big ints: Barrett
products, the reduction of lazy digit columns, the power ladder and the
polynomial evaluation.  Exact equality."""

import random

import numpy as np
import pytest
import torch

from ringo_tpu.fields import ZP110, ZP255, ZP880, limb as ref_limb
from ringo_tpu.ops.bigmul import BigMul as RefBigMul, conv_columns as ref_conv
from ringo_tpu.ops.horner import HornerPlan as RefHorner
from ringo_tpu_torch.fields import limb, spec as port_spec
from ringo_tpu_torch.ops.bigmul import BigMul, conv_columns, ripple
from ringo_tpu_torch.ops.horner import HornerPlan, tree_sum

FIELDS = {"zp110": ZP110, "zp255": ZP255, "zp880": ZP880}


def _port(spec):
    return port_spec.FieldSpec(p=spec.p, b=spec.b, k=spec.k)


def _operands(spec, n, seed):
    """n random field elements followed by the corner values 0, 1, p-1."""
    rng = random.Random(seed)
    return [rng.randrange(spec.p) for _ in range(n)] + [0, 1, spec.p - 1]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize("name", FIELDS)
def test_mul_mod_matches_jax_and_ints(name):
    spec = FIELDS[name]
    xs = _operands(spec, 29, 1)
    ys = list(reversed(_operands(spec, 29, 2)))
    xd, yd = ref_limb.ints_to_digits(xs, spec.w), ref_limb.ints_to_digits(ys, spec.w)
    want = RefBigMul(spec).mul_mod(xd, yd)
    got = BigMul(_port(spec)).mul_mod(_t(xd), _t(yd))
    np.testing.assert_array_equal(got.numpy(), want)
    assert limb.digits_to_ints(got) == [x * y % spec.p for x, y in zip(xs, ys)]


def test_mul_mod_broadcasts_a_scalar_operand():
    spec = ZP255
    xs = _operands(spec, 5, 3)
    got = BigMul(_port(spec)).mul_mod(
        limb.ints_to_digits(xs, spec.w).reshape(spec.w, 2, 4),
        limb.ints_to_digits([spec.p - 2], spec.w)[:, :, None])
    assert limb.digits_to_ints(got) == [x * (spec.p - 2) % spec.p for x in xs]


@pytest.mark.parametrize("name", FIELDS)
def test_conv_and_ripple_match_jax(name):
    spec = FIELDS[name]
    xd = ref_limb.ints_to_digits(_operands(spec, 6, 4), spec.w)
    yd = ref_limb.ints_to_digits(_operands(spec, 6, 5), spec.w)
    want = ref_conv(xd, yd, np)
    got = conv_columns(_t(xd), _t(yd))
    np.testing.assert_array_equal(got.numpy(), want)
    vals = limb.digits_to_ints(ripple(got, 2 * spec.w))
    xs, ys = ref_limb.digits_to_ints(xd), ref_limb.digits_to_ints(yd)
    assert vals == [x * y for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name,pairs", [("zp110", 3), ("zp255", 3), ("zp255", 1)])
def test_reduce_cols_of_accumulated_products(name, pairs):
    """Lazy columns of a sum of products (above the Barrett range B^(2w):
    the fold branch)."""
    spec = FIELDS[name]
    big_ref, big = RefBigMul(spec), BigMul(_port(spec))
    cols, total = None, [0] * 9
    for s in range(pairs):
        xs, ys = _operands(spec, 6, 10 + s), _operands(spec, 6, 20 + s)
        xs[-1] = ys[-1] = spec.p - 1
        c = ref_conv(ref_limb.ints_to_digits(xs, spec.w),
                     ref_limb.ints_to_digits(ys, spec.w), np)
        cols = c if cols is None else cols + c
        total = [t + x * y for t, x, y in zip(total, xs, ys)]
    want = big_ref.reduce_cols(cols)
    got = big.reduce_cols(_t(cols))
    np.testing.assert_array_equal(got.numpy(), want)
    assert limb.digits_to_ints(got) == [t % spec.p for t in total]


@pytest.mark.parametrize("name,width", [("zp110", 8), ("zp110", 6), ("zp255", 6)])
def test_reduce_cols_of_a_magnitude(name, width):
    """Normalised digits of a magnitude: wider than p for ZP110 at 8
    digits (p has 7), narrower otherwise; the no-fold branch."""
    spec = FIELDS[name]
    rng = np.random.default_rng(width)
    mag = rng.integers(0, 1 << 16, (width, 3, 5), dtype=np.uint32)
    mag[:, 0, 0] = 0xFFFF
    mag[:, 0, 1] = 0
    want = RefBigMul(spec).reduce_cols(mag)
    got = BigMul(_port(spec)).reduce_cols(_t(mag))
    np.testing.assert_array_equal(got.numpy(), want)
    ints = limb.digits_to_ints(_t(mag))
    assert limb.digits_to_ints(got) == [v % spec.p for v in ints]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 100])
def test_powers_match_jax_and_ints(n):
    spec = ZP255
    x = random.Random(n).randrange(spec.p)
    got = HornerPlan(_port(spec)).powers(x, n, "cpu")
    assert got.shape == (spec.w, n)
    assert limb.digits_to_ints(got) == [pow(x, i, spec.p) for i in range(n)]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(RefHorner(spec).powers(x, n)))


@pytest.mark.parametrize("name,sizes", [("zp255", [100, 37, 1]),
                                        ("zp110", [64]), ("zp255", [2])])
def test_evaluate_many_matches_jax_and_ints(name, sizes):
    spec = FIELDS[name]
    rng = random.Random(len(sizes))
    x = rng.randrange(spec.p)
    coeffs = [_operands(spec, n, rng.randrange(99))[:n] for n in sizes]
    vs = [ref_limb.ints_to_digits(c, spec.w) for c in coeffs]
    plan = HornerPlan(_port(spec))
    got = plan.evaluate_many([vs[0]] + [_t(v) for v in vs[1:]], x, "cpu")
    assert got == RefHorner(spec).evaluate_many(vs, x)
    want = []
    for c in coeffs:
        acc = 0
        for ci in reversed(c):
            acc = (acc * x + ci) % spec.p
        want.append(acc)
    assert got == want
    n = max(sizes)
    np.testing.assert_array_equal(plan.steps_for(x, n).numpy(),
                                  RefHorner(spec).steps_for(x, n))
    np.testing.assert_array_equal(
        plan.stack_inputs(vs, n, "cpu").numpy(),
        RefHorner(spec).stack_inputs(vs, n).astype(np.int64))


@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_tree_sum(m):
    spec = ZP255
    vals = _operands(spec, 2 * m, m)[:2 * m]
    vals[0] = spec.p - 1
    x = limb.ints_to_digits(vals, spec.w).reshape(spec.w, 2, m)
    got = limb.digits_to_ints(tree_sum(BigMul(_port(spec)), x))
    assert got == [sum(vals[:m]) % spec.p, sum(vals[m:]) % spec.p]
