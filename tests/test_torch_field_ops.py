"""The port's ``FieldOps`` (Montgomery digit planes on torch) against
``ringo_tpu.fields.FieldOps`` on seeded values in ZP220, ZP128 and ZP880:
every method, as integers; the modulus search and its command line
against ``ringo_tpu.fields``.  Exact.

The exponentiations (inverse, legendre, sqrt, batch_invert) cost hundreds
to thousands of Montgomery products at the field's full exponent: they are
held against the reference on ZP128 and ZP220 (sqrt on ZP128) and against
Python ints on ZP880 (inverse) and ZP220 (sqrt), where the
reference's numpy planes would take minutes."""

import json
import random

import numpy as np
import pytest
import torch

from ringo_tpu import fields as ref_fields
from ringo_tpu.fields import modulus as ref_modulus
from ringo_tpu_torch import fields
from ringo_tpu_torch.fields import limb, modulus

from torch_buckler_cases import one_torch_thread  # noqa: F401

NAMES = ["ZP220", "ZP128", "ZP880"]


def _ops(name):
    spec, ref_spec = getattr(fields, name), getattr(ref_fields, name)
    return fields.FieldOps(spec, device="cpu"), ref_fields.FieldOps(ref_spec)


def _values(p: int, seed: int, n: int = 13) -> list[int]:
    rng = random.Random(seed)
    return [0, 1, 2, p - 1, (p - 1) // 2] + [rng.randrange(p)
                                              for _ in range(n - 5)]


def _same(port_planes, ref_planes):
    np.testing.assert_array_equal(port_planes.numpy(),
                                  np.asarray(ref_planes).astype(np.int64))


@pytest.mark.parametrize("name", NAMES)
def test_conversions_and_elementwise_ops_match_reference(name):
    ops, ref = _ops(name)
    p = ops.spec.p
    va, vb = _values(p, 1), _values(p, 2)[::-1]
    a, b = ops.from_ints(va), ops.from_ints(vb)
    ra, rb = ref.from_ints(va), ref.from_ints(vb)
    _same(a, ra)
    assert ops.to_ints(a) == ref.to_ints(ra) == va
    assert ops.to_int(ops.from_int(va[7])) == va[7]
    _same(ops.from_int(va[7]), ref.from_int(va[7]))
    for f in ("add", "sub", "mul"):
        _same(getattr(ops, f)(a, b), getattr(ref, f)(ra, rb))
    for f in ("neg", "to_mont", "from_mont", "double", "halve", "mul_by_3",
              "mul_by_5", "mul_by_13"):
        _same(getattr(ops, f)(a), getattr(ref, f)(ra))
    assert ops.to_ints(ops.halve(a)) == [v * pow(2, -1, p) % p for v in va]
    for f in ("is_zero",):
        np.testing.assert_array_equal(getattr(ops, f)(a).numpy(),
                                      getattr(ref, f)(ra))
    for f in ("eq", "cmp"):
        np.testing.assert_array_equal(getattr(ops, f)(a, b).numpy(),
                                      getattr(ref, f)(ra, rb))
    np.testing.assert_array_equal(ops.bit_len(a).numpy(), ref.bit_len(ra))
    assert ops.bit_len(a).tolist() == [v.bit_length() for v in va]
    cond = torch.tensor([i % 3 == 0 for i in range(len(va))])
    _same(ops.select(cond, a, b), ref.select(cond.numpy(), ra, rb))
    _same(ops.zeros((2, 3)), ref.zeros((2, 3)))
    _same(ops.const(p - 5, (2, 3)), ref.const(p - 5, (2, 3)))
    for e in (0, 1, 2, 65537, 12345678901):
        _same(ops.exp(a, e), ref.exp(ra, e))
    with pytest.raises(ValueError):
        ops.exp(a, -1)


@pytest.mark.parametrize("name", NAMES)
def test_vector_serialization_matches_reference(name):
    ops, ref = _ops(name)
    vals = _values(ops.spec.p, 3)
    data = ops.marshal_vector(ops.from_ints(vals))
    assert data == ref.marshal_vector(ref.from_ints(vals))
    _same(ops.unmarshal_vector(data), ref.unmarshal_vector(data))
    assert ops.to_ints(ops.unmarshal_vector(data)) == vals


@pytest.mark.parametrize("name", ["ZP128", "ZP220"])
def test_inverse_legendre_and_batch_invert_match_reference(name):
    ops, ref = _ops(name)
    vals = _values(ops.spec.p, 4)
    a, ra = ops.from_ints(vals), ref.from_ints(vals)
    inv = ops.inverse(a)
    _same(inv, ref.inverse(ra))
    _same(ops.legendre(a), ref.legendre(ra))
    _same(ops.batch_invert(a), ref.batch_invert(ra))
    _same(ops.batch_invert(a), inv)


def test_inverse_on_zp880():
    ops = fields.FieldOps(fields.ZP880, device="cpu")
    p = ops.spec.p
    vals = _values(p, 5, n=7)
    inv = ops.to_ints(ops.inverse(ops.from_ints(vals)))
    assert inv == [pow(v, p - 2, p) for v in vals]


def test_sqrt_matches_reference_on_zp128():
    ops, ref = _ops("ZP128")
    p = ops.spec.p
    nr = next(v for v in range(2, 50) if pow(v, (p - 1) // 2, p) == p - 1)
    vals = [v * v % p for v in _values(p, 6)] + [nr]
    root, ok = ops.sqrt(ops.from_ints(vals))
    rroot, rok = ref.sqrt(ref.from_ints(vals))
    _same(root, rroot)
    np.testing.assert_array_equal(ok.numpy(), rok)
    assert ok[:-1].all() and not ok[-1]


def test_sqrt_on_zp220():
    ops = fields.FieldOps(fields.ZP220, device="cpu")
    p = ops.spec.p
    squares = [v * v % p for v in _values(p, 7, n=6)]
    root, ok = ops.sqrt(ops.from_ints(squares))
    assert ok.all()
    assert [r * r % p for r in ops.to_ints(root)] == squares


def test_limb_helpers_match_reference():
    """cmp, bit_len, select and halve on raw digit planes, with ties,
    zeros and the top digit set."""
    spec = fields.ZP220
    rng = random.Random(9)
    va = [0, 1, spec.p - 1, 1 << 200] + [rng.randrange(spec.p) for _ in range(8)]
    vb = [0, 2, spec.p - 1, (1 << 200) - 1] + va[4:][::-1]
    a, b = limb.ints_to_digits(va, spec.w), limb.ints_to_digits(vb, spec.w)
    ra, rb = (ref_fields.limb.ints_to_digits(v, spec.w) for v in (va, vb))
    np.testing.assert_array_equal(limb.cmp(a, b).numpy(),
                                  ref_fields.limb.cmp(ra, rb))
    assert limb.bit_len(a).tolist() == [v.bit_length() for v in va]
    q = limb.ints_to_digits([spec.p], spec.w)
    assert limb.digits_to_ints(limb.halve(a, q)) == [
        v * pow(2, -1, spec.p) % spec.p for v in va]


def test_find_modulus_and_derive_base_exp_match_reference():
    for bits in (40, 64, 100):
        got = fields.find_modulus(bits, 2 * bits)
        want = ref_fields.find_modulus(bits, 2 * bits)
        assert (got.p, got.b, got.k) == (want.p, want.b, want.k)
    for name in ("ZP255", "ZP220", "ZP128", "ZP240", "ZP880"):
        spec = getattr(fields, name)
        assert fields.derive_base_exp(spec.p) == \
            ref_fields.derive_base_exp(spec.p) == (spec.b, spec.k)
    with pytest.raises(ValueError):
        fields.find_modulus(8, 9)


@pytest.mark.parametrize("argv", [["-b", "31432", "-k", "16"],
                                  ["-b", "31432", "-k", "16", "--python"],
                                  ["-n", "64"], ["-n", "64", "--python"],
                                  ["-b", "31432", "-k", "3"],
                                  ["-b", "31433", "-k", "16"]])
def test_modulus_cli_prints_the_reference_output(argv, capsys):
    rc = modulus.main(argv)
    got = capsys.readouterr()
    assert ref_modulus.main(argv) == rc
    want = capsys.readouterr()
    assert (got.out, got.err) == (want.out, want.err)
    if rc == 0 and "--python" not in argv:
        d = json.loads(got.out)
        spec = fields.FieldSpec(p=int(d["p"]), b=d["b"], k=d["k"])
        assert d["r2_mod_p"] == str(spec.r2_mod_p)
