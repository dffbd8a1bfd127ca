"""Big-field polynomial rings over Z_p, p = b^k + 1 (reference math/bigpoly).

A polynomial is plain digit planes ``[w, rank]`` (int64 lanes, on the
ring's device) and an is_ntt flag.  ``CyclicRing`` works over X^rank - 1
(Buckler's interpolation domain), ``CyclotomicRing`` over X^rank + 1 (the
witness ring of the proved relations).

The port has one representation, the JAX package's plain (device) one:
products through ops/bigmul's Barrett arithmetic, transforms through the
plan ``make_device_plan`` picks (ops/bigntt.py or ops/bigntt_matmul.py).
``ring.ops`` offers the vector operations (from_ints, to_ints, mul, const,
add, sub, neg) under the JAX package's names.  Its ``from_mont`` is not
here: with one representation there is nothing to strip.

Counterpart of ``ringo_tpu.rings.bigring`` with ``plain=True``; equal
results (tests/test_torch_bigring.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend
from ..fields import limb
from ..fields.spec import FieldSpec
from ..ops import ntt as nttmod
from ..ops.bigmul import BigMul
from ..ops.bigntt_matmul import make_device_plan
from ..ops.horner import HornerPlan


@dataclasses.dataclass
class FPoly:
    """Big-field polynomial: plain digit planes [w, rank]."""
    coeffs: torch.Tensor
    is_ntt: bool = False

    @property
    def rank(self) -> int:
        return self.coeffs.shape[-1]


class PlainOps:
    """Vector operations mod p on plain digit planes, on one device."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.w = spec.w
        self.device = device
        self.big = BigMul(spec)
        self.pd = limb.ints_to_digits([spec.p], spec.w).to(device)   # [w, 1]

    def from_ints(self, values) -> torch.Tensor:
        return limb.ints_to_digits([int(v) % self.spec.p for v in values],
                                   self.w).to(self.device)

    def to_ints(self, digits) -> list[int]:
        return limb.digits_to_ints(digits)

    def mul(self, a, b):
        return self.big.mul_mod(a, b)

    def const(self, v: int, shape) -> torch.Tensor:
        """The constant v as planes [w, *shape]."""
        d = limb.ints_to_digits([int(v) % self.spec.p], self.w).to(self.device)
        return d.reshape(self.w, *([1] * len(shape))).expand(
            self.w, *shape).contiguous()

    def q(self, ndim: int) -> torch.Tensor:
        """p's digits shaped [w, 1, ..] against a value of ``ndim`` dims."""
        return self.pd.reshape((self.w,) + (1,) * (ndim - 1))

    def add(self, a, b):
        return limb.add(a, b, self.q(a.dim()))

    def sub(self, a, b):
        return limb.sub(a, b, self.q(a.dim()))

    def neg(self, a):
        return limb.neg(a, self.q(a.dim()))


class BigRing:
    """Shared evaluator (reference bigpoly baseOperator, base_op.go:10-207)
    on ``device`` (default: the card; raises without CUDA)."""

    negacyclic = False

    def __init__(self, spec: FieldSpec, rank: int, device=None):
        self.spec = spec
        self.rank = rank
        self.device = backend.resolve_device(device)
        self.ops = PlainOps(spec, self.device)
        self.dev_plan = make_device_plan(spec, rank, self.negacyclic,
                                         device=self.device)
        self.horner = HornerPlan(spec)

    # -- construction --------------------------------------------------------

    def new_poly(self, is_ntt: bool = False) -> FPoly:
        return FPoly(torch.zeros((self.spec.w, self.rank), dtype=torch.int64,
                                 device=self.device), is_ntt)

    def from_ints(self, values, is_ntt: bool = False) -> FPoly:
        vals = list(values) + [0] * (self.rank - len(values))
        return FPoly(self.ops.from_ints(vals), is_ntt)

    def to_ints(self, p: FPoly) -> list[int]:
        return self.ops.to_ints(p.coeffs)

    # -- arithmetic -----------------------------------------------------------

    def add(self, a: FPoly, b: FPoly) -> FPoly:
        assert a.is_ntt == b.is_ntt
        return FPoly(self.ops.add(a.coeffs, b.coeffs), a.is_ntt)

    def sub(self, a: FPoly, b: FPoly) -> FPoly:
        assert a.is_ntt == b.is_ntt
        return FPoly(self.ops.sub(a.coeffs, b.coeffs), a.is_ntt)

    def neg(self, a: FPoly) -> FPoly:
        return FPoly(self.ops.neg(a.coeffs), a.is_ntt)

    def scalar_mul(self, a: FPoly, c: int) -> FPoly:
        return FPoly(self.ops.mul(a.coeffs, self.ops.const(c, (1,))), a.is_ntt)

    def mul(self, a: FPoly, b: FPoly) -> FPoly:
        if not (a.is_ntt and b.is_ntt):
            raise ValueError("mul requires NTT domain")
        return FPoly(self.ops.mul(a.coeffs, b.coeffs), True)

    def mul_planes(self, a, b):
        """Pointwise product of value planes."""
        return self.ops.mul(a, b)

    def shard(self, mesh, n1: int | None = None):
        """Swap the NTT plan for the coefficient-sharded four-step
        (parallel.ShardedBigNTT, an all-to-all over the mesh's ``sp``
        axis).  Only the transform pair changes (true DFT order both ways,
        mutually inverse), so every ntt -> pointwise product -> intt chain
        gives the coefficients of the unsharded plan bit for bit.
        Cyclic rings only.  Returns the sharded plan."""
        if self.negacyclic:
            raise ValueError("four-step sharding is cyclic-only")
        from ..parallel.bigntt import ShardedBigNTT

        self.dev_plan = ShardedBigNTT(self.spec, self.rank, mesh, n1=n1,
                                      device=self.device)
        return self.dev_plan

    def ntt(self, a: FPoly) -> FPoly:
        if a.is_ntt:
            raise ValueError("already NTT")
        return FPoly(self.dev_plan.fwd(a.coeffs), True)

    def intt(self, a: FPoly) -> FPoly:
        if not a.is_ntt:
            raise ValueError("not NTT")
        return FPoly(self.dev_plan.inv(a.coeffs), False)

    def evaluate(self, a: FPoly, x: int) -> int:
        """a(x) over Z_p on the ring's device (ops/horner.py;
        reference bigpoly/poly.go:60-70)."""
        return self.evaluate_many([a], x)[0]

    def evaluate_many(self, polys, x: int) -> list[int]:
        """Several polynomials at the same point, in one batch."""
        for a in polys:
            if a.is_ntt:
                raise ValueError("evaluate requires coefficient domain")
        return self.horner.evaluate_many([a.coeffs for a in polys], x,
                                          self.device)


class CyclicRing(BigRing):
    """Z_p[X]/(X^rank - 1) (reference CyclicEvaluator, bigpoly/cyclic.go)."""

    negacyclic = False

    def quo_rem_by_vanishing(self, p: FPoly, n: int) -> tuple[FPoly, FPoly]:
        """Divide by X^n - 1 through suffix sums of coefficient blocks
        (reference cyclic.go:18-37): quotient block j-1 is the sum of the
        blocks >= j, the remainder the sum of all blocks."""
        if p.is_ntt:
            raise ValueError("input in NTT domain")
        if self.rank % n:
            raise ValueError("n must divide rank")
        w, nb = self.spec.w, self.rank // n
        blocks = p.coeffs.reshape(w, nb, n)
        q2 = self.ops.q(2)
        suffix = blocks[:, nb - 1]
        quo = [None] * nb
        quo[nb - 1] = torch.zeros_like(suffix)
        for j in range(nb - 1, 0, -1):
            quo[j - 1] = suffix
            suffix = limb.add(blocks[:, j - 1], suffix, q2)
        rem = torch.cat([suffix, suffix.new_zeros((w, self.rank - n))], dim=1)
        return (FPoly(torch.stack(quo, dim=1).reshape(w, self.rank), False),
                FPoly(rem, False))


class CyclotomicRing(BigRing):
    """Z_p[X]/(X^rank + 1) (reference CyclotomicEvaluator,
    bigpoly/cyclotomic.go)."""

    negacyclic = True

    def aut(self, p: FPoly, idx: int) -> FPoly:
        """Galois automorphism X -> X^idx in either domain (reference
        AutTo, cyclotomic.go:29-82)."""
        if idx % 2 == 0:
            raise ValueError("idx must be odd")
        idx %= 2 * self.rank
        if p.is_ntt:
            perm = nttmod.aut_ntt_permutation(self.rank, idx)
            return FPoly(p.coeffs[:, torch.from_numpy(perm).to(self.device)],
                         True)
        dst, sign = nttmod.aut_coeff_maps(self.rank, idx)
        src = np.argsort(dst)
        moved = p.coeffs[:, torch.from_numpy(src).to(self.device)]
        flip = torch.from_numpy(sign[src] < 0).to(self.device)
        return FPoly(torch.where(flip, self.ops.neg(moved), moved), False)

    def mod_switch_ints(self, values: list[int], q_from: int) -> FPoly:
        """Round values mod q_from to their nearest representation mod p
        (reference ModSwitchTo, cyclotomic.go:99-124)."""
        p = self.spec.p
        q_half = q_from >> 1
        out = []
        for v in values:
            c = v * p
            c_rem = c % q_from
            if c_rem > q_half:
                c_rem -= q_from
            out.append(((c - c_rem) // q_from) % p)
        return self.from_ints(out)
