"""Buckler prover (reference buckler/prover.go): the commit-then-challenge
PIOP, in the JAX package's device formulation as eager PyTorch.

Round 1 encodes the first-round witnesses in one batch (interpolation
INTT, X^rank blind, embedding NTT) and commits them with one Jindo
``commit_many``; the projection challenge fills the J-L matrix, and round
2 does the same for the projection witnesses and the two sum-check masks.
Round 3 evaluates every constraint in the NTT domain and divides by the
vanishing polynomial (arithmetic quotient; linear- and sum-check quotient,
remLo, remHi), after drawing all four of its challenges, as the JAX
package's fused round does (``_get_round3``, ``_round3_fused``): no
commitment of the round is bound before them, so the transcript is the
reference's.  Then one Jindo ``evaluate`` of every committed polynomial.

Witness decompositions and the two-norm sum run on the host in numpy
(object-dtype Python ints where int64 cannot hold a lane); everything
else stays on the ring's device.  The spans (utils/profiling.py) carry the
JAX package's span names (ringo_tpu_torch/profile_commit.py reads them).
Proof bytes equal the JAX package's (tests/test_torch_buckler.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..csprng import UniformSampler, field_sample
from ..fields import limb
from ..jindo.prover import sample_field_digits
from ..rings.bigring import FPoly
from ..utils.transcript import Shake128Stream, Transcript
from ..utils import profiling
from .entities import Proof
from .utils import (balanced_int64, decompose_base, decompose_big,
                    decompose_big_vec, ternary_planes)
from .witness import get_path

CHALLENGE_NAMES = [
    "projConst", "arithBatchConst", "linCheckBatchConst",
    "linCheckConst", "sumCheckBatchConst", "evalPoint",
]


def to_planes(value, ops, rank: int) -> torch.Tensor:
    """A witness assignment as plain digit planes [w, rank] on the ops'
    device.  Takes an FPoly or a tensor of planes, the JAX package's
    ``np.uint32`` planes, or ``rank`` ints."""
    if isinstance(value, FPoly):
        value = value.coeffs
    if isinstance(value, np.ndarray) and value.dtype == np.uint32:
        value = torch.from_numpy(value.astype(np.int64))
    if isinstance(value, torch.Tensor):
        if tuple(value.shape) != (ops.w, rank):
            raise ValueError("witness rank mismatch")
        return value.to(device=ops.device, dtype=torch.int64)
    vals = list(value)
    if len(vals) != rank:
        raise ValueError("witness rank mismatch")
    return ops.from_ints([int(v) for v in vals])


def _host(planes: torch.Tensor) -> np.ndarray:
    return planes.cpu().numpy()


class Prover:
    def __init__(self, params, poly_ring, ecd, ctx, jindo_prover,
                 pw_paths, w_paths, seed: bytes | None = None):
        self.params = params
        self.spec = params.spec
        self.poly_ring = poly_ring          # CyclicRing over the embed rank
        self.ecd = ecd                      # interpolation encoder
        self.ctx = ctx
        self.jindo = jindo_prover
        self.pw_paths = pw_paths
        self.w_paths = w_paths
        self.device = poly_ring.device
        self.seed = seed
        self.uniform = UniformSampler(None if seed is None else seed + b"bk",
                                      device=self.device)
        self.timings: dict[str, float] = {}   # compile_circuit's phases, s

    # -- helpers ---------------------------------------------------------

    def _rand_field(self, n: int) -> torch.Tensor:
        """n uniform field elements as planes [w, n] on the device (one
        launch of the field-sampling kernel on the card)."""
        return sample_field_digits(self.spec, n, self.uniform)

    def _balanced(self, plain_planes: torch.Tensor) -> np.ndarray:
        """Plain planes [w, n] -> balanced values: int64 where every lane
        fits, else an object array of exact Python ints (the lanes of an
        invalid witness too large for int64)."""
        planes = _host(plain_planes)
        xs, fits = balanced_int64(planes, self.spec)
        if fits.all():
            return xs
        out = xs.astype(object)
        p, half = self.spec.p, self.spec.p >> 1
        bad = np.nonzero(~fits)[0]
        for j, v in enumerate(limb.digits_to_ints(
                torch.from_numpy(planes[:, bad]))):
            out[bad[j]] = v - p if v > half else v
        return out

    def _decompose_vec(self, plain_planes, base: list[int]) -> np.ndarray:
        """decompose_big over a witness vector: [w, n] -> [len(base), n]."""
        xs = self._balanced(plain_planes)
        if xs.dtype != object:
            return decompose_big_vec(xs, base)
        out = np.zeros((len(base), xs.shape[0]), dtype=np.int64)
        for i in range(xs.shape[0]):
            x = int(xs[i])
            for j, b in enumerate(base):
                if x >= b:
                    out[j, i] = 1
                    x -= b
                elif x <= -b:
                    out[j, i] = -1
                    x += b
        return out

    def _sum_check_mask(self, mask_rank: int) -> tuple[FPoly, int]:
        """Random mask with known subgroup sum (reference sumCheckMask,
        prover.go:381-397): final[i] = r[i] - r[i+rank], maskSum = r[0]."""
        ops, rank = self.poly_ring.ops, self.ctx.rank
        r = self._rand_field(mask_rank)
        mask = torch.zeros((self.spec.w, self.poly_ring.rank),
                           dtype=torch.int64, device=self.device)
        mask[:, :mask_rank] = r
        n_fold = mask_rank - rank
        if n_fold > 0:
            mask[:, :n_fold] = ops.sub(mask[:, :n_fold], r[:, rank:mask_rank])
        return FPoly(mask, False), ops.to_ints(r[:, 0:1])[0]

    def _scales(self, batch_const: int, constraints) -> list[torch.Tensor]:
        """The scale of each non-empty constraint as planes [w, 1]: the same
        constant for all (the reference's batching), or batch_const^(i+1)
        in strict mode."""
        mod, ops = self.spec.p, self.poly_ring.ops
        scale, out = batch_const, []
        for c in constraints:
            if not c.terms:
                continue
            out.append(ops.const(scale, (1,)))
            if self.ctx.strict:
                scale = scale * batch_const % mod
        return out

    def _eval_circuit(self, scales, constraints, w_ntt, pw_ntt) -> torch.Tensor:
        """NTT-domain constraint evaluation (reference evalCircuit,
        prover.go:355-379): witness polys multiplied first, the term's
        coefficient last, each constraint scaled by its ``scales`` entry."""
        ring, ops = self.poly_ring, self.poly_ring.ops
        out, si = None, 0
        for c in constraints:
            ev = None
            for t in c.terms:
                polys = ([] if t.pw_id is None else [pw_ntt[t.pw_id]])
                polys += [w_ntt[wid] for wid in t.w_ids]
                if polys:
                    term = polys[0]
                    for q in polys[1:]:
                        term = ops.mul(term, q)
                    term = ops.mul(term, ops.const(t.coeff, (1,)))
                else:
                    term = ops.const(t.coeff, (ring.rank,))
                ev = term if ev is None else ops.add(ev, term)
            if ev is None:
                continue
            ev = ops.mul(ev, scales[si])
            si += 1
            out = ev if out is None else ops.add(out, ev)
        if out is None:
            return ring.new_poly(True).coeffs
        return out

    def _rem_split(self, rem: FPoly):
        """remLo = rem[1:rank]; remHi = remLo shifted to degree
        JindoRank - (rank - 1) (reference prover.go:443-458)."""
        rank, jr = self.ctx.rank, self.params.rank
        rem_lo = rem.coeffs[:, 1:rank]
        rem_hi = rem_lo.new_zeros((self.spec.w, jr))
        rem_hi[:, jr - (rank - 1):] = rem_lo
        return rem_lo, rem_hi

    # -- batched encodes -------------------------------------------------

    def _encode_stack(self, vs: list[torch.Tensor], blinds=None):
        """Encode t value planes at once (interpolation INTT, the X^rank
        blind when ``blinds`` [w, t] is given) and take the embedding NTT:
        ([w, t, emb] coefficients, [w, t, emb] NTT values).  Bit-identical
        to per-vector ``rand_encode``/``encode`` and ``ring.ntt``."""
        vv = torch.stack(vs, dim=1)                          # [w, t, rank]
        e = (self.ecd.encode_planes(vv) if blinds is None
             else self.ecd.rand_encode_planes(vv, blinds))
        return e, self.poly_ring.dev_plan.fwd(e)

    # -- round 3 -----------------------------------------------------------

    def _round3(self, oracle, arith_bc: int, w_ntt, pw_ntt, lin_mask,
                sum_mask) -> list[torch.Tensor]:
        """Round 3 (reference prover.go:341-458), in the order of the JAX
        package's fused program: the round's challenges first, then the
        arithmetic quotient, the linear-check quotient/remLo/remHi and the
        sum-check quotient/remLo/remHi, returned in that order."""
        ctx, spec, ring, ecd = self.ctx, self.spec, self.poly_ring, self.ecd
        ops, rank = ring.ops, ctx.rank
        lin_bc = spec.set_bytes(oracle.compute_challenge("linCheckBatchConst"))
        lin_const = spec.set_bytes(oracle.compute_challenge("linCheckConst"))
        sum_bc = spec.set_bytes(oracle.compute_challenge("sumCheckBatchConst"))
        outs = []
        if ctx.has_arithmetic_check():
            with profiling.span("buckler.prove.arith_check"):
                ev = self._eval_circuit(self._scales(arith_bc,
                                                     ctx.arith_constraints),
                                        ctx.arith_constraints, w_ntt, pw_ntt)
                quo, _ = ring.quo_rem_by_vanishing(ring.intt(FPoly(ev, True)),
                                                   rank)
            outs.append(quo.coeffs[:, :ctx.arith_check_max_rank - rank])
        if ctx.has_linear_check():
            with profiling.span("buckler.prove.lin_check"):
                vec = ring.horner.powers(lin_const, rank, self.device)
                trs = [chk.transpose(vec) for chk in ctx.lin_checkers]
                vec_ntt = ring.ntt(ecd.encode(vec)).coeffs
                bc = ops.const(lin_bc, (1,))
                ev = None
                for chk, tr in zip(ctx.lin_checkers, trs):
                    tr_ntt = ring.ntt(ecd.encode(tr)).coeffs
                    for (out_id, in_id) in ctx.lin_check_constraints[id(chk)]:
                        term = ops.sub(ops.mul(tr_ntt, w_ntt[in_id]),
                                       ops.mul(vec_ntt, w_ntt[out_id]))
                        ev = term if ev is None else ops.add(ops.mul(ev, bc),
                                                             term)
                evp = ring.intt(FPoly(ops.mul(ev, bc), True))
                evp = FPoly(ops.add(evp.coeffs, lin_mask.coeffs), False)
                quo, rem = ring.quo_rem_by_vanishing(evp, rank)
            outs += [quo.coeffs[:, :rank], *self._rem_split(rem)]
        if ctx.has_sum_check():
            with profiling.span("buckler.prove.sum_check"):
                ev = self._eval_circuit(
                    self._scales(sum_bc, ctx.sum_check_constraints),
                    ctx.sum_check_constraints, w_ntt, pw_ntt)
                ev = ops.mul(ev, ops.const(sum_bc, (1,)))
                evp = ring.intt(FPoly(ev, True))
                evp = FPoly(ops.add(evp.coeffs, sum_mask.coeffs), False)
                quo, rem = ring.quo_rem_by_vanishing(evp, rank)
            outs += [quo.coeffs[:, :ctx.sum_check_max_rank - rank],
                     *self._rem_split(rem)]
        return outs

    # -- main ------------------------------------------------------------

    def prove(self, assignment) -> Proof:
        ctx, spec, ring = self.ctx, self.spec, self.poly_ring
        ops, rank, mod = ring.ops, ctx.rank, spec.p
        zeros = lambda: torch.zeros((spec.w, rank), dtype=torch.int64,
                                    device=self.device)

        # assigned witnesses; the derived ones start at zero
        pw = [to_planes(get_path(assignment, p), ops, rank)
              for p in self.pw_paths]
        pw += [zeros() for _ in range(ctx.pw_cnt - len(pw))]
        w = [to_planes(get_path(assignment, p), ops, rank)
             for p in self.w_paths]
        w += [zeros() for _ in range(ctx.w_cnt - len(w))]

        with profiling.span("buckler.prove.decompose"):
            # inf-norm decomposition witnesses (reference prover.go:77-86)
            for wid, w_dcmps in ctx.inf_dcmp_witness.items():
                base = decompose_base(ctx.inf_dcmp_bound[wid])
                digits = self._decompose_vec(w[wid], base)
                for j, wd in enumerate(w_dcmps):
                    w[wd.id] = ternary_planes(ops, digits[j], rank)

            # squared-two-norm decomposition (reference prover.go:88-111)
            for wid, bound in ctx.two_dcmp_bound.items():
                base = decompose_base(bound)
                base_vals, mask_vals = [0] * rank, [0] * rank
                for i in range(len(base)):
                    base_vals[i] = base[i]
                    mask_vals[i] = 1
                pw[ctx.two_dcmp_base[wid].id] = ops.from_ints(base_vals)
                pw[ctx.two_dcmp_mask[wid].id] = ops.from_ints(mask_vals)
                # sum of squares of the balanced values, in int64 chunks
                # where the bounds allow, exact Python ints otherwise
                xs = self._balanced(w[wid])
                sq_nm = 0
                if xs.dtype == object or (np.abs(xs) >= (1 << 23)).any():
                    for v in xs:
                        sq_nm += int(v) * int(v)
                else:
                    sq = xs * xs                      # < 2^46 each
                    for c in range(0, len(sq), 1 << 16):
                        sq_nm += int(np.sum(sq[c:c + (1 << 16)]))
                sq_nm %= mod
                dvals = [0] * rank
                for i, dj in enumerate(decompose_big(sq_nm, base, mod)):
                    dvals[i] = dj % mod
                w[ctx.two_dcmp_witness[wid].id] = ops.from_ints(dvals)

        oracle = Transcript(CHALLENGE_NAMES)

        with profiling.span("buckler.prove.encode_public"):
            pw_ecd_ntt = []
            if pw:
                _, nt = self._encode_stack(pw)
                pw_ecd_ntt = list(nt.unbind(1))

        second_ids = {m.id for m in ctx.w_second}
        n_batch = ctx.batch()
        w_ecd_ntt: list = [None] * ctx.w_cnt
        coms: list = [None] * n_batch
        opens: list = [None] * n_batch
        com_polys: list = [None] * n_batch

        def prepare_many(ids: list[int]):
            """One batched encode for a round's witnesses; the blinds are
            drawn in witness order, one one-lane segment each, as one
            ``_rand_field(1)`` at a time would draw them, in one call."""
            if not ids:
                return
            with profiling.span("buckler.prove.encode_witness"):
                blinds = torch.cat(field_sample.draw_segments(
                    self.spec, self.uniform, [("field", 1)] * len(ids)),
                    dim=1)                                    # [w, t]
                e, nt = self._encode_stack([w[i] for i in ids], blinds)
                for j, i in enumerate(ids):
                    w_ecd_ntt[i] = nt[:, j]
                    com_polys[i] = e[:, j, :rank + 1]

        def commit_batch(slots: list[int], challenge: str,
                         extra_binds: dict[int, bytes] | None = None):
            """One Jindo commit_many for the slots; each commitment (and
            any extra data of its slot) is bound in slot order."""
            with profiling.span("buckler.prove.commit_batch"):
                pairs = self.jindo.commit_many([com_polys[s] for s in slots])
            for s, (com, op) in zip(slots, pairs):
                coms[s], opens[s] = com, op
                oracle.bind(challenge, com.raw_bytes())
                if extra_binds and s in extra_binds:
                    oracle.bind(challenge, extra_binds[s])

        # ROUND 1: first-round witnesses
        r1_ids = [i for i in range(ctx.w_cnt) if i not in second_ids]
        prepare_many(r1_ids)
        commit_batch(r1_ids, "projConst")

        xof = Shake128Stream()
        xof.write(oracle.compute_challenge("projConst"))
        if ctx.proj_checker is not None:
            with profiling.span("buckler.prove.projection"):
                ctx.proj_checker.fill_from_xof(xof)
                for wid, w_proj in ctx.proj_witness.items():
                    w[w_proj.id] = ctx.proj_checker.transform(w[wid])
                for pid, w_dcmp in ctx.proj_inf_dcmp_witness.items():
                    base = decompose_base(ctx.proj_inf_dcmp_bound[pid])
                    digits = self._decompose_vec(w[pid][:, :128], base)
                    # layout dvals[i*len(base)+j] = digits[j, i]
                    w[w_dcmp.id] = ternary_planes(ops, digits.T.ravel(), rank)

        # ROUND 2: projection witnesses and the sum-check masks, one batch
        r2_ids = [m.id for m in ctx.w_second]
        prepare_many(r2_ids)
        round_idx = ctx.w_cnt
        extra: dict[int, bytes] = {}
        mask_slots = []
        lin_mask = lin_mask_sum = sum_mask = sum_mask_sum = None
        if ctx.has_linear_check():
            lin_mask, lin_mask_sum = self._sum_check_mask(2 * rank)
            com_polys[round_idx] = lin_mask.coeffs[:, :2 * rank]
            extra[round_idx] = spec.marshal(lin_mask_sum)
            mask_slots.append(round_idx)
            round_idx += 1
        if ctx.has_sum_check():
            sum_mask, sum_mask_sum = self._sum_check_mask(
                ctx.sum_check_max_rank)
            com_polys[round_idx] = sum_mask.coeffs[:, :ctx.sum_check_max_rank]
            extra[round_idx] = spec.marshal(sum_mask_sum)
            mask_slots.append(round_idx)
            round_idx += 1
        commit_batch(r2_ids + mask_slots, "arithBatchConst", extra)

        arith_bc = spec.set_bytes(oracle.compute_challenge("arithBatchConst"))

        # ROUND 3: every quotient/remainder, committed in one batch
        with profiling.span("buckler.prove.round3"):
            outs = self._round3(oracle, arith_bc, w_ecd_ntt, pw_ecd_ntt,
                                lin_mask, sum_mask)
        r3_slots = list(range(round_idx, round_idx + len(outs)))
        for s, arr in zip(r3_slots, outs):
            com_polys[s] = arr
        commit_batch(r3_slots, "evalPoint")

        eval_point = spec.set_bytes(oracle.compute_challenge("evalPoint"))
        with profiling.span("buckler.prove.evaluate"):
            evals, eval_proof = self.jindo.evaluate(eval_point, com_polys,
                                                    coms, opens)
        return Proof(
            witness=coms,
            lin_check_mask_sum=0 if lin_mask_sum is None else lin_mask_sum,
            sum_check_mask_sum=0 if sum_mask_sum is None else sum_mask_sum,
            evals=evals, eval_proof=eval_proof)
