"""Buckler verifier (reference buckler/verifier.go): transcript replay, the
Jindo batched-evaluation verification, then scalar checks of the
arithmetic, linear and sum-check identities at the evaluation point.

The public witnesses are encoded and evaluated on the ring's device, as
are the linear-check vectors; the identities are checked in Python ints.
The port's copy of ``ringo_tpu.buckler.verifier``; it accepts and rejects
the same proofs (tests/test_torch_buckler.py).
"""

from __future__ import annotations

import torch

from ..utils.transcript import Shake128Stream, Transcript
from ..utils import profiling
from .entities import Proof
from .prover import CHALLENGE_NAMES, to_planes
from .utils import decompose_base
from .witness import get_path


class Verifier:
    def __init__(self, params, poly_ring, ecd, ctx, jindo_verifier,
                 pw_paths, w_paths):
        self.params = params
        self.spec = params.spec
        self.poly_ring = poly_ring
        self.ecd = ecd
        self.ctx = ctx
        self.jindo = jindo_verifier
        self.pw_paths = pw_paths
        self.w_paths = w_paths

    def verify(self, assignment, pf: Proof) -> bool:
        """True iff the proof holds for the public witnesses of
        ``assignment``; the secret positions are not read."""
        ctx, spec, ring = self.ctx, self.spec, self.poly_ring
        ops, rank, mod = ring.ops, ctx.rank, spec.p

        pw = [to_planes(get_path(assignment, p), ops, rank)
              for p in self.pw_paths]
        pw += [torch.zeros((spec.w, rank), dtype=torch.int64,
                           device=ring.device)
               for _ in range(ctx.pw_cnt - len(pw))]
        for wid, bound in ctx.two_dcmp_bound.items():
            base = decompose_base(bound)
            base_vals, mask_vals = [0] * rank, [0] * rank
            for i in range(len(base)):
                base_vals[i] = base[i]
                mask_vals[i] = 1
            pw[ctx.two_dcmp_base[wid].id] = ops.from_ints(base_vals)
            pw[ctx.two_dcmp_mask[wid].id] = ops.from_ints(mask_vals)

        oracle = Transcript(CHALLENGE_NAMES)
        second_ids = {m.id for m in ctx.w_second}
        for i in range(ctx.w_cnt):
            if i not in second_ids:
                oracle.bind("projConst", pf.witness[i].raw_bytes())
        proj_bytes = oracle.compute_challenge("projConst")
        if ctx.proj_checker is not None:
            xof = Shake128Stream()
            xof.write(proj_bytes)
            ctx.proj_checker.fill_from_xof(xof)
        for m in ctx.w_second:
            oracle.bind("arithBatchConst", pf.witness[m.id].raw_bytes())

        round_idx = ctx.w_cnt
        lin_mask_eval = sum_mask_eval = 0
        if ctx.has_linear_check():
            lin_mask_eval = pf.evals[round_idx]
            oracle.bind("arithBatchConst", pf.witness[round_idx].raw_bytes())
            oracle.bind("arithBatchConst", spec.marshal(pf.lin_check_mask_sum))
            round_idx += 1
        if ctx.has_sum_check():
            sum_mask_eval = pf.evals[round_idx]
            oracle.bind("arithBatchConst", pf.witness[round_idx].raw_bytes())
            oracle.bind("arithBatchConst", spec.marshal(pf.sum_check_mask_sum))
            round_idx += 1

        arith_bc = spec.set_bytes(oracle.compute_challenge("arithBatchConst"))
        lin_bc = spec.set_bytes(oracle.compute_challenge("linCheckBatchConst"))
        lin_const = spec.set_bytes(oracle.compute_challenge("linCheckConst"))
        sum_bc = spec.set_bytes(oracle.compute_challenge("sumCheckBatchConst"))
        for i in range(round_idx, len(pf.witness)):
            oracle.bind("evalPoint", pf.witness[i].raw_bytes())
        eval_point = spec.set_bytes(oracle.compute_challenge("evalPoint"))

        with profiling.span("buckler.verify.jindo"):
            if not self.jindo.verify(eval_point, pf.witness, pf.evals,
                                     pf.eval_proof):
                return False

        vanish_eval = (pow(eval_point, rank, mod) - 1) % mod
        with profiling.span("buckler.verify.pw_evals"):
            pw_evals = []
            if pw:
                e = self.ecd.encode_planes(torch.stack(pw, dim=1))
                pw_evals = ring.horner.evaluate_many(
                    list(e.unbind(1)), eval_point, ring.device)

        if ctx.has_arithmetic_check():
            ev = self._eval_circuit_scalar(arith_bc, ctx.arith_constraints,
                                           pf.evals, pw_evals)
            if ev != pf.evals[round_idx] * vanish_eval % mod:
                return False
            round_idx += 1

        if ctx.has_linear_check():
            quo_e, lo_e, hi_e = pf.evals[round_idx:round_idx + 3]
            with profiling.span("buckler.verify.lin_check"):
                ok = self._lin_check(lin_bc, lin_const, lin_mask_eval,
                                     eval_point, vanish_eval,
                                     pf.lin_check_mask_sum, quo_e, lo_e, hi_e,
                                     pf.evals)
            if not ok:
                return False
            round_idx += 3

        if ctx.has_sum_check():
            quo_e, lo_e, hi_e = pf.evals[round_idx:round_idx + 3]
            if not self._sum_check(sum_bc, sum_mask_eval, eval_point,
                                   vanish_eval, pf.sum_check_mask_sum,
                                   quo_e, lo_e, hi_e, pf.evals, pw_evals):
                return False
        return True

    # -- scalar checks (reference verifier.go:219-315) ----------------------

    def _eval_circuit_scalar(self, bc, constraints, evals, pw_evals) -> int:
        mod = self.spec.p
        out, scale = 0, bc
        for c in constraints:
            ev = 0
            for t in c.terms:
                term = t.coeff % mod
                if t.pw_id is not None:
                    term = term * pw_evals[t.pw_id] % mod
                for wid in t.w_ids:
                    term = term * evals[wid] % mod
                ev = (ev + term) % mod
            out = (out + ev * scale) % mod
            if self.ctx.strict:
                scale = scale * bc % mod
        return out

    def _rem_shift_ok(self, eval_point, lo_e, hi_e) -> bool:
        mod = self.spec.p
        shift = pow(eval_point, self.params.rank - (self.ctx.rank - 1), mod)
        return hi_e == shift * lo_e % mod

    def _lin_check(self, bc, lin_const, mask_eval, eval_point, vanish_eval,
                   mask_sum, quo_e, lo_e, hi_e, evals) -> bool:
        ctx, mod, ring = self.ctx, self.spec.p, self.poly_ring
        if not self._rem_shift_ok(eval_point, lo_e, hi_e):
            return False
        vec = ring.horner.powers(lin_const, ctx.rank, ring.device)
        lin_eval = ring.evaluate(self.ecd.encode(vec), eval_point)
        ev = 0
        for chk in ctx.lin_checkers:
            tr_eval = ring.evaluate(self.ecd.encode(chk.transpose(vec)),
                                    eval_point)
            for (out_id, in_id) in ctx.lin_check_constraints[id(chk)]:
                term = (tr_eval * evals[in_id] - lin_eval * evals[out_id]) % mod
                ev = (ev * bc + term) % mod
        ev = (ev * bc + mask_eval) % mod
        test = (quo_e * vanish_eval + lo_e * eval_point + mask_sum) % mod
        return ev == test

    def _sum_check(self, bc, mask_eval, eval_point, vanish_eval, mask_sum,
                   quo_e, lo_e, hi_e, evals, pw_evals) -> bool:
        mod = self.spec.p
        if not self._rem_shift_ok(eval_point, lo_e, hi_e):
            return False
        ev = self._eval_circuit_scalar(bc, self.ctx.sum_check_constraints,
                                       evals, pw_evals)
        ev = (ev * bc + mask_eval) % mod
        test = (quo_e * vanish_eval + lo_e * eval_point + mask_sum) % mod
        if self.ctx.strict:
            # honour the declared target sums: sum_H f_total picks up
            # sum_i weight_i * target_i, contributing /rank to rem[0] (the
            # reference stores the targets but never uses them,
            # context.go:85-94)
            corr, scale = 0, bc
            for tgt in self.ctx.sum_check_sums:
                corr = (corr + scale * bc % mod * (tgt % mod)) % mod
                scale = scale * bc % mod
            test = (test + corr * pow(self.ctx.rank, -1, mod)) % mod
        return ev == test
