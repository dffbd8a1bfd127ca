"""Jindo verifier (reference jindo/verifier.go): the oracle replay on the
host, then four checks on the device — the outer commitment norm, the
inner commitment norm, the NTT-domain consistency and the decoded
evaluation — whose few scalars come back in one pull.

Proofs and commitments come from outside the program.  A lane of theirs is
the number its two 16-bit digits spell; a proof or commitment with any
lane outside [0, q) is not canonical and is rejected (``verify`` returns
False) without an exception: the lanes are reduced mod q before any
arithmetic, so the device program is defined on every input, and the
canonical flag travels with the other scalars.  Every tensor of a proof is
uploaded afresh at each call.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from .. import backend
from ..fields import limb
from ..ops import mac_matmul
from ..ops.bigmul import BigMul
from ..ops.horner import tree_sum
from ..rings.rns_device import CrtShiftEmbed, norm_cols_to_int
from .challenge import bind_statement, encode_challenges, left_vec, \
    read_challenges, right_vec
from .encoder import Encoder
from .entities import CommitKey, Commitment, Proof
from .params import Parameters


class Verifier:
    def __init__(self, params: Parameters, crs: bytes, device=None,
                 ck: CommitKey | None = None):
        """Runs on ``device`` (default: the card; raises without CUDA).
        ``ck`` replaces the key expanded from ``crs``, as for ``Prover``."""
        self.device = backend.resolve_device(device)
        self.params = p = params
        self.spec = params.spec
        self.ring_q = p.ring_q.on(self.device)
        self.ring_q_out = p.ring_q_out.on(self.device)
        self.ecd = Encoder(params, ring=self.ring_q)
        self.ck = CommitKey(params, crs, self.device) if ck is None else ck
        self._pk_in, self._pk_out = self.ck.folded(self.ring_q,
                                                   self.ring_q_out)
        # cutoff scalars in Montgomery form (reference verifier.go:26-34)
        self.in_cutoff = self.ring_q.scalar_rns_mont(1 << p.log_in_cutoff)
        self.out_cutoff = self.ring_q_out.scalar_rns_mont(
            1 << p.log_out_cutoff)
        self.lift = CrtShiftEmbed(self.ring_q_out, self.ring_q, 0)
        self.norm_q = CrtShiftEmbed(self.ring_q, self.ring_q, 0)
        self.big = BigMul(self.spec)

    def _eval_weights(self, x: int) -> torch.Tensor:
        """Big-field digit planes [w, cols, d] of the decoded-evaluation
        weights W[i, j*slots+s] = right[i*slots+s] * base^j mod p, so
        that sum W[i,m] * c[i,m] over the balanced partial coefficients c
        equals the reference's decode-then-dot (verifier.go:224-259)."""
        p = self.params
        pp = self.spec.p
        right = right_vec(p, x)
        S, E = p.slots, p.exp
        bp = [1] * E
        for j in range(1, E):
            bp[j] = bp[j - 1] * p.base % pp
        vals = [right[i * S + s] * bp[j] % pp
                for i in range(p.cols) for j in range(E) for s in range(S)]
        return limb.ints_to_digits(vals, self.spec.w).reshape(
            self.spec.w, p.cols, p.degree).to(self.device)

    def _upload(self, pf: Proof, coms: list[Commitment]):
        """Proof and commitments as reduced residues on the device, and
        the flag that all of them were canonical."""
        p = self.params
        lay = Proof.layout(p)
        res, ok = {}, []
        for f in Proof.FIELDS:
            planes = getattr(pf, f)
            if tuple(planes.shape) != (2,) + lay[f][1]:
                raise ValueError(f"proof.{f}: expected digit planes "
                                 f"{(2,) + lay[f][1]}, got {tuple(planes.shape)}")
            ring = self.ring_q_out if f == "in_commit" else self.ring_q
            res[f], flag = ring.from_untrusted_planes(planes)
            ok.append(flag)
        want = (2, self.ring_q_out.L, p.out_msis_rank, p.degree)
        vals = []
        for c in coms:
            if tuple(c.value.shape) != want:
                raise ValueError(f"commitment: expected digit planes {want}, "
                                 f"got {tuple(c.value.shape)}")
            v, flag = self.ring_q_out.from_untrusted_planes(c.value)
            vals.append(v)
            ok.append(flag)
        return res, torch.stack(vals, dim=1), torch.stack(ok).all()

    def _core(self, pf, coms, batch_out, chals, left_ecd, eval_w):
        """All the modular arithmetic of a verification (reference
        verifier.go:98-282).  pf: residues by field; coms [LO, t, outR, d];
        batch_out [LO, t, d] (None for t = 1); chals [L, cols, d];
        left_ecd [L, rows, d]; eval_w [w, cols, d].  Returns (consistent
        flag, outer norm columns, inner norm columns, digits [w] of the
        decoded evaluation)."""
        p = self.params
        ring, ring_out = self.ring_q, self.ring_q_out
        in_commit, partial, encode, mlwe = (
            pf["in_commit"], pf["partial"], pf["encode"], pf["mlwe"])
        mac = mac_matmul.mod_mac
        col = lambda a: a[:, :, None, :]               # one MAC column, n = 1

        # coefficient-domain copies (verifier.go:98-114)
        partial_inv = ring.intt_imform(partial)
        encode_inv = ring.intt_imform(encode)
        mlwe_inv = ring.intt_imform(mlwe)
        in_commit_inv = ring_out.intt_imform(in_commit)

        # outer residual com * 2^outCutoff - Out . InCommit (:136-161)
        if p.batch > 1:
            bo = mac_matmul.folded(ring_out, batch_out[:, None])
            acc = mac(ring_out, bo, coms)[:, 0]
        else:
            acc = coms[:, 0]
        acc = ring_out.mul_scalar_mont(acc, self.out_cutoff)
        acc = ring_out.sub(acc, mac(ring_out, self._pk_out,
                                    col(in_commit))[:, :, 0])
        acc_outer_inv = ring_out.intt_imform(acc)

        # inner residual (sum_j chal_j . lift(InCommit_j) + lift(mask))
        # * 2^inCutoff - In . Encode - MLWE . resMLWE - tail (:164-200)
        lifted = ring.ntt_mform(self.lift(in_commit_inv)).reshape(
            ring.L, p.cols + 1, p.in_msis_rank, p.degree)
        ch = mac_matmul.folded(ring, chals[:, None])
        acc2 = ring.add(mac(ring, ch, lifted[:, :p.cols])[:, 0],
                        lifted[:, p.cols])
        acc2 = ring.mul_scalar_mont(acc2, self.in_cutoff)
        x_enc = torch.cat([encode, mlwe[:, :p.mlwe_rank]], dim=1)
        acc2 = ring.sub(acc2, mac(ring, self._pk_in, col(x_enc))[:, :, 0])
        acc2 = ring.sub(acc2, mlwe[:, p.mlwe_rank:])
        acc_inner_inv = ring.intt_imform(acc2)

        # NTT-domain consistency sum_i left_i . Encode_i = sum chal .
        # Partial + Mask (:203-221)
        le = mac_matmul.folded(ring, left_ecd[:, None])
        test = mac(ring, le, col(encode))[:, 0, 0]
        test = ring.sub(test, mac(ring, ch, col(partial))[:, 0, 0])
        test = ring.sub(test, pf["partial_mask"])
        consistent = ~(test != 0).any()

        # exact l2 norms (:262-282) as digit columns
        cols_out = self.lift.norm_sq_cols([in_commit_inv, acc_outer_inv])
        cols_in = self.norm_q.norm_sq_cols([encode_inv, mlwe_inv,
                                            acc_inner_inv])

        # decoded evaluation sum W[i,m] * c[i,m] mod p (:224-259); the
        # balanced magnitude (|c| < Q/2) can be wider than the field, so
        # its digit columns are reduced mod p first
        mag, neg = self.norm_q.balanced_mag(partial_inv)
        prod = self.big.mul_mod(eval_w, self.big.reduce_cols(torch.stack(mag)))
        pd = torch.tensor(self.big.p_digits, device=prod.device
                          ).reshape(-1, 1, 1)
        signed = torch.where(neg[None], limb.neg(prod, pd), prod)
        test_digits = tree_sum(self.big, signed.reshape(self.spec.w, -1))
        return consistent, cols_out, cols_in, test_digits

    def _y_batch(self, ys: list[int], batch_q) -> int:
        """The batched evaluation sum_i b_i * y_i, b_i the decoded batch
        challenge (verifier.go:224-236); y_0 for t = 1."""
        pp = self.spec.p
        if batch_q is None:
            return ys[0] % pp
        binv = self.ring_q.intt_imform(batch_q)         # [L, t, d]
        return sum(self.ecd.decode(binv[:, i])[0] * y
                   for i, y in enumerate(ys)) % pp

    def verify(self, x: int, coms: list[Commitment], ys: list[int],
               pf: Proof) -> bool:
        p = self.params
        ring, ring_out = self.ring_q, self.ring_q_out
        if len(coms) != p.batch or len(ys) != p.batch:
            raise ValueError("batch size mismatch")

        with record_function("jindo.verify.oracle"):
            oracle, batch_bytes = bind_statement(p, self.ck, coms, x)
            batch_q = batch_out = None
            if batch_bytes is not None:
                batch_q = encode_challenges(p, ring, batch_bytes)
                batch_out = encode_challenges(p, ring_out, batch_bytes)
            for i in range(p.cols):
                oracle.write(ring.to_bytes(pf.partial[:, :, i]))
            oracle.write(ring.to_bytes(pf.partial_mask))
            chals = encode_challenges(p, ring, read_challenges(oracle, p.cols))

        with record_function("jindo.verify.device"):
            res, coms_res, canonical = self._upload(pf, coms)
            consistent, cols_out, cols_in, test_digits = self._core(
                res, coms_res, batch_out, chals,
                self.ecd.encode_scalars(left_vec(p, x)), self._eval_weights(x))
            n_out = cols_out.shape[0]
            sc = torch.cat([torch.stack([canonical, consistent]).to(torch.int64),
                            cols_out, cols_in, test_digits]).tolist()
        if not (sc[0] and sc[1]):
            return False
        with record_function("jindo.verify.norms"):
            if math.isqrt(norm_cols_to_int(sc[2:2 + n_out])) \
                    >= p.in_com_dcmp_two_nm:
                return False
            n_in = cols_in.shape[0]
            if math.isqrt(norm_cols_to_int(sc[2 + n_out:2 + n_out + n_in])) \
                    >= p.res_two_nm:
                return False
        with record_function("jindo.verify.eval"):
            return sc[2 + n_out + n_in:] == self.spec.to_digits_int(
                self._y_batch(ys, batch_q))
