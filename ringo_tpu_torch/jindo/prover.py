"""Jindo prover: ``Prover.commit`` / ``commit_many`` and ``Prover.evaluate``.

Every (column, row) cell of the commitment matrix is encoded, sampled,
NTT'd and MAC'd in whole-tensor operations (reference jindo/prover.go
45-202, which commits one column at a time).  The host draws the small
masking rows, the COSAC corrections of the non-default cells, two ChaCha20
keys and the mask-column noise, in exactly the JAX package's sampler order;
``_commit_batch`` then runs the whole batch on the device:

1. ChaCha20 entropy (CUDA kernel, csprng/chacha.py);
2. base-b digits and drift centres (jindo/encoder.py);
3. the twin-CDT table search (CUDA kernel, csprng/gaussian.py) and the
   exact two-tier resolve of the lanes where the twin tables disagree;
4. encode NTTs (CUDA kernel, ops/ntt_matmul.py), the inner Ajtai MAC
   (ops/mac_matmul.py), the inverse NTT;
5. the exact CRT cutoff (rings/rns_device.py), outer NTT, MAC and cutoff.

``evaluate`` (reference jindo/prover.go:205-324) proves v_i(x) = y_i for
the batch of committed vectors: the Fiat-Shamir oracle on the host, and on
the device the challenge combine of the openings (re-encoded from their
seeds in chunks: the NTT kernel), the partial products and the responses
(two MACs each way) and the evaluations themselves (ops/horner.py).

Commitments, openings, evaluations and proofs equal the JAX package's bit
for bit for the same CRS and seed (tests/test_torch_commit.py,
tests/test_torch_roundtrip.py).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import backend
from ..csprng import RoundedGaussianSampler, UniformSampler
from ..csprng import chacha
from ..csprng.gaussian import TwinCDTDevice
from ..fields import limb
from ..ops import mac_matmul
from ..ops.horner import HornerPlan
from ..rings.rns_device import CrtShiftEmbed
from .challenge import bind_statement, encode_challenges, left_vec, \
    read_challenges
from .encoder import Encoder
from .entities import CommitKey, Commitment, Opening, Proof
from .params import Parameters


def sample_field_digits(spec, n: int, u: UniformSampler) -> torch.Tensor:
    """n uniform field elements in [0, p) as digit planes int64 [w, n]
    (goff MustSetRandom: top-bit-masked rejection)."""
    w = spec.w
    out = torch.zeros((w, n), dtype=torch.int64)
    top_mask = (1 << (spec.bits - 16 * (w - 1))) - 1
    pd = torch.from_numpy(spec.p_digits.astype(np.int64)).reshape(w, 1)
    need = torch.arange(n)
    while len(need):
        raw = u._take_bytes(2 * w * len(need)).view("<u2")
        cand = torch.from_numpy(
            raw.reshape(len(need), w).T.astype(np.int64).copy())
        cand[-1] &= top_mask
        ok = ~limb.geq(cand, pd)
        out[:, need[ok]] = cand[:, ok]
        need = need[~ok]
    return out


class Prover:
    # share of the card's free memory one batched dispatch may use
    MEM_SHARE = 0.5

    def __init__(self, params: Parameters, crs: bytes,
                 seed: bytes | None = None, device=None,
                 ck: CommitKey | None = None):
        """Runs on ``device`` (default: the card; raises without CUDA).
        ``ck`` replaces the key expanded from ``crs`` (tests carry the JAX
        package's key over with ``commit_key_from_arrays``)."""
        self.device = backend.resolve_device(device)
        self.params = p = params
        self.spec = params.spec
        self.ring_q = p.ring_q.on(self.device)
        self.ring_q_out = p.ring_q_out.on(self.device)
        self.ecd = Encoder(params, seed, ring=self.ring_q)
        self.horner = HornerPlan(params.spec)
        self.ck = CommitKey(params, crs, self.device) if ck is None else ck
        self.uniform = UniformSampler(None if seed is None else seed + b"u")
        self.rounded = RoundedGaussianSampler(
            None if seed is None else seed + b"rg")
        self.twin_ecd = TwinCDTDevice(p.ecd_std_dev, self.device)
        self.twin_ml = TwinCDTDevice(p.mlwe_std_dev, self.device)
        self.crt_in = CrtShiftEmbed(self.ring_q, self.ring_q_out,
                                    p.log_in_cutoff)
        self.crt_out = CrtShiftEmbed(self.ring_q_out, self.ring_q_out,
                                     p.log_out_cutoff)
        B, R, d = p.cols + 1, p.rows, p.degree
        # twin-table disagreements are ~2/128 of the lanes; the cap is ~1.6x
        # the expectation (>200 sigmas of slack), as in the JAX package
        self.FIX_CAP = max(4096, -(-B * R * d // 40960) * 1024)
        self._pk_in, self._pk_out = self.ck.folded(self.ring_q,
                                                   self.ring_q_out)

    # ------------------------------------------------------------ host side

    def _meta(self, v_head: torch.Tensor, n: int):
        """Masking rows, sigma/populated maps of one commitment, drawn in
        the uniform-stream order of the reference (last row, then mask
        column); only the first cols*slots values of v are needed here
        (reference genFirstLastRow, prover.go:65-86)."""
        p, spec = self.params, self.spec
        w = spec.w
        B, R, S = p.cols + 1, p.rows, p.slots
        cs = p.cols * S
        head = torch.zeros((w, cs), dtype=torch.int64)
        m = min(cs, n)
        head[:, :m] = v_head[:, :m]
        last_row = torch.zeros((w, cs), dtype=torch.int64)
        last_row[:, :cs - 1] = sample_field_digits(spec, cs - 1, self.uniform)
        first_row = torch.zeros((w, cs), dtype=torch.int64)
        first_row[:, 0] = head[:, 0]
        pd = spec.p_digits.astype(np.int64).reshape(w, 1)
        first_row[:, 1:] = limb.sub(head[:, 1:], last_row[:, :cs - 1], pd)

        sigma = np.zeros((B, R))
        populated = np.zeros((B, R), dtype=bool)
        ii = np.arange(p.cols)[:, None]
        jj = np.arange(R)[None, :]
        pop_data = (jj * cs + ii * S <= n) | (jj == 0) | (jj == R - 1)
        populated[:p.cols] = pop_data
        sigma[:p.cols] = np.where(pop_data, p.ecd_std_dev, 0.0)
        sigma[:p.cols, 0] = p.ecd_blind_std_dev
        mask_rows = self._mask_rows(n)
        mask_vals = sample_field_digits(
            spec, len(mask_rows) * S, self.uniform).reshape(w, len(mask_rows), S)
        sigma[p.cols, mask_rows] = p.mask_std_dev
        sigma[p.cols, 0] = p.mask_blind_std_dev
        populated[p.cols, mask_rows] = True
        return first_row, last_row, mask_rows, mask_vals, sigma, populated

    def _mask_rows(self, n: int) -> np.ndarray:
        p = self.params
        cs = p.cols * p.slots
        R = p.rows
        return np.concatenate(
            [[0], 1 + np.nonzero(np.arange(1, R - 1) * cs <= n)[0], [R - 1]])

    def _host_side_meta(self, first_row, last_row, mask_rows, mask_vals,
                        sigma, populated):
        """Sigma-class lanes, the COSAC corrections of the non-default
        cells (all of them host-known masking rows), the two ChaCha20
        keys and the mask-column noise, in the reference's stream order."""
        p, spec = self.params, self.spec
        w = spec.w
        B, R, S = p.cols + 1, p.rows, p.slots
        BR = B * R
        d = p.degree
        default = populated & np.isclose(sigma, p.ecd_std_dev, rtol=0, atol=0)
        other = populated & ~default
        OMAX = (B - 1) + R
        oidx = np.nonzero(other.reshape(-1))[0]
        oidx_pad = np.full(OMAX, BR, dtype=np.int64)
        oidx_pad[:len(oidx)] = oidx
        c_sub = np.zeros((OMAX, d), dtype=np.int64)
        if len(oidx):
            mask_pos = {int(r): k for k, r in enumerate(mask_rows)}
            e_sub = torch.zeros((w, len(oidx), S), dtype=torch.int64)
            for k, flat in enumerate(oidx):
                b, r = divmod(int(flat), R)
                if b < p.cols:
                    if r not in (0, R - 1):
                        raise AssertionError("middle cells are default-sigma")
                    src = first_row if r == 0 else last_row
                    e_sub[:, k] = src[:, b * S:(b + 1) * S]
                else:
                    e_sub[:, k] = mask_vals[:, mask_pos[r]]
            centers = self.ecd.host_centers(e_sub)
            sd_sub = np.repeat(sigma.reshape(-1)[oidx], d)
            c_sub[:len(oidx)] = self.ecd.cosac.sample(
                centers, sd_sub).reshape(len(oidx), d)
        K = p.mlwe_rank + p.in_msis_rank
        key_enc = chacha.key_from_bytes(bytes(self.uniform._take_bytes(32)))
        key_ml = chacha.key_from_bytes(bytes(self.uniform._take_bytes(32)))
        noise_mask = self.rounded.sample(
            0.0, p.mask_mlwe_std_dev, K * d).reshape(K, d)
        return (torch.from_numpy(default.reshape(-1)),
                torch.from_numpy(oidx_pad), torch.from_numpy(c_sub),
                key_enc, key_ml, torch.from_numpy(noise_mask))

    # ----------------------------------------------------------- device side

    def _assemble(self, v: torch.Tensor, n: int, first_row, last_row,
                  mask_rows, mask_vals) -> torch.Tensor:
        """Encode-input tensor e_all [w, B*R, S] of one commitment on the
        device: data rows, masking rows and the mask column (the layout
        of the reference's commitColTo, prover.go:89-127)."""
        p = self.params
        w = self.spec.w
        B, R, S = p.cols + 1, p.rows, p.slots
        cs = p.cols * S
        dev = self.device
        vpad = torch.zeros((w, p.rank), dtype=torch.int64, device=dev)
        vpad[:, :n] = v
        v3 = vpad.reshape(w, R - 1, p.cols, S)
        ii = torch.arange(p.cols, device=dev)[:, None]
        jj = torch.arange(1, R - 1, device=dev)[None, :]
        pop_mid = (jj * cs + ii * S <= n).to(torch.int64)     # [cols, R-2]
        mid = v3[:, 1:].transpose(1, 2) * pop_mid[None, :, :, None]
        colb = torch.cat([first_row.to(dev).reshape(w, p.cols, 1, S), mid,
                          last_row.to(dev).reshape(w, p.cols, 1, S)], dim=2)
        maskc = torch.zeros((w, 1, R, S), dtype=torch.int64, device=dev)
        maskc[:, 0, torch.from_numpy(mask_rows).to(dev)] = mask_vals.to(dev)
        return torch.cat([colb, maskc], dim=1).reshape(w, B * R, S)

    def _commit_batch(self, e_all, keys_enc, keys_ml, default_lanes, c_sub,
                      oidx, noise_mask):
        """t commits at once, bit-identical to t single commits (same
        per-commit ChaCha streams, same per-lane decisions).

        e_all [t, w, BR, S] int64; keys_* [t, 8] int32; default_lanes
        [t, BR] bool; c_sub [t, OMAX, d] int64; oidx [t, OMAX] int64;
        noise_mask [t, K, d] int64.  Returns (e_i64 [t, B, R, d],
        noise [t, B, K, d], ic_ntt [t, LO, dcmp, d] residues,
        outer [t, LO, outR, d] residues, n_bad)."""
        with record_function("jindo.commit.sample"):
            e_i64, noise, n_bad = self._sample(
                e_all, keys_enc, keys_ml, default_lanes, c_sub, oidx,
                noise_mask)
        with record_function("jindo.commit.encode_mac"):
            com = self._inner(e_i64, noise)
        with record_function("jindo.commit.outer"):
            ic_ntt, outer = self._outer(com, e_all.shape[0])
        return e_i64, noise, ic_ntt, outer, n_bad

    def _sample(self, e_all, keys_enc, keys_ml, default_lanes, c_sub, oidx,
                noise_mask):
        """Entropy, base-b digits, twin-CDT search and resolve, COSAC
        merge: the signed encode coefficients e_i64 [t, B, R, d], the
        noise [t, B, K, d] and the disagreement count."""
        p = self.params
        ecd = self.ecd
        B, R, d = p.cols + 1, p.rows, p.degree
        BR = B * R
        K = p.mlwe_rank + p.in_msis_rank
        t, w = e_all.shape[:2]
        e_flat = e_all.transpose(0, 1).reshape(w, t * BR, p.slots)
        u_enc = chacha.keystream_u64_batch(keys_enc, BR * d).reshape(t * BR, d)
        u_ml = chacha.keystream_u64_batch(keys_ml, p.cols * K * d
                                          ).reshape(t * p.cols, K, d)
        coeffs = ecd.base_digits(e_flat)                    # [t*BR, d]
        centers = ecd.drift_centers(coeffs)
        prov, agree, c_floor, c_frac, v0, v1 = self.twin_ecd.search(
            centers, u_enc)
        prov_ml = self.twin_ml.search(None, u_ml, zero_center=True)[0]
        dl = default_lanes.reshape(t * BR)
        bad = ((~agree) & dl[:, None]).reshape(-1)
        sentinel = t * BR * d
        idx = limb.nonzero_idx(bad, self.FIX_CAP * t)
        safe = torch.clamp(idx, max=sentinel - 1)
        g = lambda a: a.reshape(-1)[safe]
        fix_val = self.twin_ecd.resolve_device(
            g(c_frac), g(u_enc), g(v0), g(v1), g(c_floor),
            valid=idx < sentinel, tier2=4096 * t)
        # merge: twin-CDT agreements, sparse COSAC cells, resolved fixes
        base = torch.arange(t, device=oidx.device)[:, None] * BR
        oidx_g = torch.where(oidx < BR, oidx + base, t * BR).reshape(-1)
        c_other = torch.zeros((t * BR, d), dtype=torch.int64,
                              device=self.device)
        c_other = limb.put_drop(c_other, oidx_g, c_sub.reshape(-1, d))
        c = torch.where(dl[:, None], prov, c_other)
        cf = limb.put_drop(c.reshape(-1), idx, fix_val)
        e_i64 = ecd.correction_total(coeffs, cf.reshape(t * BR, d)
                                     ).reshape(t, B, R, d)
        noise = torch.cat([prov_ml.reshape(t, p.cols, K, d),
                           noise_mask[:, None]], dim=1)     # [t, B, K, d]
        return e_i64, noise, bad.sum()

    def _inner(self, e_i64, noise):
        """Encode NTTs, inner Ajtai MAC (n-axis t*B), inverse NTT:
        inner commitments [L, J, t*B, d] in the coefficient domain."""
        p = self.params
        ring = self.ring_q
        t, B, d = e_i64.shape[0], p.cols + 1, p.degree
        J = p.in_msis_rank
        enc = ring.ntt_mform(ring.embed_int64(e_i64))       # [L, t, B, R, d]
        mlwe = ring.ntt_mform(ring.embed_int64(noise))      # [L, t, B, K, d]
        x_all = torch.cat([enc.permute(0, 3, 1, 2, 4),
                           mlwe[:, :, :, :p.mlwe_rank].permute(0, 3, 1, 2, 4)],
                          dim=1)                            # [L, KK, t, B, d]
        x_all = x_all.reshape(ring.L, -1, t * B, d)
        com = mac_matmul.mod_mac(ring, self._pk_in, x_all)  # [L, J, t*B, d]
        tail = mlwe[:, :, :, p.mlwe_rank:].permute(0, 3, 1, 2, 4
                                                   ).reshape(ring.L, J, t * B, d)
        return ring.intt_imform(ring.add(com, tail))

    def _outer(self, com, t: int):
        """Inner CRT cutoff, outer NTT, MAC and cutoff: (ic_ntt
        [t, LO, dcmp, d], outer [t, LO, outR, d]) residues."""
        p = self.params
        ring_out = self.ring_q_out
        B, d = p.cols + 1, p.degree
        J, LO, dcmp = p.in_msis_rank, ring_out.L, p.in_com_dcmp_len
        ic = self.crt_in(com).reshape(LO, J, t, B, d)
        ic = ic.permute(0, 2, 3, 1, 4).reshape(LO, t * dcmp, d)
        ic_ntt = ring_out.ntt_mform(ic).reshape(LO, t, dcmp, d)
        x_out = ic_ntt.transpose(1, 2)                      # [LO, dcmp, t, d]
        acc = mac_matmul.mod_mac(ring_out, self._pk_out, x_out)
        acc = ring_out.intt_imform(acc)                     # [LO, outR, t, d]
        outer = ring_out.ntt_mform(self.crt_out(acc))
        return ic_ntt.transpose(0, 1), outer.permute(2, 0, 1, 3)

    # ---------------------------------------------------------------- commit

    def _fit(self, t: int, per: int) -> int:
        """How many of t items of ``per`` bytes of live transients one
        dispatch takes: on the card, what fits MEM_SHARE of the free
        device memory (``torch.cuda.mem_get_info``); all of them on the
        CPU."""
        if self.device.type != "cuda":
            return t
        free, _ = torch.cuda.mem_get_info(self.device)
        return max(1, min(t, int(free * self.MEM_SHARE) // per))

    def _chunk(self, t: int) -> int:
        """Commits per batch dispatch, from an estimate of one commit's
        live transients: ~40 B/lane for the sampling front end, the
        int32/int64 copies around the NTTs, and the float64 byte planes of
        the MAC."""
        p = self.params
        B, R, d = p.cols + 1, p.rows, p.degree
        K = p.mlwe_rank + p.in_msis_rank
        lanes = B * R * d
        per = (260 * lanes + 120 * B * K * d
               + 8 * self.ring_q.L * d * 4 * (p.rows + p.mlwe_rank) * B)
        return self._fit(t, per)

    def _as_planes(self, v) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.asarray(v, dtype=np.int64))
        if v.dim() != 2 or v.shape[0] != self.spec.w:
            raise ValueError(f"v: expected digit planes [w={self.spec.w}, n]")
        if v.shape[1] > self.params.rank:
            raise ValueError("len(v) > params.rank")
        return v.to(torch.int64)

    def commit(self, v):
        """Commit plain digit planes v [w, n], n <= rank (numpy or torch).
        Returns (Commitment, Opening).  Reference prover.go:45-202."""
        return self.commit_many([v])[0]

    def commit_many(self, vs: list):
        """Commit a batch of vectors; bit-identical to sequential
        ``commit`` calls.  The batch runs in chunks sized by ``_chunk``."""
        vs = [self._as_planes(v) for v in vs]
        out = []
        c = self._chunk(len(vs)) if vs else 1
        for s in range(0, len(vs), c):
            out.extend(self._commit_chunk(vs[s:s + c]))
        return out

    def _commit_chunk(self, vs: list):
        """One batch dispatch.  The ``record_function`` spans name the
        phases in a torch.profiler trace (ringo_tpu_torch/profile_commit.py)
        and cost nothing measurable without one."""
        p = self.params
        cs = p.cols * p.slots
        e_alls, sides = [], []
        for v in vs:
            n = v.shape[1]
            with record_function("jindo.commit.meta"):
                meta = self._meta(v[:, :cs].cpu(), n)
            with record_function("jindo.commit.host_side"):
                sides.append(self._host_side_meta(*meta))
            with record_function("jindo.commit.assemble"):
                e_alls.append(self._assemble(v.to(self.device), n, *meta[:4]))
        stack = lambda j: torch.stack([s[j] for s in sides]).to(self.device)
        t = len(vs)
        e_i64, noise, ic_ntt, outer, n_bad = self._commit_batch(
            torch.stack(e_alls), stack(3), stack(4), stack(0), stack(2),
            stack(1), stack(5))
        with record_function("jindo.commit.pull"):
            if int(n_bad) > self.FIX_CAP * t:  # pragma: no cover
                raise RuntimeError("twin-CDT disagreements exceed FIX_CAP")
            ring_out = self.ring_q_out
            outer_h = ring_out.to_planes(outer).cpu()      # [2, t, LO, outR, d]
            ic_planes = ring_out.to_planes(ic_ntt)         # [2, t, LO, dcmp, d]
        return [(Commitment(p, outer_h[:, i]),
                 Opening(p, in_commit=ic_planes[:, i],
                         seeds=(e_i64[i], noise[i])))
                for i in range(t)]

    # -------------------------------------------------------------- evaluate

    def _seeds_encode(self, e_i64, noise):
        """An opening's Encode / MLWE tensors from its seeds (embed, MForm,
        NTT): signed [*lead, d] -> residues [L, *lead, d]."""
        ring = self.ring_q
        return (ring.ntt_mform(ring.embed_int64(e_i64)),
                ring.ntt_mform(ring.embed_int64(noise)))

    def _combine_seeds(self, e_all, noise_all, ics, bos, bqs, chunk=None):
        """Batch-combine t openings with the challenge polynomials
        (reference prover.go:230-268): sum_i b_i * opening_i in every
        tensor.  e_all [t, B, R, d], noise_all [t, B, K, d] signed seeds;
        ics [t, LO, dcmp, d] residues; bos [t, LO, d], bqs [t, L, d] the
        challenges over the two rings.  Returns (ic [LO, dcmp, d], enc
        [L, B, R, d], mlwe [L, B, K, d]).

        The openings are re-encoded ``chunk`` at a time, one batched NTT
        each for Encode and MLWE; the chunk comes from the free device
        memory over ~64 B per lane and prime of one opening (the int64
        embed, the int32 residues before and after the NTT, and the int64
        temporaries of the Montgomery product and the sum).  Sums of
        canonical residues are exact in int64 and mod-add is associative,
        so any chunking gives the same tensors."""
        ring, ring_out = self.ring_q, self.ring_q_out
        t = e_all.shape[0]
        if chunk is None:
            lanes = e_all[0].numel() + noise_all[0].numel()
            chunk = self._fit(t, 64 * ring.L * lanes)

        def fold(rg, x, b):
            """sum over the opening axis 1 of x * b, mod q."""
            s = rg.mul_mont(x, b).to(torch.int64).sum(dim=1)
            return (s % rg._col(rg.q, s.dim())).to(torch.int32)

        acc = None
        for c0 in range(0, t, chunk):
            sl = slice(c0, c0 + chunk)
            enc, ml = self._seeds_encode(e_all[sl], noise_all[sl])
            bq = bqs[sl].transpose(0, 1)[:, :, None, None, :]
            bo = bos[sl].transpose(0, 1)[:, :, None, :]
            part = (fold(ring_out, ics[sl].transpose(0, 1), bo),
                    fold(ring, enc, bq), fold(ring, ml, bq))
            acc = part if acc is None else (
                ring_out.add(acc[0], part[0]), ring.add(acc[1], part[1]),
                ring.add(acc[2], part[2]))
        return acc

    def _partial(self, left_ecd, enc):
        """Partial products sum_j left_j * Encode[:, j] (reference
        prover.go:275-294), a MAC over the rows axis: left_ecd [L, R, d],
        enc [L, B, R, d] -> [L, B, d]."""
        lp = mac_matmul.folded(self.ring_q, left_ecd[:, None])
        return mac_matmul.mod_mac(self.ring_q, lp, enc.transpose(1, 2))[:, 0]

    def _response(self, chals, enc, mlwe):
        """Responses: the mask column plus sum_j chal_j * column_j
        (reference prover.go:296-316), MACs over the cols axis: chals
        [L, cols, d] -> (resp_e [L, R, d], resp_m [L, K, d])."""
        ring, cols = self.ring_q, self.params.cols
        cp = mac_matmul.folded(ring, chals[:, None])
        te = mac_matmul.mod_mac(ring, cp, enc[:, :cols])
        tm = mac_matmul.mod_mac(ring, cp, mlwe[:, :cols])
        return (ring.add(enc[:, cols], te[:, 0]),
                ring.add(mlwe[:, cols], tm[:, 0]))

    def _evaluations(self, x: int, vs: list) -> list[int]:
        """y_i = v_i(x) on the device (reference prover.go:318-323), as
        many polynomials at a time as fit: the Barrett products keep
        about 150 int64 digit planes per coefficient alive."""
        n = max(v.shape[1] for v in vs)
        c = self._fit(len(vs), 150 * 8 * n)
        out = []
        for s in range(0, len(vs), c):
            out.extend(self.horner.evaluate_many(vs[s:s + c], x, self.device))
        return out

    def evaluate(self, x: int, vs: list, coms: list[Commitment],
                 opens: list[Opening]):
        """Batched evaluation proof at x (reference prover.go:205-324).
        vs: the committed plain digit planes [w, n_i] (numpy or torch, on
        any device).  Returns (evaluations as Python ints, Proof)."""
        p = self.params
        if not (len(vs) == len(coms) == len(opens) == p.batch):
            raise ValueError("batch size mismatch")
        vs = [self._as_planes(v) for v in vs]
        ring, ring_out = self.ring_q, self.ring_q_out
        oracle, batch_bytes = bind_statement(p, self.ck, coms, x)

        if p.batch > 1:
            with record_function("jindo.evaluate.combine"):
                ic, enc, mlwe = self._combine_seeds(
                    torch.stack([o.seeds[0] for o in opens]),
                    torch.stack([o.seeds[1] for o in opens]),
                    torch.stack([ring_out.from_planes(o.in_commit)
                                 for o in opens]).to(self.device),
                    encode_challenges(p, ring_out, batch_bytes).transpose(0, 1),
                    encode_challenges(p, ring, batch_bytes).transpose(0, 1))
        else:
            with record_function("jindo.evaluate.materialize"):
                ic = ring_out.from_planes(opens[0].in_commit).to(self.device)
                enc, mlwe = self._seeds_encode(*opens[0].seeds)

        with record_function("jindo.evaluate.partial"):
            left_ecd = self.ecd.encode_scalars(left_vec(p, x))
            part = ring.to_planes(self._partial(left_ecd, enc)).cpu()
        partial, partial_mask = part[:, :, :p.cols], part[:, :, p.cols]
        with record_function("jindo.evaluate.oracle"):
            for i in range(p.cols):
                oracle.write(ring.to_bytes(partial[:, :, i]))
            oracle.write(ring.to_bytes(partial_mask))
            chals = encode_challenges(p, ring, read_challenges(oracle, p.cols))
        with record_function("jindo.evaluate.response"):
            resp_e, resp_m = self._response(chals, enc, mlwe)
            pf = Proof(in_commit=ring_out.to_planes(ic).cpu(),
                       partial=partial, partial_mask=partial_mask,
                       encode=ring.to_planes(resp_e).cpu(),
                       mlwe=ring.to_planes(resp_m).cpu())
        with record_function("jindo.evaluate.horner"):
            evals = self._evaluations(x, vs)
        return evals, pf
