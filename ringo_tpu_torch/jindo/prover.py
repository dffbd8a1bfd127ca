"""Jindo prover: ``Prover.commit`` / ``commit_many`` and ``Prover.evaluate``.

Every (column, row) cell of the commitment matrix is encoded, sampled,
NTT'd and MAC'd in whole-tensor operations (reference jindo/prover.go
45-202, which commits one column at a time).  The device draws everything
in exactly the JAX package's sampler order: the masking rows and the two
ChaCha20 keys of a whole batch in one call of the uniform draw
(csprng/field_sample.py: one launch of the field-sampling kernel on the
card), the COSAC corrections of the non-default cells and the mask-column
noise (the Gaussian and AES kernels); ``_commit_batch`` then runs the whole
batch on the device:

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

import os

import numpy as np
import torch

from .. import backend
from ..csprng import RoundedGaussianSampler, UniformSampler
from ..csprng import chacha, field_sample
from ..csprng.gaussian import TwinCDTDevice
from ..fields import limb
from ..ops.horner import HornerPlan
from ..rings.rns_device import CrtShiftEmbed
from ..utils import profiling
from . import stages
from .challenge import bind_statement, encode_challenges, left_vec, \
    read_challenges
from .encoder import Encoder
from .entities import CommitKey, Commitment, Opening, Proof
from .params import Parameters


def sample_field_digits(spec, n: int, u: UniformSampler) -> torch.Tensor:
    """n uniform field elements in [0, p) as digit planes int64 [w, n] on
    the sampler's device (goff MustSetRandom: top-bit-masked rejection;
    csprng/field_sample.py)."""
    return field_sample.draw_segments(spec, u, [("field", n)])[0]


class Prover:
    # share of the card's free memory one batched dispatch may use
    MEM_SHARE = 0.5
    LAYOUTS_MAX = 256   # commitment layouts kept, one per vector length

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
        self.horner = HornerPlan(params.spec)
        self.ck = CommitKey(params, crs, self.device) if ck is None else ck
        self._pd = torch.from_numpy(params.spec.p_digits.astype(np.int64)
                                    ).reshape(-1, 1).to(self.device)
        self._layouts = {}   # n -> _Layout
        self._reseed(seed)
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
        self._sharded = None

    def _reseed(self, seed: bytes | None) -> None:
        """Fresh host samplers: from ``seed``, or from the OS's entropy
        when it is None."""
        self.seed = seed
        self.ecd = Encoder(self.params, seed, ring=self.ring_q)
        self.uniform = UniformSampler(None if seed is None else seed + b"u",
                                      device=self.device)
        self.rounded = RoundedGaussianSampler(
            None if seed is None else seed + b"rg", device=self.device)

    def safe_copy(self, seed: bytes | None = None) -> "Prover":
        """An independent prover for concurrent use (reference SafeCopy,
        jindo/prover.go:327-339): it shares the parameters, the commit key
        and every table (all read-only) and has fresh samplers, random
        like the reference's or derived from ``seed``."""
        new = object.__new__(Prover)
        new.__dict__.update(self.__dict__)
        new._reseed(seed)
        return new

    def set_mesh(self, mesh) -> None:
        """Attach a device mesh (parallel.make_mesh; ``None`` detaches):
        ``commit_many`` then splits each batch over the mesh's ``dp`` axis,
        and its commit core and ``evaluate``'s combine, partial products
        and responses split the RNS prime planes over ``tp`` (the commit
        core also the MAC rows over ``sp``); the collectives of
        parallel/commit.py put the results together on every rank, equal
        to the prover's without a mesh.  Every rank of the mesh calls it
        (and every later commit and evaluate) alike.  A prover without a
        seed takes rank 0's fresh seed, so that the ranks draw alike."""
        if mesh is None:
            self._sharded = None
            return
        from ..parallel.commit import ShardedStages
        from ..parallel.multihost import bcast_bytes, rank

        sharded = ShardedStages(self, mesh)
        if self.seed is None:
            self._reseed(bcast_bytes(os.urandom(32) if rank() == 0 else None,
                                     32))
        self._sharded = sharded

    def raw_stages(self) -> dict:
        """The device stages as plain callables on tensors over this
        prover's rings (jindo/stages.py), keyed as the JAX package's
        ``raw_stages`` (ringo_tpu/jindo/prover.py:622-633):

        * ``commit_core(e_i64, noise, pk_in, pk_out) -> (enc, mlwe,
          ic_ntt, outer)``, per item or with a leading batch axis, with
          ``pk_in, pk_out = ck_device()``;
        * ``sample(e_all, keys_enc, keys_ml, default_lanes, c_sub, oidx,
          noise_mask) -> (e_i64, noise, n_bad)``;
        * ``seeds_encode``, ``partial``, ``response``, ``combine``,
          ``combine_seeds``.

        Absent are the JAX package's fused programs ``commit_fused``,
        ``commit_fused_batch`` and ``commit_from_samples``: they fuse
        ``sample`` and ``commit_core`` into one jitted program (and the
        host fix-up path between them), which eager PyTorch has no use
        for; ``commit_many`` runs ``sample`` then ``commit_core`` on the
        whole batch."""
        p, ring, ring_out = self.params, self.ring_q, self.ring_q_out
        return {
            "commit_core": lambda e_i64, noise, pk_in, pk_out:
                stages.commit_core(p, ring, ring_out, self.crt_in,
                                   self.crt_out, e_i64, noise, pk_in, pk_out),
            "sample": self._sample,
            "seeds_encode": lambda e_i64, noise:
                stages.seeds_encode(ring, e_i64, noise),
            "partial": lambda left_ecd, enc: stages.partial(ring, left_ecd, enc),
            "response": lambda chals, enc, mlwe:
                stages.response(ring, p.cols, chals, enc, mlwe),
            "combine": lambda ics, encs, mlwes, bos, bqs:
                stages.combine(ring, ring_out, ics, encs, mlwes, bos, bqs),
            "combine_seeds": lambda e_all, noise_all, ics, bos, bqs:
                stages.combine_seeds(ring, ring_out, e_all, noise_all, ics,
                                     bos, bqs, self._combine_chunk(e_all,
                                                                   noise_all)),
        }

    def ck_device(self):
        """The commit key as the MAC operands the stages take: (folded
        [In | MLWE] over ring_q, folded Out over ring_q_out), each the
        residues ``mac_matmul.folded`` gives."""
        return self._pk_in, self._pk_out

    # ------------------------------------------------------------ host side

    def _layout(self, n: int) -> "_Layout":
        """The layout of a commitment of n values, built once per n (the
        cache is emptied when it holds LAYOUTS_MAX of them)."""
        lay = self._layouts.get(n)
        if lay is None:
            if len(self._layouts) >= self.LAYOUTS_MAX:
                self._layouts.clear()
            lay = self._layouts[n] = _Layout(self.params, n, self._mask_rows(n),
                                             self.device)
        return lay

    def _mask_rows(self, n: int) -> np.ndarray:
        p = self.params
        cs = p.cols * p.slots
        R = p.rows
        return np.concatenate(
            [[0], 1 + np.nonzero(np.arange(1, R - 1) * cs <= n)[0], [R - 1]])

    def _meta(self, lays: list) -> list:
        """The uniform draws of a batch's commitments, in the stream order
        of the reference (for each: last row, mask column, then the two
        ChaCha20 keys; reference genFirstLastRow, prover.go:65-86) as one
        ``field_sample.draw_segments`` call; per commitment (last row [w,
        cols*slots - 1], mask values [w, mask rows * slots], key_enc,
        key_ml uint8 [32]) on the device."""
        p = self.params
        cs = p.cols * p.slots
        segs = []
        for lay in lays:
            segs += [("field", cs - 1), ("field", len(lay.mask_rows) * p.slots),
                     ("bytes", 32), ("bytes", 32)]
        draws = field_sample.draw_segments(self.spec, self.uniform, segs)
        return [draws[4 * i:4 * i + 4] for i in range(len(lays))]

    def _rows(self, v: torch.Tensor, n: int, last: torch.Tensor):
        """The masking rows on the device: last_row = the draw and a zero,
        first_row = head - last_row (mod p) after head's first value, head
        the first cols*slots values of v, zero-padded."""
        p, w = self.params, self.spec.w
        cs = p.cols * p.slots
        head = torch.zeros((w, cs), dtype=torch.int64, device=self.device)
        m = min(cs, n)
        head[:, :m] = v[:, :m]
        last_row = torch.zeros_like(head)
        last_row[:, :cs - 1] = last
        first_row = torch.empty_like(head)
        first_row[:, 0] = head[:, 0]
        first_row[:, 1:] = limb.sub(head[:, 1:], last, self._pd)
        return first_row, last_row

    def _host_side_meta(self, lay: "_Layout", first_row, last_row, mask_vals,
                        key_enc, key_ml):
        """The COSAC corrections of the non-default cells (all of them
        masking rows, gathered from [first_row | last_row | mask column]
        by ``lay.cells``), the two ChaCha20 keys as int32 [8] and the
        mask-column noise, in the reference's stream order.  The
        corrections and the noise are drawn on the prover's device
        (``sample_device``: the Gaussian kernel and the folded AES keystream
        on the card) and stay there."""
        p, w = self.params, self.spec.w
        d = p.degree
        c_sub = torch.zeros((len(lay.oidx), d), dtype=torch.int64,
                            device=self.device)
        n_other = len(lay.cells)
        if n_other:
            src = torch.cat([first_row, last_row, mask_vals], dim=1)
            e_sub = src.reshape(w, -1, p.slots)[:, lay.cells]
            ecd = self.ecd
            centers = ecd.drift_centers(ecd.base_digits(e_sub))
            sd = lay.sigmas[:, None].expand(n_other, d).reshape(-1)
            c_sub[:n_other] = ecd.cosac.sample_device(
                centers.reshape(-1), sd).reshape(n_other, d)
        K = p.mlwe_rank + p.in_msis_rank
        noise_mask = self.rounded.sample_device(
            0.0, p.mask_mlwe_std_dev, K * d).reshape(K, d)
        return (lay.default, lay.oidx, c_sub, chacha.key_from_bytes(key_enc),
                chacha.key_from_bytes(key_ml), noise_mask)

    # ----------------------------------------------------------- device side

    def _assemble(self, v: torch.Tensor, n: int, lay: "_Layout", first_row,
                  last_row, mask_vals) -> torch.Tensor:
        """Encode-input tensor e_all [w, B*R, S] of one commitment on the
        device: data rows, masking rows and the mask column (the layout
        of the reference's commitColTo, prover.go:89-127)."""
        p = self.params
        w = self.spec.w
        B, R, S = p.cols + 1, p.rows, p.slots
        dev = self.device
        vpad = torch.zeros((w, p.rank), dtype=torch.int64, device=dev)
        vpad[:, :n] = v
        v3 = vpad.reshape(w, R - 1, p.cols, S)
        mid = v3[:, 1:].transpose(1, 2) * lay.pop_mid[None, :, :, None]
        colb = torch.cat([first_row.reshape(w, p.cols, 1, S), mid,
                          last_row.reshape(w, p.cols, 1, S)], dim=2)
        maskc = torch.zeros((w, 1, R, S), dtype=torch.int64, device=dev)
        maskc[:, 0, lay.mask_rows_dev] = mask_vals.reshape(
            w, len(lay.mask_rows), S)
        return torch.cat([colb, maskc], dim=1).reshape(w, B * R, S)

    def _commit_batch(self, e_all, keys_enc, keys_ml, default_lanes, c_sub,
                      oidx, noise_mask):
        """t commits at once, bit-identical to t single commits (same
        per-commit ChaCha streams, same per-lane decisions); split over
        the mesh when one is attached (``set_mesh``).

        e_all [t, w, BR, S] int64; keys_* [t, 8] int32; default_lanes
        [t, BR] bool; c_sub [t, OMAX, d] int64; oidx [t, OMAX] int64;
        noise_mask [t, K, d] int64.  Returns (e_i64 [t, B, R, d],
        noise [t, B, K, d], ic_ntt [t, LO, dcmp, d] residues,
        outer [t, LO, outR, d] residues, overflow): ``overflow`` is true
        where the twin-table disagreements outran ``FIX_CAP``."""
        args = (e_all, keys_enc, keys_ml, default_lanes, c_sub, oidx,
                noise_mask)
        if self._sharded is not None:
            return self._sharded.commit_batch(self, *args)
        with profiling.span("jindo.commit.sample"):
            e_i64, noise, n_bad = self._sample(*args)
        _, _, ic_ntt, outer = self.raw_stages()["commit_core"](
            e_i64, noise, self._pk_in, self._pk_out)
        return e_i64, noise, ic_ntt, outer, n_bad > self.FIX_CAP * len(e_all)

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
        """One batch dispatch: the batch's uniform draws in one call
        (``_meta``), then per commitment its rows and encode input on the
        device and its Gaussian draws.  The spans (utils/profiling.py)
        name the phases in a torch.profiler trace
        (ringo_tpu_torch/profile_commit.py) and in the span registry."""
        p = self.params
        lays = [self._layout(v.shape[1]) for v in vs]
        draws = None
        e_alls, sides = [], []
        for i, v in enumerate(vs):
            n = v.shape[1]
            with profiling.span("jindo.commit.meta"):
                if draws is None:   # the whole batch's, in the first span
                    draws = self._meta(lays)
                last, mask_vals, key_enc, key_ml = draws[i]
            with profiling.span("jindo.commit.assemble"):
                v_dev = v.to(self.device)     # the one upload of v
                rows = self._rows(v_dev, n, last)
                e_alls.append(self._assemble(v_dev, n, lays[i], *rows,
                                             mask_vals))
                del v_dev
            with profiling.span("jindo.commit.host_side"):
                sides.append(self._host_side_meta(lays[i], *rows, mask_vals,
                                                  key_enc, key_ml))
        stack = lambda j: torch.stack([s[j] for s in sides])
        t = len(vs)
        e_i64, noise, ic_ntt, outer, overflow = self._commit_batch(
            torch.stack(e_alls), stack(3), stack(4), stack(0), stack(2),
            stack(1), stack(5))
        with profiling.span("jindo.commit.pull"):
            if bool(overflow):  # pragma: no cover
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
        if self._sharded is not None:
            return self._sharded.seeds_encode(e_i64, noise)
        return stages.seeds_encode(self.ring_q, e_i64, noise)

    def _combine_seeds(self, e_all, noise_all, ics, bos, bqs, chunk=None):
        """Batch-combine t openings with the challenge polynomials
        (reference prover.go:230-268): sum_i b_i * opening_i in every
        tensor.  e_all [t, B, R, d], noise_all [t, B, K, d] signed seeds;
        ics [t, LO, dcmp, d] residues; bos [t, LO, d], bqs [t, L, d] the
        challenges over the two rings.  Returns (ic [LO, dcmp, d], enc
        [L, B, R, d], mlwe [L, B, K, d]).

        The openings are re-encoded ``chunk`` at a time
        (``stages.combine_seeds``); the chunk comes from the free device
        memory over ~64 B per lane and prime of one opening (the int64
        embed, the int32 residues before and after the NTT, and the int64
        temporaries of the Montgomery product and the sum).  Any chunking
        gives the same tensors."""
        if chunk is None:
            chunk = self._combine_chunk(e_all, noise_all)
        if self._sharded is not None:
            return self._sharded.combine_seeds(e_all, noise_all, ics, bos,
                                               bqs, chunk)
        return stages.combine_seeds(self.ring_q, self.ring_q_out, e_all,
                                    noise_all, ics, bos, bqs, chunk)

    def _combine_chunk(self, e_all, noise_all) -> int:
        lanes = e_all[0].numel() + noise_all[0].numel()
        return self._fit(e_all.shape[0], 64 * self.ring_q.L * lanes)

    def _partial(self, left_ecd, enc):
        """Partial products (``stages.partial``): left_ecd [L, R, d], enc
        [L, B, R, d] -> [L, B, d]."""
        if self._sharded is not None:
            return self._sharded.partial(left_ecd, enc)
        return stages.partial(self.ring_q, left_ecd, enc)

    def _response(self, chals, enc, mlwe):
        """Responses (``stages.response``): chals [L, cols, d] -> (resp_e
        [L, R, d], resp_m [L, K, d])."""
        if self._sharded is not None:
            return self._sharded.response(chals, enc, mlwe)
        return stages.response(self.ring_q, self.params.cols, chals, enc, mlwe)

    def _evaluations(self, x: int, vs: list) -> list[int]:
        """y_i = v_i(x) on the device (reference prover.go:318-323), as
        many polynomials at a time as fit: one launch of the Horner kernel
        over the stacked int64 digit planes, w a coefficient."""
        n = max(v.shape[1] for v in vs)
        c = self._fit(len(vs), 8 * self.spec.w * n)
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
            with profiling.span("jindo.evaluate.combine"):
                ic, enc, mlwe = self._combine_seeds(
                    torch.stack([o.seeds[0] for o in opens]),
                    torch.stack([o.seeds[1] for o in opens]),
                    torch.stack([ring_out.from_planes(o.in_commit)
                                 for o in opens]).to(self.device),
                    encode_challenges(p, ring_out, batch_bytes).transpose(0, 1),
                    encode_challenges(p, ring, batch_bytes).transpose(0, 1))
        else:
            with profiling.span("jindo.evaluate.materialize"):
                ic = ring_out.from_planes(opens[0].in_commit).to(self.device)
                enc, mlwe = self._seeds_encode(*opens[0].seeds)

        with profiling.span("jindo.evaluate.partial"):
            left_ecd = self.ecd.encode_scalars(left_vec(p, x))
            part = ring.to_planes(self._partial(left_ecd, enc)).cpu()
        partial, partial_mask = part[:, :, :p.cols], part[:, :, p.cols]
        with profiling.span("jindo.evaluate.oracle"):
            for i in range(p.cols):
                oracle.write(ring.to_bytes(partial[:, :, i]))
            oracle.write(ring.to_bytes(partial_mask))
            chals = encode_challenges(p, ring, read_challenges(oracle, p.cols))
        with profiling.span("jindo.evaluate.response"):
            resp_e, resp_m = self._response(chals, enc, mlwe)
            pf = Proof(in_commit=ring_out.to_planes(ic).cpu(),
                       partial=partial, partial_mask=partial_mask,
                       encode=ring.to_planes(resp_e).cpu(),
                       mlwe=ring.to_planes(resp_m).cpu())
        with profiling.span("jindo.evaluate.horner"):
            evals = self._evaluations(x, vs)
        return evals, pf


class _Layout:
    """What the host side of a commitment depends on only through its n
    values (reference prover.go:65-127), on the device: ``mask_rows``
    (numpy) and ``mask_rows_dev``, the data cells' ``pop_mid`` [cols, R-2]
    (1 where a middle row is populated), ``default`` [B*R] (populated
    cells of the default sigma: the twin-CDT lanes), ``oidx`` [cols + R]
    (the other populated cells, padded with B*R), ``cells`` (each other
    cell's slot block in the cells of [first_row | last_row | mask
    column]) and ``sigmas`` (their standard deviations)."""

    def __init__(self, p: Parameters, n: int, mask_rows: np.ndarray, dev):
        B, R, S = p.cols + 1, p.rows, p.slots
        cs = p.cols * S
        ii = np.arange(p.cols)[:, None]
        jj = np.arange(R)[None, :]
        pop_data = (jj * cs + ii * S <= n) | (jj == 0) | (jj == R - 1)
        sigma = np.zeros((B, R))
        populated = np.zeros((B, R), dtype=bool)
        populated[:p.cols] = pop_data
        sigma[:p.cols] = np.where(pop_data, p.ecd_std_dev, 0.0)
        sigma[:p.cols, 0] = p.ecd_blind_std_dev
        sigma[p.cols, mask_rows] = p.mask_std_dev
        sigma[p.cols, 0] = p.mask_blind_std_dev
        populated[p.cols, mask_rows] = True
        default = populated & np.isclose(sigma, p.ecd_std_dev, rtol=0, atol=0)
        other = np.nonzero((populated & ~default).reshape(-1))[0]
        oidx = np.full((B - 1) + R, B * R, dtype=np.int64)
        oidx[:len(other)] = other
        mask_pos = {int(r): k for k, r in enumerate(mask_rows)}
        cells = np.empty(len(other), dtype=np.int64)
        for k, flat in enumerate(other):
            b, r = divmod(int(flat), R)
            if b == p.cols:
                cells[k] = 2 * p.cols + mask_pos[r]
            elif r in (0, R - 1):
                cells[k] = b if r == 0 else p.cols + b
            else:
                raise AssertionError("middle cells are default-sigma")
        on = lambda a: torch.from_numpy(a).to(dev)
        self.mask_rows = mask_rows
        self.mask_rows_dev = on(mask_rows)
        self.pop_mid = on((jj[:, 1:R - 1] * cs + ii * S <= n).astype(np.int64))
        self.default = on(default.reshape(-1))
        self.oidx = on(oidx)
        self.cells = on(cells)
        self.sigmas = on(sigma.reshape(-1)[other])
