"""Sharded Jindo commitment and evaluation stages: explicit SPMD over a
``dp`` x ``tp`` x ``sp`` mesh (parallel/mesh.py).

The commit core (jindo/stages.py ``commit_core``: encode NTTs, inner
Ajtai MAC, exact CRT cutoff, outer MAC and cutoff; reference
jindo/prover.go:45-202) runs on each rank as:

* ``dp``: the rank's items of the batch (an uneven batch is padded and
  the pad dropped after the gather, as GSPMD pads in the JAX package);
* ``tp``: the encode NTTs, the inner MAC and its inverse NTT over a ring
  of the rank's primes, then an all-gather of the planes, since the exact
  CRT cutoff needs every plane; the outer NTTs and MAC likewise over the
  outer ring's primes;
* ``sp``: the MAC rows of the rank (a key row slice,
  ``mac_matmul.key_slice``), gathered before the outer MAC, which
  contracts across the inner rows, and again after the outer cutoff.

The evaluation stages (partial products, responses, the combination of
a batch of openings) split the planes over ``tp``.  Every result is whole
on every rank and equals the single-device stages bit for bit
(tests/test_torch_parallel.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..jindo import stages
from ..ops.mac_matmul import key_slice
from ..rings.rns import RnsRing
from ..utils import profiling
from .mesh import check_device, mesh_axes


def sub_ring(ring, idx: torch.Tensor):
    """The ring of the primes at ``idx`` (the ring itself when that is all
    of them, in order)."""
    sel = idx.tolist()
    if sel == list(range(ring.L)):
        return ring
    return RnsRing(ring.d, [ring.primes[i] for i in sel], ring.device)


class ShardedStages:
    """A prover's device stages split over a mesh; the rank's primes and
    MAC rows are fixed at construction.  ``Prover.set_mesh`` holds one,
    and ``build_sharded_commit`` / ``build_sharded_evaluate`` wrap one.
    It keeps the prover's parameters, rings and cutoffs, not the prover
    (which holds it)."""

    def __init__(self, prover, mesh):
        self.mesh = mesh
        self.params = p = prover.params
        self.full = (prover.ring_q, prover.ring_q_out)
        self.crt_in, self.crt_out = prover.crt_in, prover.crt_out
        self.dp, self.tp, self.sp = mesh_axes(mesh, prover.device)
        dev = prover.device
        self.pl_in = self.tp.take(prover.ring_q.L, dev)
        self.pl_out = self.tp.take(prover.ring_q_out.L, dev)
        self.rows_in = self.sp.take(p.in_msis_rank, dev)
        self.rows_out = self.sp.take(p.out_msis_rank, dev)
        self.ring = sub_ring(prover.ring_q, self.pl_in)
        self.ring_out = sub_ring(prover.ring_q_out, self.pl_out)

    def _planes(self, x, out: bool = False):
        """All planes of the rank's part [L', ...] gathered over tp."""
        return self.tp.gather(x, 0, self.full[out].L)

    def core(self, e_i64, noise, pk_in, pk_out):
        """``commit_core`` of the rank's items (e_i64 [t, B, R, d], noise
        [t, B, K, d]) over tp and sp: batch-first (enc, mlwe, ic_ntt,
        outer), whole on every rank of the tp x sp group."""
        p = self.params
        t = e_i64.shape[0]
        with profiling.span("jindo.commit.encode_mac"):
            enc, mlwe, com = stages.encode_mac(
                p, self.ring, e_i64, noise,
                key_slice(pk_in, self.pl_in, self.rows_in), self.rows_in)
            com = self._planes(com)
        with profiling.span("jindo.commit.outer"):
            ic = self.sp.gather(self.crt_in(com), 1, p.in_msis_rank)
            ic = stages.dcmp_order(p, ic, t)
            ic_ntt, acc = stages.outer_mac(
                p, self.ring_out, ic[self.pl_out],
                key_slice(pk_out, self.pl_out, self.rows_out))
            outer = stages.finalize(self.full[1], self.crt_out,
                                    self._planes(acc, out=True))
            outer = self.sp.gather(outer, 1, p.out_msis_rank)
            ic_ntt = self._planes(ic_ntt, out=True)
        return (self._planes(enc).transpose(0, 1),
                self._planes(mlwe).transpose(0, 1), ic_ntt.transpose(0, 1),
                outer.permute(2, 0, 1, 3))

    def commit(self, e_i64, noise, pk_in, pk_out):
        """``commit_core`` of a batch [t, ...]: the dp split, ``core``,
        and the dp gather; every output has the leading batch axis t."""
        check_device(self.mesh, e_i64, noise)
        t = e_i64.shape[0]
        idx = self.dp.take(t, e_i64.device)
        out = self.core(e_i64[idx], noise[idx], pk_in, pk_out)
        return tuple(self.dp.gather(o, 0, t) for o in out)

    def commit_batch(self, prv, e_all, keys_enc, keys_ml, default_lanes,
                     c_sub, oidx, noise_mask):
        """``Prover._commit_batch`` of ``prv`` over the mesh: each dp rank
        samples and commits its items, the results are gathered, and the
        FIX_CAP overflow flag is the maximum over the ranks."""
        t = e_all.shape[0]
        idx = self.dp.take(t, e_all.device)
        args = [a[idx] for a in (e_all, keys_enc, keys_ml, default_lanes,
                                 c_sub, oidx, noise_mask)]
        with profiling.span("jindo.commit.sample"):
            e_i64, noise, n_bad = prv._sample(*args)
        _, _, ic_ntt, outer = self.core(e_i64, noise, prv._pk_in, prv._pk_out)
        over = (n_bad > prv.FIX_CAP * len(idx)).to(torch.int64).reshape(1)
        dist.all_reduce(over, op=dist.ReduceOp.MAX, group=self.dp.group)
        gather = lambda x: self.dp.gather(x, 0, t)
        return (gather(e_i64), gather(noise), gather(ic_ntt), gather(outer),
                over[0] > 0)

    # ---- evaluate: the planes over tp

    def seeds_encode(self, e_i64, noise):
        return tuple(self._planes(x) for x in
                     stages.seeds_encode(self.ring, e_i64, noise))

    def partial(self, left_ecd, enc):
        pl = self.pl_in
        return self._planes(stages.partial(self.ring, left_ecd[pl], enc[pl]))

    def response(self, chals, enc, mlwe):
        pl = self.pl_in
        return tuple(self._planes(x) for x in stages.response(
            self.ring, self.params.cols, chals[pl], enc[pl], mlwe[pl]))

    def combine_seeds(self, e_all, noise_all, ics, bos, bqs, chunk: int):
        ic, enc, mlwe = stages.combine_seeds(
            self.ring, self.ring_out, e_all, noise_all, ics[:, self.pl_out],
            bos[:, self.pl_out], bqs[:, self.pl_in], chunk)
        return self._planes(ic, out=True), self._planes(enc), self._planes(mlwe)


def build_sharded_commit(prover, mesh):
    """fn(e_i64 [t, B, R, d], noise [t, B, K, d], pk_in, pk_out) -> (enc
    [t, L, B, R, d], mlwe [t, L, B, K, d], in_commit [t, LO, dcmp, d],
    outer [t, LO, outR, d]) residues over the mesh, equal per item to
    ``prover.raw_stages()["commit_core"]``; ``t`` need not divide ``dp``.
    Every rank calls it with the same inputs and gets the whole result."""
    return ShardedStages(prover, mesh).commit


def commit_batch(prover, mesh, e_i64, noise):
    """The sharded commit core once on host-made encode coefficients and
    noise (numpy or tensors), moved to the prover's device."""
    put = lambda a: torch.as_tensor(a).to(prover.device)
    return build_sharded_commit(prover, mesh)(put(e_i64), put(noise),
                                              *prover.ck_device())


def build_sharded_evaluate(prover, mesh):
    """fn(left_ecd [L, R, d], enc [t, L, B, R, d], mlwe [t, L, B, K, d],
    chals [L, cols, d]) -> (partials [t, L, B, d], resp_e [t, L, R, d],
    resp_m [t, L, K, d]): the partial products and responses of t
    openings, the openings over ``dp`` and the planes over ``tp``."""
    sh = ShardedStages(prover, mesh)

    def step(left_ecd, enc, mlwe, chals):
        check_device(mesh, left_ecd, enc, mlwe, chals)
        t = enc.shape[0]
        outs = [], [], []
        for i in sh.dp.take(t, enc.device).tolist():
            resp = sh.response(chals, enc[i], mlwe[i])
            for acc, x in zip(outs, (sh.partial(left_ecd, enc[i]), *resp)):
                acc.append(x)
        return tuple(sh.dp.gather(torch.stack(o), 0, t) for o in outs)

    return step
