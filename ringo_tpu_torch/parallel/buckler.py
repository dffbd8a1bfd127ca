"""Sharded Buckler first-round step: the prover's per-witness work (the
randomised interpolation encode and the embedding-ring NTT, reference
buckler/prover.go:141-206) over the ``dp`` axis, fused with the Jindo
commit core over dp / tp / sp (parallel/commit.py).

Each first-round witness is independent until the Fiat-Shamir absorption,
so a t-witness circuit spreads its encodes, NTTs and commits over the
data-parallel ranks and only the commitments return to the transcript.
"""

from __future__ import annotations

from .commit import ShardedStages
from .mesh import check_device


def build_sharded_buckler_round(bk_prover, mesh):
    """fn(w_planes [t, w, rank], blinds [t, w], e_i64 [t, B, R, d],
    noise [t, B, K, d], pk_in, pk_out) -> (w_ecd [t, w, emb], w_ntt
    [t, w, emb], in_commit [t, LO, dcmp, d], outer [t, LO, outR, d]): the
    randomised encodes (``Encoder.rand_encode``), the embedding NTTs
    (``poly_ring.ntt``) and the Jindo commit cores of t first-round
    witnesses over the mesh, whole on every rank."""
    ecd, ring = bk_prover.ecd, bk_prover.poly_ring
    sh = ShardedStages(bk_prover.jindo, mesh)

    def step(w_planes, blinds, e_i64, noise, pk_in, pk_out):
        check_device(mesh, w_planes, blinds, e_i64, noise)
        t = w_planes.shape[0]
        idx = sh.dp.take(t, w_planes.device)
        # [w, t', rank] values and [w, t'] blinds of the rank's witnesses
        e = ecd.rand_encode_planes(w_planes[idx].transpose(0, 1),
                                   blinds[idx].transpose(0, 1))
        w_ecd = sh.dp.gather(e.transpose(0, 1), 0, t)
        w_ntt = sh.dp.gather(ring.dev_plan.fwd(e).transpose(0, 1), 0, t)
        _, _, ic, outer = sh.core(e_i64[idx], noise[idx], pk_in, pk_out)
        gather = lambda x: sh.dp.gather(x, 0, t)
        return w_ecd, w_ntt, gather(ic), gather(outer)

    return step
