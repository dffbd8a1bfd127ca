"""Whole-pipeline sharding: attach a device mesh to a Jindo prover, a
Jindo verifier and a Buckler prover, so that their device stages split
over dp / tp / sp (parallel/commit.py) and, above a rank threshold, the
Buckler embedding-ring NTT pair runs as the four-step over ``sp``
(parallel/bigntt.py).

Everything stays bit-identical to the single-device programs: the lattice
arithmetic is exact integer math, and the one transform whose internal
order changes (the embedding-ring NTT pair) is used only as a pair, so
proofs and verdicts match byte for byte (tests/test_torch_parallel.py).
Every rank calls these, and every later prove and verify, alike.
"""

from __future__ import annotations

import os

from .multihost import bcast_bytes, rank


def shard_jindo_prover(prover, mesh):
    """Commit over dp x tp x sp, evaluate's combine, partial products and
    responses over tp (``Prover.set_mesh``)."""
    prover.set_mesh(mesh)
    return prover


def shard_jindo_verifier(verifier, mesh):
    """The verifier's modular arithmetic over tp (``Verifier.set_mesh``)."""
    verifier.set_mesh(mesh)
    return verifier


def shard_buckler_prover(bk_prover, mesh, ntt_n1: int | None = None,
                         min_ntt_rank: int = 1 << 12):
    """A Buckler prove over the mesh: the Jindo prover's stages sharded,
    and, when the embedding rank is at least ``min_ntt_rank``, the
    embedding-ring NTT pair swapped for the four-step over ``sp``.  Below
    the threshold the all-to-all costs more than the split saves and the
    NTTs stay local.  A prover without a seed takes rank 0's fresh one for
    its blinds and masks, so that the ranks draw alike."""
    from ..csprng import UniformSampler

    shard_jindo_prover(bk_prover.jindo, mesh)
    if bk_prover.seed is None:
        seed = bcast_bytes(os.urandom(32) if rank() == 0 else None, 32)
        bk_prover.uniform = UniformSampler(seed + b"bk",
                                           device=bk_prover.device)
    if bk_prover.poly_ring.rank >= min_ntt_rank:
        bk_prover.poly_ring.shard(mesh, n1=ntt_n1)
    return bk_prover
