"""Jindo protocol objects of the commit path: CommitKey, Commitment,
Opening (reference jindo/entities.go).

CommitKey expansion is bit-compatible with the reference: AES-CTR from the
CRS seed, SampleN per (coefficient, level) in the same order
(entities.go:21-73).  The key is held as residues on the prover's device;
``commit_key_from_arrays`` builds one from the JAX package's digit-plane
arrays instead, so the compute path can be checked apart from the
AES/CRS path.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..csprng import UniformSampler
from .params import Parameters


def _sample_ring_polys(u: UniformSampler, ring, count: int) -> np.ndarray:
    """count uniform polys over ``ring`` in the reference's order (per
    poly, per coefficient, per level: SampleN(q_l)) -> uint64 [L, count, d]."""
    d, L = ring.d, ring.L
    qs = np.array(ring.primes, dtype=np.uint64)
    bounds = np.array([(1 << 64) - 1 - ((1 << 64) - 1) % int(q) for q in qs],
                      dtype=np.uint64)
    snap = u._snapshot()
    draws = u.sample_u64(count * d * L).reshape(count, d, L)
    if bool((draws < bounds).all()):
        res = draws % qs
    else:  # astronomically rare: replay in exact scalar order
        u._restore(snap)
        res = np.empty((count, d, L), dtype=np.uint64)
        for c in range(count):
            for k in range(d):
                for l in range(L):
                    res[c, k, l] = u.sample_n(int(qs[l]), 1)[0]
    return np.moveaxis(res, -1, 0)


class CommitKey:
    """CRS-expanded commitment matrices (reference entities.go:12-77), as
    int32 residues on ``device``:

    In   [L,  inR, rows,     d]  over ring_q
    MLWE [L,  inR, mlweRank, d]  over ring_q
    Out  [LO, outR, dcmpLen, d]  over ring_q_out
    """

    def __init__(self, params: Parameters, crs: bytes, device=None):
        p = params
        self.crs = bytes(crs)
        self.device = backend.resolve_device(device)
        u = UniformSampler(self.crs)
        In = _sample_ring_polys(u, p.ring_q, p.in_msis_rank * p.rows)
        MLWE = _sample_ring_polys(u, p.ring_q, p.in_msis_rank * p.mlwe_rank)
        Out = _sample_ring_polys(u, p.ring_q_out,
                                 p.out_msis_rank * p.in_com_dcmp_len)
        self._set(p, In, MLWE, Out)

    def _set(self, p: Parameters, In, MLWE, Out):
        put = lambda a: torch.from_numpy(
            np.ascontiguousarray(a).astype(np.int32)).to(self.device)
        d = p.degree
        self.In = put(In).reshape(p.ring_q.L, p.in_msis_rank, p.rows, d)
        self.MLWE = put(MLWE).reshape(p.ring_q.L, p.in_msis_rank,
                                      p.mlwe_rank, d)
        self.Out = put(Out).reshape(p.ring_q_out.L, p.out_msis_rank,
                                    p.in_com_dcmp_len, d)


def commit_key_from_arrays(params: Parameters, In, MLWE, Out,
                           device=None) -> CommitKey:
    """A CommitKey from the JAX package's key arrays (digit planes
    [2, L, ...] with 16-bit digits).  Its ``crs`` is None: it binds no
    transcript."""
    ck = object.__new__(CommitKey)
    ck.crs = None
    ck.device = backend.resolve_device(device)
    res = lambda a: (np.asarray(a, dtype=np.uint64)[0]
                     | (np.asarray(a, dtype=np.uint64)[1] << np.uint64(16)))
    ck._set(params, res(In), res(MLWE), res(Out))
    return ck


class Commitment:
    """Outer commitment: digit planes [2, LO, outMSISRank, d] over
    ring_q_out, NTT + MForm, held on the host."""

    def __init__(self, params: Parameters, value: torch.Tensor):
        self.params = params
        self.value = value

    def to_bytes(self) -> bytes:
        """Canonical bytes (the JAX package's ``Commitment.to_bytes``)."""
        return self.params.ring_q_out.to_bytes(self.value)


class Opening:
    """Commitment opening (reference entities.go:102-137).  The
    Encode/MLWE tensors are deterministic NTT images of the signed encode
    coefficients and noise, so the opening keeps those compact ``seeds``
    (e_i64 [B, R, d], noise [B, K, d], int64, on the device) beside the
    inner commitment ``in_commit`` (digit planes [2, LO, dcmp, d]).  The
    materialiser that re-derives Encode/MLWE comes with evaluate."""

    def __init__(self, params: Parameters, in_commit: torch.Tensor, seeds):
        self.params = params
        self.in_commit = in_commit
        self.seeds = seeds
