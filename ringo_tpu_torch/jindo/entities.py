"""Jindo protocol objects: CommitKey, Commitment, Opening, Proof
(reference jindo/entities.go).

CommitKey expansion is bit-compatible with the reference: AES-CTR from the
CRS seed, SampleN per (coefficient, level) in the same order
(entities.go:21-73).  The key is held as residues on the prover's device;
``commit_key_from_arrays`` builds one from the JAX package's digit-plane
arrays instead, so the compute path can be checked apart from the
AES/CRS path.

Commitments and proofs are public: they keep the JAX package's layout,
16-bit digit planes ``[2, L, ...]`` (int64, on the host), and its bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..csprng import UniformSampler
from ..ops import mac_matmul
from ..rings.rns import RnsRing
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
        self._folded = None

    def raw_bytes(self) -> bytes:
        """What a transcript binds of the key: its CRS seed (reference
        WriteRawTo, entities.go:75-77)."""
        if self.crs is None:
            raise ValueError(
                "this CommitKey was built from arrays without its CRS bytes "
                "and cannot bind a transcript: pass crs= to "
                "commit_key_from_arrays")
        return self.crs

    def folded(self, ring_q, ring_q_out):
        """The key as MAC planes (ops/mac_matmul.py), folded once per key
        and shared by the provers and verifiers that hold it:
        ((planes, corr) of [In | MLWE] over ring_q, (planes, corr) of Out
        over ring_q_out)."""
        if self._folded is None:
            self._folded = (
                mac_matmul.folded(ring_q, torch.cat([self.In, self.MLWE], dim=2)),
                mac_matmul.folded(ring_q_out, self.Out))
        return self._folded


def commit_key_from_arrays(params: Parameters, In, MLWE, Out,
                           device=None, crs: bytes | None = None) -> CommitKey:
    """A CommitKey from the JAX package's key arrays (digit planes
    [2, L, ...] with 16-bit digits).  ``crs`` is the seed the arrays were
    expanded from; without it the key commits but ``evaluate`` and
    ``verify`` raise, because they bind the key by its CRS bytes."""
    ck = object.__new__(CommitKey)
    ck.crs = None if crs is None else bytes(crs)
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

    def raw_bytes(self) -> bytes:
        return self.params.ring_q_out.to_bytes(self.value)

    def to_bytes(self) -> bytes:
        """Canonical bytes (the JAX package's ``Commitment.to_bytes``)."""
        return self.raw_bytes()

    @classmethod
    def from_bytes(cls, params: Parameters, data: bytes) -> "Commitment":
        ring = params.ring_q_out
        return cls(params, _planes_from_bytes(
            data, (ring.L, params.out_msis_rank, ring.d)))


def _planes_from_bytes(data: bytes, shape) -> torch.Tensor:
    """Little-endian uint64 words -> digit planes [2, *shape]."""
    if len(data) != 8 * int(np.prod(shape)):
        raise ValueError("byte length mismatch")
    return RnsRing.from_u64(np.frombuffer(data, dtype="<u8").reshape(shape))


class Opening:
    """Commitment opening (reference entities.go:102-137).  Its Encode and
    MLWE tensors are deterministic NTT images of the signed encode
    coefficients and noise, so the opening keeps those compact ``seeds``
    (e_i64 [B, R, d], noise [B, K, d], int64, on the prover's device)
    beside the inner commitment ``in_commit`` (digit planes
    [2, LO, dcmp, d]); the evaluating prover recomputes the tensors from
    the seeds (embed, MForm, NTT), and batched evaluation streams the
    seeds in chunks and never holds an opening's tensors whole."""

    def __init__(self, params: Parameters, in_commit: torch.Tensor, seeds):
        self.params = params
        self.in_commit = in_commit
        self.seeds = seeds


class Proof:
    """Evaluation proof (reference entities.go:139-179): digit planes on
    the host,

    in_commit    [2, LO, dcmp, d]  over ring_q_out
    partial      [2, L, cols, d]   over ring_q
    partial_mask [2, L, d]
    encode       [2, L, rows, d]
    mlwe         [2, L, mlweRank + inMSISRank, d]
    """

    FIELDS = ("in_commit", "partial", "partial_mask", "encode", "mlwe")

    def __init__(self, in_commit, partial, partial_mask, encode, mlwe):
        self.in_commit = in_commit
        self.partial = partial
        self.partial_mask = partial_mask
        self.encode = encode
        self.mlwe = mlwe

    @staticmethod
    def layout(params: Parameters) -> dict:
        """Field -> (ring, residue shape [L, ...])."""
        p = params
        q, qo, d = p.ring_q, p.ring_q_out, p.degree
        return {"in_commit": (qo, (qo.L, p.in_com_dcmp_len, d)),
                "partial": (q, (q.L, p.cols, d)),
                "partial_mask": (q, (q.L, d)),
                "encode": (q, (q.L, p.rows, d)),
                "mlwe": (q, (q.L, p.mlwe_rank + p.in_msis_rank, d))}

    def to_bytes(self, params: Parameters) -> bytes:
        lay = self.layout(params)
        return b"".join(lay[f][0].to_bytes(getattr(self, f))
                        for f in self.FIELDS)

    @classmethod
    def from_bytes(cls, params: Parameters, data: bytes) -> "Proof":
        lay = cls.layout(params)
        fields, off = [], 0
        for f in cls.FIELDS:
            shape = lay[f][1]
            n = 8 * int(np.prod(shape))
            fields.append(_planes_from_bytes(data[off:off + n], shape))
            off += n
        if off != len(data):
            raise ValueError("proof byte length mismatch")
        return cls(*fields)
