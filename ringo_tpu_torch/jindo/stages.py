"""The device stages of the Jindo prover as plain functions on tensors.

Each function takes the rings it computes over as arguments: the
prover's own rings (``Prover.raw_stages``), or rings of a subset of their
primes and key slices of a subset of the MAC rows (the sharded programs
of ringo_tpu_torch/parallel), so that one implementation serves both.
Residues are int32 ``[L, ...]`` (rings/rns.py); seeds are signed int64.

* ``seeds_encode``: embed, MForm and NTT of an opening's seeds;
* ``encode_mac``: the encode NTTs, the inner Ajtai MAC and its inverse
  NTT (reference jindo/prover.go:45-157);
* ``dcmp_order``, ``outer_mac``, ``finalize``: the outer commitment after
  the inner CRT cutoff (prover.go:159-202);
* ``partial``, ``response``: the evaluation's MACs (prover.go:275-316);
* ``combine``, ``combine_seeds``: the challenge combination of a batch of
  openings (prover.go:230-268).

Everything is exact integer arithmetic; per item the results equal the
JAX package's stage functions bit for bit
(tests/test_torch_stages.py).
"""

from __future__ import annotations

import torch

from ..ops import mac_matmul
from ..utils import profiling


def seeds_encode(ring, e_i64, noise):
    """Encode / MLWE tensors of openings from their seeds (embed, MForm,
    NTT): signed [*lead, d] -> residues [L, *lead, d]."""
    return (ring.ntt_mform(ring.embed_int64(e_i64)),
            ring.ntt_mform(ring.embed_int64(noise)))


def encode_mac(params, ring, e_i64, noise, pk_in, rows=None):
    """Encode NTTs, inner Ajtai MAC (n-axis t*B) and inverse NTT of t
    commitments: e_i64 [t, B, R, d], noise [t, B, K, d] -> (enc
    [L, t, B, R, d], mlwe [L, t, B, K, d], inner commitments [L, J', t*B,
    d] in the coefficient domain).  ``rows`` (an index tensor into the J
    inner MSIS rows, default all of them) picks the rows computed;
    ``pk_in`` is the folded key of those rows over ``ring``'s primes
    (``mac_matmul.key_slice``)."""
    p = params
    t, B, d = e_i64.shape[0], p.cols + 1, p.degree
    enc, mlwe = seeds_encode(ring, e_i64, noise)
    x_all = torch.cat([enc.permute(0, 3, 1, 2, 4),
                       mlwe[:, :, :, :p.mlwe_rank].permute(0, 3, 1, 2, 4)],
                      dim=1).reshape(ring.L, -1, t * B, d)  # [L, KK, t*B, d]
    com = mac_matmul.mod_mac(ring, pk_in, x_all)           # [L, J', t*B, d]
    tail = mlwe[:, :, :, p.mlwe_rank:]
    if rows is not None:
        tail = tail[:, :, :, rows]
    tail = tail.permute(0, 3, 1, 2, 4).reshape(ring.L, -1, t * B, d)
    return enc, mlwe, ring.intt_imform(ring.add(com, tail))


def dcmp_order(params, ic, t: int):
    """Cut-off inner commitments [LO, J, t*B, d] -> the decomposed
    vectors [LO, t*dcmp, d], dcmp index b*J + j (prover.go:176)."""
    p = params
    LO, J, d = ic.shape[0], p.in_msis_rank, p.degree
    return ic.reshape(LO, J, t, p.cols + 1, d).permute(0, 2, 3, 1, 4
                                                       ).reshape(LO, -1, d)


def outer_mac(params, ring_out, ic, pk_out):
    """Outer NTT, MAC and inverse NTT: ic plain residues [LO, t*dcmp, d]
    -> (ic_ntt [LO, t, dcmp, d], acc [LO, outR', t, d] in the coefficient
    domain), outR' the rows of ``pk_out``."""
    LO, d = ring_out.L, params.degree
    ic_ntt = ring_out.ntt_mform(ic).reshape(LO, -1, params.in_com_dcmp_len, d)
    acc = mac_matmul.mod_mac(ring_out, pk_out, ic_ntt.transpose(1, 2))
    return ic_ntt, ring_out.intt_imform(acc)


def finalize(ring_out, crt_out, acc):
    """Outer CRT cutoff and the final NTT: [LO, outR', t, d]."""
    return ring_out.ntt_mform(crt_out(acc))


def commit_core(params, ring, ring_out, crt_in, crt_out, e_i64, noise,
                pk_in, pk_out):
    """The whole commit after sampling, on one device: e_i64 [*lead, B,
    R, d], noise [*lead, B, K, d] (lead empty or (t,)) -> (enc [*lead, L,
    B, R, d], mlwe [*lead, L, B, K, d], ic_ntt [*lead, LO, dcmp, d], outer
    [*lead, LO, outR, d]) residues (reference ``commit_core``,
    ringo_tpu/jindo/prover.py:233)."""
    single = e_i64.dim() == 3
    if single:
        e_i64, noise = e_i64[None], noise[None]
    t = e_i64.shape[0]
    with profiling.span("jindo.commit.encode_mac"):
        enc, mlwe, com = encode_mac(params, ring, e_i64, noise, pk_in)
    with profiling.span("jindo.commit.outer"):
        ic_ntt, acc = outer_mac(params, ring_out,
                                dcmp_order(params, crt_in(com), t), pk_out)
        outer = finalize(ring_out, crt_out, acc)
    out = (enc.transpose(0, 1), mlwe.transpose(0, 1), ic_ntt.transpose(0, 1),
           outer.permute(2, 0, 1, 3))
    return tuple(o[0] for o in out) if single else out


def partial(ring, left_ecd, enc):
    """Partial products sum_j left_j * Encode[:, j] (reference
    prover.go:275-294), a MAC over the rows axis: left_ecd [L, R, d],
    enc [L, B, R, d] -> [L, B, d]."""
    lp = mac_matmul.folded(ring, left_ecd[:, None])
    return mac_matmul.mod_mac(ring, lp, enc.transpose(1, 2))[:, 0]


def response(ring, cols: int, chals, enc, mlwe):
    """Responses: the mask column plus sum_j chal_j * column_j (reference
    prover.go:296-316), MACs over the cols axis: chals [L, cols, d] ->
    (resp_e [L, R, d], resp_m [L, K, d])."""
    cp = mac_matmul.folded(ring, chals[:, None])
    te = mac_matmul.mod_mac(ring, cp, enc[:, :cols])
    tm = mac_matmul.mod_mac(ring, cp, mlwe[:, :cols])
    return ring.add(enc[:, cols], te[:, 0]), ring.add(mlwe[:, cols], tm[:, 0])


def _fold(rg, x, b):
    """sum over the opening axis 1 of x * b, mod q."""
    s = rg.mul_mont(x, b).to(torch.int64).sum(dim=1)
    return (s % rg._col(rg.q, s.dim())).to(torch.int32)


def combine(ring, ring_out, ics, encs, mlwes, bos, bqs):
    """Challenge combination sum_i b_i * opening_i of t materialised
    openings: ics [t, LO, dcmp, d], encs [t, L, B, R, d], mlwes [t, L, B,
    K, d], bos [t, LO, d], bqs [t, L, d] -> (ic [LO, dcmp, d], enc
    [L, B, R, d], mlwe [L, B, K, d]).  Sums of canonical residues are
    exact in int64 and mod-add is associative: any split of the openings
    gives the same tensors."""
    bq = bqs.transpose(0, 1)[:, :, None, None, :]
    return (_fold(ring_out, ics.transpose(0, 1),
                  bos.transpose(0, 1)[:, :, None, :]),
            _fold(ring, encs.transpose(0, 1), bq),
            _fold(ring, mlwes.transpose(0, 1), bq))


def combine_seeds(ring, ring_out, e_all, noise_all, ics, bos, bqs,
                  chunk: int):
    """``combine`` of t openings given by their seeds (e_all [t, B, R, d],
    noise_all [t, B, K, d]), re-encoded ``chunk`` at a time, one batched
    NTT each for Encode and MLWE."""
    acc = None
    for c0 in range(0, e_all.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        enc, ml = seeds_encode(ring, e_all[sl], noise_all[sl])
        part = combine(ring, ring_out, ics[sl], enc.transpose(0, 1),
                       ml.transpose(0, 1), bos[sl], bqs[sl])
        acc = part if acc is None else (
            ring_out.add(acc[0], part[0]), ring.add(acc[1], part[1]),
            ring.add(acc[2], part[2]))
    return acc
