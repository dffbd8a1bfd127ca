"""Exact matmul NTT for the d = 256 RNS rings of the commitment.

The negacyclic NTT of degree d is a [d, d] linear map per prime; with the
Montgomery factor (ntt∘mform) or R^-1 and 1/d (intt∘imform) folded in, one
transform is one integer product:

* residues x < 2^32 split into 4 byte planes offset by -128 (int8),
  stacked along the contraction axis (depth 4d);
* the map M is expanded as F[(a, j), (b, e)] = ((2^8a * M[j, e] mod q)
  >> 7b) & 127, so F fits in int8;
* T = x_planes @ F, plus the constant correction 128 * colsum(F): true
  plane sums < 255 * 127 * 4d < 2^27;
* y = sum_b 2^7b * T_b mod q.

On a CUDA tensor ``MatmulNTT`` launches the hand-written kernel
(csrc/ntt_mform.cu); on a CPU tensor it runs ``ntt_mform_plain`` (byte
split, float64 matmul, integer recombine).  Both equal the JAX package's
matmul and Pallas NTTs bit for bit (tests/test_torch_ntt.py).

The kernel is bound by operations (int8 tensor cores; at the commit's
encode shape 1.3e11 multiply-adds against 0.2 GB), so its design is about
operand re-reads.  It takes the contraction index as k = 4*j + a, which
makes the bytes of a row of int32 residues, in memory order, the left
operand: no byte split, the rows go from device memory into shared memory
by TMA.  ``wgmma`` multiplies u8 by s8, so the bytes enter unsigned and the
-128 offset and its correction column drop out of the same integer sums.
The map is kept in the matching layout (``_Map.planes_k``, built here once
per ring).  A block keeps one prime's 32-column slice of the map, all five
planes (160 KB), resident in shared memory and walks many 64-row tiles, one
``wgmma`` m64n160k32 per 32 bytes of k; the five plane sums of an output
meet in one thread, which recombines them and reduces mod q without a
division (``barrett_mu``, ``barrett_reduce``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..fields.spec import FieldSpec
from . import ntt as nttmod
from .mac_matmul import IN_PLANES, P7, PMAX, SHIFT, byte_planes, \
    recombine_mod_q

MAX_D = 256


def _build_maps(primes, d: int):
    """Forward map ntt∘mform and inverse map intt∘imform as exact
    integer matrices [L, d, d] (uint64), out[i] = sum_j x[j] * M[j, i]."""
    br = nttmod.bit_reverse_permutation(d)
    R = 1 << 32
    fwd = np.zeros((len(primes), d, d), dtype=np.uint64)
    inv = np.zeros((len(primes), d, d), dtype=np.uint64)
    for l, q in enumerate(primes):
        psi = FieldSpec(p=q, b=q - 1, k=1).find_generator(d, True)
        psi_inv = pow(psi, -1, q)
        n_inv = pow(d, -1, q)
        r_inv = pow(R, -1, q)
        e = (2 * br + 1) % (2 * d)
        pw = np.ones(2 * d, dtype=np.uint64)
        pwi = np.ones(2 * d, dtype=np.uint64)
        for t in range(1, 2 * d):
            pw[t] = pw[t - 1] * psi % q
            pwi[t] = pwi[t - 1] * psi_inv % q
        j_idx = np.arange(d, dtype=np.uint64)
        for i in range(d):
            texp = ((j_idx * np.uint64(e[i])) % np.uint64(2 * d)).astype(np.int64)
            fwd[l, :, i] = pw[texp] * np.uint64(R % q) % np.uint64(q)
            inv[l, i, :] = pwi[texp] * np.uint64(n_inv * r_inv % q) % np.uint64(q)
    return fwd, inv


def _split_planes_i8(M: np.ndarray, primes):
    """[L, d, d] map -> int8 planes [L, IN_PLANES*d, P7*d] with
    planes[l, a*d + j, b*d + e] = ((2^8a * M[l,j,e] mod q) >> 7b) & 127,
    and the correction 128 * colsum as int32 [L, P7*d]."""
    L, d, _ = M.shape
    qs = np.array(primes, dtype=np.uint64).reshape(L, 1, 1)
    out = np.zeros((L, IN_PLANES * d, P7 * d), dtype=np.int8)
    for a in range(IN_PLANES):
        Ma = (M << np.uint64(8 * a)) % qs
        for b in range(P7):
            out[:, a * d:(a + 1) * d, b * d:(b + 1) * d] = \
                ((Ma >> np.uint64(SHIFT * b)) & np.uint64(PMAX)).astype(np.int8)
    corr = (128 * out.astype(np.int64).sum(axis=1)).astype(np.int32)
    return out, corr


def kernel_layout(planes: np.ndarray) -> np.ndarray:
    """The map as the kernel reads it: [L, 5d, 4d] with the contraction
    index last and reordered to k = 4*j + a, so that the bytes of a row of
    int32 residues, in memory order, are the matching operand.
    planes_k[l, n, 4*j + a] = planes[l, a*d + j, n]."""
    L, kd, nd = planes.shape
    d = kd // IN_PLANES
    return np.ascontiguousarray(
        planes.reshape(L, IN_PLANES, d, nd).transpose(0, 3, 2, 1)
    ).reshape(L, nd, kd)


def planes_from_kernel_layout(planes_k: np.ndarray) -> np.ndarray:
    """Inverse of :func:`kernel_layout`."""
    L, nd, kd = planes_k.shape
    d = kd // IN_PLANES
    return np.ascontiguousarray(
        planes_k.reshape(L, nd, d, IN_PLANES).transpose(0, 3, 2, 1)
    ).reshape(L, kd, nd)


class _Map:
    """One direction's tables on the ring's device."""

    def __init__(self, planes: np.ndarray, corr: np.ndarray, mu: np.ndarray,
                 device):
        self.planes = torch.from_numpy(planes).to(device)       # [L, 4d, 5d]
        self.planes_k = torch.from_numpy(kernel_layout(planes)).to(device)
        self.corr = torch.from_numpy(corr).to(device)           # [L, 5d]
        self.mu = torch.from_numpy(mu).to(device)               # [L] Barrett
        self._planes_f64 = None

    @property
    def planes_f64(self) -> torch.Tensor:
        if self._planes_f64 is None:
            self._planes_f64 = self.planes.to(torch.float64)
        return self._planes_f64


def ntt_mform_plain(v: torch.Tensor, m: _Map, q: torch.Tensor) -> torch.Tensor:
    """Plain version of the NTT kernel: residues int32 [L, n, d] ->
    int32 [L, n, d] = (map @ v) mod q, as byte split, float64 matmul
    (exact: every partial sum < 2^27) and integer recombine.  The same
    function with the inverse map is intt∘imform."""
    d = v.shape[-1]
    xa = byte_planes(v, dim=2)                                 # [L, n, 4d]
    t = torch.bmm(xa, m.planes_f64).to(torch.int64)            # [L, n, 5d]
    t = t + m.corr[:, None, :].to(torch.int64)
    return recombine_mod_q(q, t, d)


BARRETT_WIDE = 1 << 24   # above it the quotient of s < 2^56 fits 32 bits


def barrett_mu(primes) -> np.ndarray:
    """The kernel's division-free reduction constant per prime, as the
    int64 bit pattern of a u64: floor(2^88 / q) for q > 2^24, else
    floor(2^64 / q).  See :func:`barrett_reduce`."""
    return np.array([(1 << (88 if int(q) > BARRETT_WIDE else 64)) // int(q)
                     for q in primes], dtype=np.uint64).view(np.int64)


def barrett_reduce(s: np.ndarray, q: int, mu: int) -> np.ndarray:
    """What the kernel's epilogue computes, step for step, on uint64 sums
    s < 2^56: s mod q with no division.  For q > 2^24,
    qhat = (floor(s / 2^24) * mu) >> 64 as a 32 x 64-bit product; below,
    qhat = (s * mu) >> 64 in full.  Either is floor(s / q) or one less, so
    r = s - qhat * q (mod 2^32) < 2q and one conditional subtraction
    remains.  Every step is done in 32-bit halves as the card does it."""
    u64, m32 = np.uint64, np.uint64(0xFFFFFFFF)
    s = s.astype(u64)
    mu = u64(mu & ((1 << 64) - 1))
    m0, m1 = mu & m32, mu >> u64(32)
    if q > BARRETT_WIDE:
        s24 = (s >> u64(24)) & m32
        w = s24 * m1 + ((s24 * m0) >> u64(32))        # < 2^64
        qhat = w >> u64(32)
    else:
        s0, s1 = s & m32, s >> u64(32)
        mid = ((s0 * m0) >> u64(32)) + ((s0 * m1) & m32) + ((s1 * m0) & m32)
        qhat = (s1 * m1 + ((s0 * m1) >> u64(32)) + ((s1 * m0) >> u64(32))
                + (mid >> u64(32))) & m32
    r = ((s & m32) - ((qhat & m32) * u64(q) & m32)) & m32
    rq = (r - u64(q)) & m32
    return np.minimum(r, rq)


def ntt_mform_cuda(v: torch.Tensor, m: _Map, q32: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (csrc/ntt_mform.cu) on residues int32 [L, n, d],
    d = 256, on the card.  One launch for all L primes."""
    L, n, d = v.shape
    backend.require(v, torch.int32, name="v")
    backend.require(m.planes_k, torch.int8, (L, P7 * d, IN_PLANES * d),
                    name="planes_k")
    backend.require(q32, torch.int32, (L,), name="q")
    backend.require(m.mu, torch.int64, (L,), name="mu")
    if d != MAX_D or not v.is_cuda:
        raise ValueError("ntt kernel: expected int32 [L, n, 256] on the card")
    if n == 0:
        return torch.empty_like(v)
    out = torch.empty_like(v)
    err = backend.lib().ringo_ntt_mform(
        v.data_ptr(), m.planes_k.data_ptr(), q32.data_ptr(),
        m.mu.data_ptr(), out.data_ptr(), L, n, backend.stream_ptr(v))
    backend.check(err, "ntt_mform")
    backend.LAUNCHES["ntt"] += 1
    return out


class MatmulNTT:
    """Fused ntt∘mform / intt∘imform for one ring: the kernel on the card,
    the plain version on the CPU, for every row count."""

    def __init__(self, ring):
        if ring.d != MAX_D:
            raise ValueError(f"matmul NTT requires d == {MAX_D}")
        self.ring = ring
        fwd, inv = _build_maps(ring.primes, ring.d)
        mu = barrett_mu(ring.primes)
        self.fwd = _Map(*_split_planes_i8(fwd, ring.primes), mu, ring.device)
        self.inv = _Map(*_split_planes_i8(inv, ring.primes), mu, ring.device)
        self.q32 = ring.q.to(torch.int32)

    def _apply(self, m: _Map, x: torch.Tensor) -> torch.Tensor:
        L, d = self.ring.L, self.ring.d
        v = x.reshape(L, -1, d).contiguous()
        if v.is_cuda:
            out = ntt_mform_cuda(v, m, self.q32)
        else:
            out = ntt_mform_plain(v, m, self.ring.q)
        return out.reshape(x.shape)

    def ntt_mform(self, x: torch.Tensor) -> torch.Tensor:
        """ntt(mform(x)) for plain residues int32 [L, *lead, d]."""
        return self._apply(self.fwd, x)

    def intt_imform(self, x: torch.Tensor) -> torch.Tensor:
        """intt(imform(x)) for NTT/Montgomery-domain residues."""
        return self._apply(self.inv, x)
