"""Host tables of the (nega)cyclic NTTs, in exact Python ints.

The conventions are the reference's (math/bigpoly/ntt.go), so that slot
permutations such as the NTT-domain automorphism carry over:

* forward = Cooley-Tukey DIT, natural-order coefficients in, bit-reversed
  evaluations out;
* negacyclic (X^N+1): out[i] = p(psi^(2*br_N(i)+1)) for an order-2N root psi;
* cyclic (X^N-1):     out[i] = p(g^(br_N(i))) for an order-N generator g;
* inverse = Gentleman-Sande, multiplied by N^-1 at the end.

Twiddles are one table T of length N where stage m uses T[m:2m] (the
reference's tw[m+i] layout, ntt.go:67-84,183-192).  The big-field engines
(ops/bigntt.py, ops/bigntt_matmul.py) take their roots from here, the RNS
matmul-NTT (ops/ntt_matmul.py) its bit reversal.

``ntt_fwd`` / ``ntt_inv`` are the stage engine: one Cooley-Tukey or
Gentleman-Sande stage per step over the last axis of a tensor whose first
axis is the plan's lead axis.  A plan brings its twiddles in Montgomery
form (``tw``, ``twinv`` [c, n], ``ninv`` [c]) and its arithmetic (``mul``
a Montgomery product, ``add``, ``sub``).  Two plans use it: ``NTTPlan``,
on 16-bit digit planes [w, ..., n] of one field through ``limb.mont_mul``
(c = w), and the RNS ring's plan (rings/rns.py), on int32 residues
[L, ..., n] through ``RnsRing.mul_mont`` (c = L, one table per prime).
Counterpart of ``ringo_tpu.ops.ntt``; equal outputs
(tests/test_torch_rns_ntt.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import backend
from ..fields import limb
from ..fields.spec import FieldSpec


def bit_reverse_permutation(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


@functools.lru_cache(maxsize=None)
def _tables_host(p: int, b: int, k: int, n: int, negacyclic: bool,
                 generator: int | None = None):
    """(tw, twinv, ninv) as plain ints: tw/twinv length-n lists with stage
    m using tw[m:2m].  ``generator`` overrides the canonical root."""
    spec = FieldSpec(p=p, b=b, k=k)
    if negacyclic:
        g = generator if generator is not None else spec.find_generator(n, True)
        ginv = spec.inverse(g)
        pw, pwinv = [1] * n, [1] * n
        for i in range(1, n):
            pw[i] = pw[i - 1] * g % p
            pwinv[i] = pwinv[i - 1] * ginv % p
        perm = bit_reverse_permutation(n)
        tw, twinv = [pw[0]] * n, [pwinv[0]] * n
        for i in range(n):
            tw[perm[i]] = pw[i]
            twinv[perm[i]] = pwinv[i]
    else:
        g = generator if generator is not None else spec.find_generator(n, False)
        ginv = spec.inverse(g)
        h = n // 2
        pw, pwinv = [1] * h, [1] * h
        for i in range(1, h):
            pw[i] = pw[i - 1] * g % p
            pwinv[i] = pwinv[i - 1] * ginv % p
        perm = bit_reverse_permutation(h) if h > 0 else np.zeros(0, np.int64)
        twref, twinvref = [0] * h, [0] * h
        for i in range(h):
            twref[perm[i]] = pw[i]
            twinvref[perm[i]] = pwinv[i]
        tw, twinv = [1] * n, [1] * n
        m = 1
        while m <= h:
            for i in range(m):
                tw[m + i] = twref[i]
                twinv[m + i] = twinvref[i]
            m <<= 1
    return tw, twinv, spec.inverse(n)


class NTTPlan:
    """Twiddles of the size-n (nega)cyclic NTT over one field, as
    Montgomery digit planes [w, n] on ``device`` (default: the card)."""

    def __init__(self, spec: FieldSpec, n: int, negacyclic: bool,
                 device=None):
        if n & (n - 1):
            raise ValueError("n must be a power of two")
        if (spec.p - 1) % (2 * n) != 0:
            raise ValueError("NTT not supported: 2n must divide p-1")
        self.spec = spec
        self.n = n
        self.negacyclic = negacyclic
        self.device = backend.resolve_device(device)
        tw, twinv, ninv = _tables_host(spec.p, spec.b, spec.k, n, negacyclic)
        R, p, w = spec.R, spec.p, spec.w
        self.tw = limb.ints_to_digits([t * R % p for t in tw], w).to(self.device)
        self.twinv = limb.ints_to_digits([t * R % p for t in twinv],
                                         w).to(self.device)
        self.ninv = limb.ints_to_digits([ninv * R % p], w)[:, 0].to(self.device)
        self.q = limb.ints_to_digits([p], w).to(self.device)      # [w, 1]
        self.qinv16 = spec.qinv16

    def mul(self, a, b):
        return limb.mont_mul(a, b, self.q, self.qinv16)

    def add(self, a, b):
        return limb.add(a, b, self.q)

    def sub(self, a, b):
        return limb.sub(a, b, self.q)


def _stage_table(table: torch.Tensor, m: int, ndim: int) -> torch.Tensor:
    """Stage m's twiddles table[:, m:2m] shaped to broadcast against one
    half [c, *batch, m, t] (``ndim`` dims) of the stage's butterflies."""
    return table[:, m:2 * m].reshape(table.shape[0], *([1] * (ndim - 3)),
                                     m, 1)


def ntt_fwd(plan, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT over the last axis; x shaped [c, *batch, n]."""
    n, shape = plan.n, x.shape
    m = 1
    while m <= n // 2:
        y = x.reshape(*shape[:-1], m, 2, n // (2 * m))
        u, v = y[..., 0, :], y[..., 1, :]
        vw = plan.mul(v, _stage_table(plan.tw, m, u.dim()))
        x = torch.stack([plan.add(u, vw), plan.sub(u, vw)], dim=-2)
        x = x.reshape(shape)
        m <<= 1
    return x


def ntt_inv(plan, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT over the last axis, with the 1/n scaling."""
    n, shape = plan.n, x.shape
    m = n // 2
    while m >= 1:
        y = x.reshape(*shape[:-1], m, 2, n // (2 * m))
        u, v = y[..., 0, :], y[..., 1, :]
        d = plan.mul(plan.sub(u, v), _stage_table(plan.twinv, m, u.dim()))
        x = torch.stack([plan.add(u, v), d], dim=-2).reshape(shape)
        m >>= 1
    ninv = plan.ninv.reshape(plan.ninv.shape[0], *([1] * (x.dim() - 1)))
    return plan.mul(x, ninv)


def aut_ntt_permutation(n: int, idx: int) -> np.ndarray:
    """Slot permutation realising X -> X^idx on negacyclic NTT values:
    slot i reads the slot whose exponent is (2*br(i)+1)*idx mod 2n
    (reference autNTTTo, math/bigpoly/cyclotomic.go:67-82)."""
    br = bit_reverse_permutation(n)
    brinv = np.argsort(br)
    e = (2 * br + 1) * idx % (2 * n)
    return brinv[(e - 1) // 2]


def aut_coeff_maps(n: int, idx: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient-domain X -> X^idx on X^n+1: (dst, sign) with
    out[dst[i]] = sign[i] * in[i] (reference autTo, cyclotomic.go:49-64)."""
    i = np.arange(n)
    j = (i * idx) % (2 * n)
    sign = np.where(j < n, 1, -1).astype(np.int8)
    dst = np.where(j < n, j, j - n)
    return dst, sign
