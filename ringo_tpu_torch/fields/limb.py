"""Fixed-limb modular arithmetic on 16-bit digit planes, in PyTorch.

Values are tensors ``[w, ...]`` of 16-bit digits, little-endian, held in
``int64`` lanes (PyTorch has no ``+ - >> <`` for ``uint32`` on the CPU).
Every product is 16x16 -> 32 bits and every sum stays below 2^34, so the
lanes never overflow.  Where the JAX engine detects a borrow through u32
wraparound (``(s >> 31) & 1``), a lane here simply goes negative, so the
borrow is a sign test.

Counterpart of ``ringo_tpu.fields.limb``; the results are bit-identical
(tests/test_torch_limb.py).  On the card ``add``, ``sub``, ``neg`` and
``geq`` are one launch each of csrc/bigfield.cu (fields/bigfield.py); the
``*_plain`` functions are what the CPU runs and what the kernel is held
against.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bigfield
from .spec import DIGIT_BITS, DIGIT_MASK


def _unstack(a):
    return [a[j] for j in range(a.shape[0])]


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=like.device)


def _sub_borrow(a, b):
    """a - b digitwise; returns (diff digits, final borrow in {0, 1})."""
    borrow = 0
    out = []
    for x, y in zip(a, b):
        s = x - y - borrow
        out.append(s & DIGIT_MASK)
        borrow = (s < 0).to(torch.int64)
    return out, borrow


def _add_carry(a, b):
    carry = 0
    out = []
    for x, y in zip(a, b):
        s = x + y + carry
        out.append(s & DIGIT_MASK)
        carry = s >> DIGIT_BITS
    return out, carry


def _select(cond, a, b):
    return [torch.where(cond, x, y) for x, y in zip(a, b)]


def _cond_sub_q(t, top, q):
    """Reduce t (+ top * 2^(16w)) < 2q into [0, q)."""
    diff, borrow = _sub_borrow(t, q)
    use_diff = (top != 0) | (borrow == 0)
    return _select(use_diff, diff, t)


def add(a, b, q):
    """(a + b) mod q for normalized inputs: one launch of csrc/bigfield.cu
    on the card, the plain version on the CPU."""
    if bigfield.on_card(a):
        return bigfield.add_cuda(a, b, _as_tensor(q, a))
    return add_plain(a, b, q)


def add_plain(a, b, q):
    t, carry = _add_carry(_unstack(a), _unstack(b))
    return torch.stack(_cond_sub_q(t, carry, _unstack(_as_tensor(q, a))))


def sub(a, b, q):
    """(a - b) mod q for normalized inputs (the kernel on the card)."""
    if bigfield.on_card(a):
        return bigfield.sub_cuda(a, b, _as_tensor(q, a))
    return sub_plain(a, b, q)


def sub_plain(a, b, q):
    diff, borrow = _sub_borrow(_unstack(a), _unstack(b))
    fixed, _ = _add_carry(diff, _unstack(_as_tensor(q, a)))
    return torch.stack(_select(borrow != 0, fixed, diff))


def neg(a, q):
    """(-a) mod q (the kernel on the card)."""
    if bigfield.on_card(a):
        return bigfield.neg_cuda(a, _as_tensor(q, a))
    return neg_plain(a, q)


def neg_plain(a, q):
    ad = _unstack(a)
    qd = [d + torch.zeros_like(ad[0]) for d in _unstack(_as_tensor(q, a))]
    diff, _ = _sub_borrow(qd, ad)
    zero = is_zero(a)
    return torch.stack(_select(zero, [torch.zeros_like(d) for d in ad], diff))


def is_zero(a):
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def geq(a, b):
    """a >= b as a multi-digit unsigned compare (the kernel on the card)."""
    if bigfield.on_card(a):
        return bigfield.geq_cuda(a, _as_tensor(b, a))
    return geq_plain(a, b)


def geq_plain(a, b):
    _, borrow = _sub_borrow(_unstack(a), _unstack(_as_tensor(b, a)))
    return borrow == 0


def cmp(a, b):
    """3-way multi-digit unsigned compare: -1 / 0 / +1 as int64
    (reference element Cmp)."""
    return geq(a, b).to(torch.int64) - geq(b, a).to(torch.int64)


def bit_len(a):
    """Bit length of each element (reference element BitLen): position of
    the highest set bit across the digit planes, 0 for zero."""
    out = None
    for j, d in enumerate(_unstack(a)):
        bl = torch.zeros_like(d)
        for b in range(DIGIT_BITS):
            bl = bl + (d >= (1 << b)).to(torch.int64)
        cand = torch.where(d > 0, bl + DIGIT_BITS * j, torch.zeros_like(bl))
        out = cand if out is None else torch.maximum(out, cand)
    return out


def select(cond, a, b):
    """cond ? a : b elementwise over the digit planes (reference element
    Select)."""
    return torch.where(cond, a, b)


def halve(a, q):
    """a / 2 mod q: add q to the odd values, then shift the w+1 digits
    right by one bit (reference element Halve)."""
    ad = _unstack(a)
    qd = [d + torch.zeros_like(ad[0]) for d in _unstack(_as_tensor(q, a))]
    bumped, carry = _add_carry(ad, qd)
    odd = (ad[0] & 1) != 0
    use = _select(odd, bumped, ad) + [torch.where(odd, carry,
                                                  torch.zeros_like(carry))]
    return torch.stack([(use[j] >> 1) | ((use[j + 1] & 1) << (DIGIT_BITS - 1))
                        for j in range(len(ad))])


def nonzero_idx(mask: torch.Tensor, size: int) -> torch.Tensor:
    """First ``size`` indices of the true lanes of a 1-D mask, padded with
    ``len(mask)``.  A cumsum and a binary search, so it never waits for
    the host (``torch.nonzero`` does)."""
    cs = torch.cumsum(mask.to(torch.int64), 0)
    k = torch.arange(1, size + 1, dtype=torch.int64, device=mask.device)
    return torch.searchsorted(cs, k, side="left")


def mont_mul(a, b, q, qinv16):
    """Montgomery product a*b*R^-1 mod q, R = 2^(16w).

    ``q``: [w, ...] broadcastable digits; ``qinv16``: -q^-1 mod 2^16 as an
    int or a broadcastable tensor.  The columns of a*b are summed lazily in
    the int64 lanes (below 2w * 2^32 each), then column i is cleared by
    m_i = t_i * qinv16 mod 2^16 with its carry moved up: the same
    M = -a*b*q^-1 mod R as the reference's CIOS, so the same (a*b + M*q)/R,
    brought into [0, q) by one conditional subtraction.  Each step works
    on all w digits at once, so a product is O(w) tensor operations."""
    bt = _as_tensor(b, a)
    qt = _as_tensor(q, a)
    w = a.shape[0]
    qinv = qinv16 if isinstance(qinv16, int) else _as_tensor(qinv16, a)
    shape = torch.broadcast_shapes(a.shape[1:], bt.shape[1:], qt.shape[1:])
    # the digit axis of b and q in front of the value dims they broadcast to
    bt, qt = (x.reshape(w, *([1] * (len(shape) + 1 - x.dim())), *x.shape[1:])
              for x in (bt, qt))
    t = torch.zeros((2 * w + 1,) + shape, dtype=torch.int64, device=a.device)
    for i in range(w):
        t[i:i + w] += a[i] * bt
    for i in range(w):
        m = (t[i] * qinv) & DIGIT_MASK
        t[i:i + w] += m * qt
        t[i + 1] += t[i] >> DIGIT_BITS
    out, c = [], 0
    for j in range(w, 2 * w + 1):
        s = t[j] + c
        out.append(s & DIGIT_MASK)
        c = s >> DIGIT_BITS
    return torch.stack(_cond_sub_q(out[:w], out[w], _unstack(qt)))


def divmod_small(a, y: int):
    """Long division of digit planes by a small int y (< 2^25): returns
    (quotient digits [w, ...], remainder [...]).  Each step divides
    cur = r * 2^16 + digit < 2^41 in float64 (exact) with a +/-1
    correction of the reciprocal estimate."""
    if y >= (1 << 25):
        raise ValueError(f"divmod_small requires y < 2^25, got {y}")
    ad = _unstack(a)
    yf = float(y)
    inv_y = 1.0 / yf
    r = torch.zeros_like(ad[0], dtype=torch.float64)
    out = [None] * len(ad)
    for j in reversed(range(len(ad))):
        cur = r * 65536.0 + ad[j].to(torch.float64)
        q = torch.floor(cur * inv_y)
        r = cur - q * yf
        q = torch.where(r < 0, q - 1.0, q)
        r = torch.where(r < 0, r + yf, r)
        q = torch.where(r >= yf, q + 1.0, q)
        r = torch.where(r >= yf, r - yf, r)
        out[j] = q.to(torch.int64)
    return torch.stack(out), r.to(torch.int64)


def modsum(a, q, axis: int):
    """Modular sum along ``axis`` by a tree of halving additions, removing
    that axis.  a: [w, ...]; ``axis`` counts value dims (0 = the first dim
    after the digit axis)."""
    ax = axis + 1
    while a.shape[ax] > 1:
        half = a.shape[ax] // 2
        s = add(a.narrow(ax, 0, half), a.narrow(ax, half, half), q)
        if a.shape[ax] % 2:
            s = torch.cat([s, a.narrow(ax, 2 * half, 1)], dim=ax)
        a = s
    return a.select(ax, 0)


# ------------------------------------------------ host <-> digit planes

def ints_to_digits(values, w: int) -> torch.Tensor:
    """Python ints (non-negative, < 2^(16w)) -> int64 [w, N] digit planes."""
    n = len(values)
    nb = 2 * w
    buf = b"".join(int(v).to_bytes(nb, "little") for v in values)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(n, w)
    return torch.from_numpy(np.ascontiguousarray(u16.T).astype(np.int64))


def digits_to_ints(digits: torch.Tensor) -> list[int]:
    """[w, N] digit planes -> Python ints."""
    d = digits.cpu().numpy().reshape(digits.shape[0], -1)
    raw = np.ascontiguousarray(d.T.astype("<u2")).tobytes()
    nb = 2 * d.shape[0]
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
            for i in range(d.shape[1])]


def put_drop(dst: torch.Tensor, idx: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``dst.at[idx].set(val, mode="drop")`` along dim 0: indices >=
    len(dst) (the sentinels of ``nonzero_idx``) are dropped.  They are
    sent to one extra slot that is cut off again, so nothing waits for the
    host.  Real indices must be distinct."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    ext.index_put_((torch.clamp(idx, max=n),), val.to(dst.dtype))
    return ext[:n]
