"""Fixed-limb modular arithmetic on 16-bit digit planes, in PyTorch.

Values are tensors ``[w, ...]`` of 16-bit digits, little-endian, held in
``int64`` lanes (PyTorch has no ``+ - >> <`` for ``uint32`` on the CPU).
Every product is 16x16 -> 32 bits and every sum stays below 2^34, so the
lanes never overflow.  Where the JAX engine detects a borrow through u32
wraparound (``(s >> 31) & 1``), a lane here simply goes negative, so the
borrow is a sign test.

Counterpart of ``ringo_tpu.fields.limb``; the results are bit-identical
(tests/test_torch_limb.py).
"""

from __future__ import annotations

import numpy as np
import torch

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
    """(a + b) mod q for normalized inputs."""
    t, carry = _add_carry(_unstack(a), _unstack(b))
    return torch.stack(_cond_sub_q(t, carry, _unstack(_as_tensor(q, a))))


def sub(a, b, q):
    """(a - b) mod q for normalized inputs."""
    diff, borrow = _sub_borrow(_unstack(a), _unstack(b))
    fixed, _ = _add_carry(diff, _unstack(_as_tensor(q, a)))
    return torch.stack(_select(borrow != 0, fixed, diff))


def neg(a, q):
    """(-a) mod q."""
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
    """a >= b as a multi-digit unsigned compare."""
    _, borrow = _sub_borrow(_unstack(a), _unstack(_as_tensor(b, a)))
    return borrow == 0


def nonzero_idx(mask: torch.Tensor, size: int) -> torch.Tensor:
    """First ``size`` indices of the true lanes of a 1-D mask, padded with
    ``len(mask)``.  A cumsum and a binary search, so it never waits for
    the host (``torch.nonzero`` does)."""
    cs = torch.cumsum(mask.to(torch.int64), 0)
    k = torch.arange(1, size + 1, dtype=torch.int64, device=mask.device)
    return torch.searchsorted(cs, k, side="left")


def mont_mul(a, b, q, qinv16):
    """Montgomery product a*b*R^-1 mod q, R = 2^(16w), by CIOS.

    ``q``: [w, ...] broadcastable digits; ``qinv16``: -q^-1 mod 2^16 as an
    int or a broadcastable tensor."""
    ad = _unstack(a)
    bd = _unstack(_as_tensor(b, a))
    qd = _unstack(_as_tensor(q, a))
    w = len(ad)
    qinv = qinv16 if isinstance(qinv16, int) else _as_tensor(qinv16, a)
    zero = ad[0] * bd[0] * 0
    t = [zero for _ in range(w + 2)]
    for i in range(w):
        c = 0
        for j in range(w):
            s = t[j] + ad[j] * bd[i] + c
            t[j] = s & DIGIT_MASK
            c = s >> DIGIT_BITS
        s = t[w] + c
        t[w] = s & DIGIT_MASK
        t[w + 1] = s >> DIGIT_BITS
        m = (t[0] * qinv) & DIGIT_MASK
        s = t[0] + m * qd[0]
        c = s >> DIGIT_BITS
        for j in range(1, w):
            s = t[j] + m * qd[j] + c
            t[j - 1] = s & DIGIT_MASK
            c = s >> DIGIT_BITS
        s = t[w] + c
        t[w - 1] = s & DIGIT_MASK
        c = s >> DIGIT_BITS
        t[w] = t[w + 1] + c
    return torch.stack(_cond_sub_q(t[:w], t[w], qd))


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
