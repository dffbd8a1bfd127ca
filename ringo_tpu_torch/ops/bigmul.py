"""Wide modular multiplication in the big prime field, on digit planes.

Values are plain (non-Montgomery) 16-bit digit planes ``[w, ...]`` in int64
lanes, as in fields/limb.py.  A product is

1. a schoolbook convolution of digit columns with lazy carries: a column
   sum stays below 2 * w * 2^16 < 2^23 for w <= 64, so nothing is carried
   until one final ripple;
2. a Barrett reduction with mu = floor(B^(2w) / p), B = 2^16: two more
   convolutions and two conditional subtractions, no data-dependent loop.

Everything is elementwise over the trailing axes and exact, so the results
equal ``ringo_tpu.ops.bigmul`` digit for digit (tests/test_torch_bigmul.py);
the JAX package's ``lax.scan``s over the digit count are Python loops here.
"""

from __future__ import annotations

import torch

from ..fields import limb
from ..fields.spec import DIGIT_BITS, DIGIT_MASK, FieldSpec


def _digits(x: int, w: int) -> list[int]:
    return [(x >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(w)]


def _const(digits: list[int], like: torch.Tensor) -> torch.Tensor:
    """Constant digits -> [len, 1, ...] broadcastable against ``like``."""
    return torch.tensor(digits, dtype=torch.int64, device=like.device
                        ).reshape(len(digits), *([1] * (like.dim() - 1)))


def _pad(z: torch.Tensor, w: int) -> torch.Tensor:
    """Zero digit planes appended up to w."""
    if z.shape[0] >= w:
        return z
    return torch.cat([z, z.new_zeros((w - z.shape[0],) + tuple(z.shape[1:]))])


def conv_columns(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Digit convolution with lazy carries: x [wx, ...], y [wy, ...] ->
    column sums [wx + wy, ...] (each < 2^23 for wx, wy <= 64), not
    carry-normalised."""
    wx, wy = x.shape[0], y.shape[0]
    shape = torch.broadcast_shapes(x.shape[1:], y.shape[1:])
    cols = torch.zeros((wx + wy,) + tuple(shape), dtype=torch.int64,
                       device=x.device)
    for a in range(wx):
        t = x[a] * y                                   # [wy, ...] < 2^32
        cols[a:a + wy] += t & DIGIT_MASK
        cols[a + 1:a + wy + 1] += t >> DIGIT_BITS
    return cols


def ripple(cols: torch.Tensor, out_w: int | None = None) -> torch.Tensor:
    """Carry-normalise column sums -> 16-bit digits [out_w, ...]."""
    w = cols.shape[0] if out_w is None else out_w
    out = []
    c = torch.zeros_like(cols[0])
    for j in range(w):
        s = cols[j] + c if j < cols.shape[0] else c
        out.append(s & DIGIT_MASK)
        c = s >> DIGIT_BITS
    return torch.stack(out)


def _cond_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b if a >= b else a, on digit planes of the same length."""
    diff, borrow = limb._sub_borrow(limb._unstack(a), limb._unstack(b))
    return torch.where(borrow != 0, a, torch.stack(diff))


class BigMul:
    """Plain-representation arithmetic mod p for one field."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.w = w = spec.w
        B = 1 << DIGIT_BITS
        self.mu_digits = _digits(B ** (2 * w) // spec.p, w + 2)
        self.p_digits = _digits(spec.p, w)
        self.p_ext = _digits(spec.p, w + 2)
        # B^(2w-1) mod p: folds the digits of reduce_cols above B^(2w-1)
        self.bs_digits = _digits(pow(B, 2 * w - 1, spec.p), w)

    def mul_mod(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(x * y) mod p for plain digit planes [w, ...]."""
        return self._barrett(ripple(conv_columns(x, y), 2 * self.w + 1))

    def reduce_cols(self, cols: torch.Tensor) -> torch.Tensor:
        """Lazy column sums [m, ...] (base-2^16 positional, each column
        < 2^23) of a value z < 2^16 * p^2 -> z mod p digit planes [w, ...].

        z may exceed the Barrett range B^(2w): the digits above B^(2w-1)
        (a value < 2^32) are folded back with B^(2w-1) mod p, which leaves
        z' < 2 * B^(2w-1)."""
        s = 2 * self.w - 1
        z = ripple(cols, cols.shape[0] + 1)
        if z.shape[0] <= s:
            return self._barrett(z)
        fold = conv_columns(z[s:], _const(self.bs_digits, z))
        m = max(s, fold.shape[0])
        return self._barrett(ripple(_pad(z[:s], m) + _pad(fold, m),
                                    2 * self.w + 1))

    def _barrett(self, z: torch.Tensor) -> torch.Tensor:
        """Digits of z < B^(2w) -> z mod p (HAC 14.42):
        q_hat = floor(floor(z / B^(w-1)) * mu / B^(w+1)), r = z - q_hat * p
        < 3p, two conditional subtractions."""
        w = self.w
        z = _pad(z, 2 * w + 1)
        zh = z[w - 1:2 * w + 1]                         # [w+2, ...]
        q_full = ripple(conv_columns(zh, _const(self.mu_digits, zh)))
        q_hat = q_full[w + 1:2 * w + 2]                 # [w+1, ...]
        qp = ripple(conv_columns(q_hat, _const(self.p_digits, q_hat)), w + 2)
        r, _ = limb._sub_borrow(limb._unstack(z[:w + 2]), limb._unstack(qp))
        r = torch.stack(r)
        p_b = _const(self.p_ext, r)
        r = _cond_sub(r, p_b)
        r = _cond_sub(r, p_b)
        return r[:w]
