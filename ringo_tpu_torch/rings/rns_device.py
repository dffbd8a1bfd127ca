"""Exact CRT reconstruction + arithmetic shift + re-embedding on tensors.

The cutoff/rounding step of Jindo commitments (reference
jindo/prover.go:159-176, 186-201: INTT -> big-int CRT -> Rsh -> re-embed),
elementwise over the coefficients:

1. y_l = r_l * t_l mod q_l with t_l = (Q/q_l)^-1 mod q_l, so the CRT sum
   acc = sum_l y_l * (Q/q_l) is below L*Q;
2. acc as 16-bit digit columns (int64 lanes, one carry ripple);
3. acc mod Q by a short ladder of conditional subtractions of Q*2^j;
4. the balanced value v in [-Q/2, Q/2) floor-shifted by ``shift`` bits
   (negative branch: -ceil((Q - acc) / 2^shift));
5. |v| mod each destination prime, then the sign.

All of it is exact integer arithmetic, so it equals the JAX package's
digit-plane version (``ringo_tpu.rings.rns_device.CrtShiftEmbed``) bit for
bit; the JAX ``lax.scan``s over the short digit count are Python loops.
"""

from __future__ import annotations

import torch

from ..fields import limb
from ..fields.spec import DIGIT_BITS, DIGIT_MASK


def _digits_of(x: int, w: int) -> list[int]:
    return [(x >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(w)]


def norm_cols_to_int(cols) -> int:
    """Host combine of ``CrtShiftEmbed.norm_sq_cols`` output."""
    return sum(int(c) << (DIGIT_BITS * k) for k, c in enumerate(cols))


class CrtShiftEmbed:
    """Tables for ring_src -> (balanced >> shift) -> ring_dst."""

    def __init__(self, ring_src, ring_dst, shift: int):
        self.src = ring_src
        self.dst = ring_dst
        self.shift = shift
        Q = ring_src.modulus
        self.Q = Q
        L = ring_src.L
        W = -(-Q.bit_length() // DIGIT_BITS) + 1  # acc < L*Q: log2(L) bits more
        self.W = W
        dev = ring_src.device
        self.t = torch.tensor([pow(Q // p % p, -1, p) for p in ring_src.primes],
                              dtype=torch.int64, device=dev)
        self.G = [_digits_of(Q // p, W) for p in ring_src.primes]  # [L][W]
        n_red = max(1, (L - 1).bit_length())
        self.q_ladder = [_digits_of(Q << j, W)
                         for j in range(n_red - 1, -1, -1)]
        self.q_digits = _digits_of(Q, W)
        self.q_half = _digits_of(Q >> 1, W)
        self.shift_bias = _digits_of((1 << shift) - 1, W)
        # 2^(16 i) mod q per destination prime: [W][LO]
        self.pw16 = torch.tensor(
            [[(1 << (DIGIT_BITS * i)) % q for q in ring_dst.primes]
             for i in range(W)], dtype=torch.int64, device=dev)

    def balanced_mag(self, res: torch.Tensor):
        """res: plain residues [L, *lead] over ring_src.  Returns (mag,
        is_neg): the balanced value v in [-Q/2, Q/2) as the W digit
        tensors [*lead] of |v| >> shift (rounded toward -inf for v), and
        its sign."""
        L, W = self.src.L, self.W
        r = res.to(torch.int64)
        q = self.src.q.reshape(L, *([1] * (r.dim() - 1)))
        y = r * self.t.reshape(q.shape) % q                   # [L, *lead]
        # 2) acc = sum_l y_l * (Q/q_l) as digit columns, one ripple
        dig = []
        carry = 0
        for j in range(W):
            col = carry
            for l in range(L):
                if self.G[l][j]:
                    col = col + y[l] * self.G[l][j]
            if isinstance(col, int):
                col = torch.zeros_like(y[0]) + col
            dig.append(col & DIGIT_MASK)
            carry = col >> DIGIT_BITS
        # 3) mod Q by the ladder
        for qj in self.q_ladder:
            diff, borrow = limb._sub_borrow(dig, qj)
            dig = [torch.where(borrow != 0, a, b) for a, b in zip(dig, diff)]
        # 4) balanced shift
        stack = torch.stack(dig)
        is_neg = limb.geq(stack, torch.tensor(self.q_half, device=res.device)
                          .reshape(W, *([1] * (stack.dim() - 1))))
        u_neg, _ = limb._sub_borrow([torch.zeros_like(dig[0]) + c
                                     for c in self.q_digits], dig)
        u_neg, _ = limb._add_carry(u_neg, self.shift_bias)
        mag = [torch.where(is_neg, a, b) for a, b in zip(u_neg, dig)]
        return self._shift_right(mag), is_neg

    def norm_sq_cols(self, polys) -> torch.Tensor:
        """Exact sum of the squared balanced coefficients over ``polys``
        (each plain residues [L, *lead] over ring_src) as 2W-1 int64
        columns weighted by 2^(16k): the integer is sum_k cols[k] *
        2^(16k) (``norm_cols_to_int`` on the host).  The exact l2 norm of
        the verifier (reference jindo/verifier.go:262-282); |v|^2 drops
        the sign, so the magnitude digits suffice.

        int64 is exact here and float64 would not be: a digit product is
        below 2^32, a plane pair sums fewer than 2^21 lanes, and a column
        gathers at most W <= 16 pairs from each of at most four polys, so
        every column stays below 2^32 * 2^21 * 2^4 * 2^2 = 2^59."""
        W = self.W
        if W > 16 or len(polys) > 4:
            raise ValueError("norm_sq_cols: int64 columns could overflow")
        acc = None
        for poly in polys:
            mag, _ = self.balanced_mag(poly)
            m = torch.stack(mag).reshape(W, -1)
            if m.shape[1] >= 1 << 21:
                raise ValueError("norm_sq_cols: too many lanes for int64")
            g = (m[:, None, :] * m[None, :, :]).sum(dim=2)     # [W, W]
            acc = g if acc is None else acc + g
        # column k gathers the anti-diagonal i + j = k
        ar = torch.arange(W, device=acc.device)
        k = (ar[:, None] + ar[None, :]).reshape(-1)
        return torch.zeros(2 * W - 1, dtype=torch.int64, device=acc.device
                           ).index_add_(0, k, acc.reshape(-1))

    def _shift_right(self, dig):
        W = self.W
        ds, b = divmod(self.shift, DIGIT_BITS)
        zero = torch.zeros_like(dig[0])
        out = []
        for j in range(W):
            lo = dig[j + ds] if j + ds < W else zero
            if b == 0:
                out.append(lo)
            else:
                hi = dig[j + ds + 1] if j + ds + 1 < W else zero
                out.append(((lo >> b) | ((hi << (DIGIT_BITS - b))
                                         & DIGIT_MASK)) & DIGIT_MASK)
        return out

    def __call__(self, res: torch.Tensor) -> torch.Tensor:
        """Plain residues [L, *lead] over ring_src -> plain residues
        [LO, *lead] over ring_dst."""
        mag, is_neg = self.balanced_mag(res)
        LO = self.dst.L
        nl = res.dim() - 1
        acc = None
        for i, m in enumerate(mag):   # each term < 2^16 * 2^31
            term = m[None] * self.pw16[i].reshape(LO, *([1] * nl))
            acc = term if acc is None else acc + term
        q = self.dst.q.reshape(LO, *([1] * nl))
        acc = acc % q
        neg = torch.where(acc == 0, acc, q - acc)
        return torch.where(is_neg[None], neg, acc).to(torch.int32)
