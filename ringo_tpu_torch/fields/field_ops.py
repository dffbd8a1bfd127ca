"""FieldOps: a FieldSpec bound to the limb engine on one device.

Tensors made here are int64 digit planes [w, ...] in **Montgomery form**
(the reference's goff elements, jindo/internal/zp/element.go:36-46);
Python ints on the host are plain.  Conversions happen only at the
host/device boundary.  Counterpart of ``ringo_tpu.fields.field_ops``; the
same integers (tests/test_torch_field_ops.py).
"""

from __future__ import annotations

import torch

from .. import backend
from . import limb
from .spec import FieldSpec


class FieldOps:
    def __init__(self, spec: FieldSpec, device=None):
        self.spec = spec
        self.w = spec.w
        self.device = backend.resolve_device(device)
        digits = lambda v: limb.ints_to_digits([v], spec.w)[:, 0].to(self.device)
        self.q = digits(spec.p)                 # [w]
        self.r2 = digits(spec.r2_mod_p)
        self.one = digits(1)
        self.qinv16 = spec.qinv16               # python int

    # ---- host <-> device --------------------------------------------------

    def from_ints(self, values) -> torch.Tensor:
        """Plain Python ints -> Montgomery digit planes [w, N]."""
        d = limb.ints_to_digits([int(v) % self.spec.p for v in values], self.w)
        return self.to_mont(d.to(self.device))

    def to_ints(self, digits) -> list[int]:
        """Montgomery digit planes -> plain Python ints."""
        return limb.digits_to_ints(self.from_mont(digits))

    def from_int(self, v: int) -> torch.Tensor:
        return self.from_ints([v])[:, 0]

    def to_int(self, digits) -> int:
        return self.to_ints(digits.reshape(self.w, 1))[0]

    # ---- elementwise ops (Montgomery domain) -------------------------------

    def add(self, a, b):
        return limb.add(a, b, self._bc(a, self.q))

    def sub(self, a, b):
        return limb.sub(a, b, self._bc(a, self.q))

    def neg(self, a):
        return limb.neg(a, self._bc(a, self.q))

    def mul(self, a, b):
        return limb.mont_mul(a, b, self._bc(a, self.q), self.qinv16)

    def to_mont(self, a):
        return self.mul(a, self._bc(a, self.r2))

    def from_mont(self, a):
        return self.mul(a, self._bc(a, self.one))

    def is_zero(self, a):
        return limb.is_zero(a)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros((self.w, *shape), dtype=torch.int64,
                           device=self.device)

    def const(self, v: int, shape) -> torch.Tensor:
        """Montgomery-form constant broadcast to [w, *shape]."""
        spec = self.spec
        d = torch.tensor(spec.to_digits_int(int(v) % spec.p * spec.R % spec.p),
                         dtype=torch.int64, device=self.device)
        return d.reshape(self.w, *([1] * len(shape))).expand(
            self.w, *shape).contiguous()

    def double(self, a):
        return self.add(a, a)

    def halve(self, a):
        """a / 2 mod p (reference element Halve)."""
        return limb.halve(a, self._bc(a, self.q))

    def select(self, cond, a, b):
        """cond ? a : b elementwise (reference element Select)."""
        return limb.select(cond, a, b)

    def eq(self, a, b):
        return limb.eq(a, b)

    def cmp(self, a, b):
        """3-way compare of the *Montgomery representations*, as the JAX
        package's FieldOps.cmp (the reference element Cmp compares the
        regular form: use it on from_mont planes for value order)."""
        return limb.cmp(a, b)

    def bit_len(self, a):
        """BitLen of the canonical value (out of Montgomery form first)."""
        return limb.bit_len(self.from_mont(a))

    def mul_by_3(self, a):
        return self.add(self.double(a), a)

    def mul_by_5(self, a):
        return self.add(self.double(self.double(a)), a)

    def mul_by_13(self, a):
        d2 = self.double(a)
        d4 = self.double(d2)
        d8 = self.double(d4)
        return self.add(self.add(d8, d4), a)

    # ---- exponentiation / inversion (square-and-multiply) -----------------

    def exp(self, a, e: int):
        """a^e by square-and-multiply over the bits of the Python int e
        (reference element Exp)."""
        if e < 0:
            raise ValueError("negative exponent")
        acc = self.const(1, a.shape[1:])
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return acc

    def inverse(self, a):
        """a^(p-2) (Fermat; zero maps to zero, as the reference's EEA)."""
        return self.exp(a, self.spec.p - 2)

    def legendre(self, a):
        """Legendre symbol as field values 1, p-1 or 0 (Montgomery
        planes; reference element Legendre)."""
        return self.exp(a, (self.spec.p - 1) >> 1)

    def sqrt(self, a):
        """Square roots by Tonelli-Shanks (reference element Sqrt): (root,
        ok mask); the root's sign is arbitrary where ok."""
        p = self.spec.p
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2                      # the least quadratic non-residue
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        shape = a.shape[1:]
        c = self.const(pow(z, q, p), shape)
        t = self.exp(a, q)
        r = self.exp(a, (q + 1) >> 1)
        one = self.const(1, shape)
        for i in range(s - 1, 0, -1):
            t_chk = self.exp(t, 1 << (i - 1))
            flip = ~limb.eq(t_chk, one) & ~limb.is_zero(t)
            r = self.select(flip, self.mul(r, c), r)
            c = self.mul(c, c)
            t = self.select(flip, self.mul(t, c), t)
        ok = limb.eq(self.mul(r, r), a) | limb.is_zero(a)
        return r, ok

    def batch_invert(self, a):
        """Montgomery's trick over the last axis (reference element.go
        BatchInvert): one inversion and 3(n-1) products; zeros stay zero."""
        n = a.shape[-1]
        zero_mask = limb.is_zero(a)
        safe = self.select(zero_mask, self._bc(a, self.one), a)
        prefix = [safe[..., 0]]
        for i in range(1, n):
            prefix.append(self.mul(prefix[-1], safe[..., i]))
        inv = self.inverse(prefix[-1])
        out = [None] * n
        for i in range(n - 1, 0, -1):
            out[i] = self.mul(inv, prefix[i - 1])
            inv = self.mul(inv, safe[..., i])
        out[0] = inv
        res = torch.stack(out, dim=-1)
        return self.select(zero_mask, torch.zeros_like(res), res)

    # ---- serialization (reference Vector.WriteTo/ReadFrom,
    # vector.go:53-244: length-prefixed big-endian elements) ---------------

    def marshal_vector(self, digits) -> bytes:
        """Montgomery planes [w, n] -> length-prefixed big-endian bytes."""
        vals = self.to_ints(digits)
        nb = (self.spec.bits + 7) // 8
        out = len(vals).to_bytes(8, "big")
        return out + b"".join(v.to_bytes(nb, "big") for v in vals)

    def unmarshal_vector(self, data: bytes) -> torch.Tensor:
        n = int.from_bytes(data[:8], "big")
        nb = (self.spec.bits + 7) // 8
        vals = [int.from_bytes(data[8 + i * nb:8 + (i + 1) * nb], "big")
                for i in range(n)]
        return self.from_ints(vals)

    # ---- helpers -----------------------------------------------------------

    def _bc(self, a, const_digits):
        """A [w] constant shaped to broadcast against [w, ...] values."""
        return const_digits.reshape(self.w, *([1] * (a.dim() - 1)))
