"""Big-field NTT by butterfly stages, in plain representation.

Each Cooley-Tukey (forward) or Gentleman-Sande (inverse) stage is one
reshape and one vectorised butterfly over every batch element at once;
the twiddle products go through ops/bigmul's Barrett arithmetic, so
values stay plain digit planes ``[w, *batch, n]`` (int64 lanes) on the
tensors' device.  The twiddles are the exact-int roots of ops/ntt.py.

Counterpart of ``ringo_tpu.ops.bigntt.BigNTTDev``; equal outputs
(tests/test_torch_bigntt.py).  ``make_device_plan`` (ops/bigntt_matmul.py)
picks this engine for the fields narrower than 14 digits.
"""

from __future__ import annotations

import torch

from .. import backend
from ..fields import limb
from ..fields.spec import FieldSpec
from . import ntt as nttmod
from .bigmul import BigMul


class BigNTTDev:
    def __init__(self, spec: FieldSpec, n: int, negacyclic: bool,
                 device=None, generator: int | None = None):
        """``generator`` replaces the canonical root of the twiddle tables
        (ops/ntt.py ``_tables_host``); the sharded four-step
        (parallel/bigntt.py) builds its sub-transforms from powers of one
        root."""
        self.spec = spec
        self.n = n
        self.negacyclic = negacyclic
        self.device = backend.resolve_device(device)
        self.mul = BigMul(spec)
        tw, twinv, ninv = nttmod._tables_host(spec.p, spec.b, spec.k, n,
                                              negacyclic, generator)
        put = lambda v: limb.ints_to_digits(v, spec.w).to(self.device)
        self.tw = put(tw)                              # [w, n]
        self.twinv = put(twinv)
        self.ninv = put([ninv])                        # [w, 1]
        self.pd = put([spec.p])                        # [w, 1]

    def _q(self, ndim: int) -> torch.Tensor:
        return self.pd.reshape((self.spec.w,) + (1,) * (ndim - 1))

    def _tw_slice(self, tbl, m: int, vndim: int) -> torch.Tensor:
        """Twiddles of stage m as [w, 1.., m, 1] against [w, .., m, t]."""
        return tbl[:, m:2 * m].reshape(
            (self.spec.w,) + (1,) * (vndim - 3) + (m, 1))

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT over the last axis; x plain planes [w, *batch, n]."""
        n, shape = self.n, x.shape
        m = 1
        while m <= n // 2:
            x = x.reshape(*shape[:-1], m, 2, n // (2 * m))
            u, v = x[..., 0, :], x[..., 1, :]
            vw = self.mul.mul_mod(v, self._tw_slice(self.tw, m, u.dim()))
            q = self._q(u.dim())
            x = torch.stack([limb.add(u, vw, q), limb.sub(u, vw, q)], dim=-2)
            x = x.reshape(shape)
            m <<= 1
        return x

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT over the last axis, with the 1/n scaling."""
        n, shape = self.n, x.shape
        m = n // 2
        while m >= 1:
            x = x.reshape(*shape[:-1], m, 2, n // (2 * m))
            u, v = x[..., 0, :], x[..., 1, :]
            q = self._q(u.dim())
            s = limb.add(u, v, q)
            d = self.mul.mul_mod(limb.sub(u, v, q),
                                 self._tw_slice(self.twinv, m, u.dim()))
            x = torch.stack([s, d], dim=-2).reshape(shape)
            m >>= 1
        return self.mul.mul_mod(
            x, self.ninv.reshape((self.spec.w,) + (1,) * (x.dim() - 1)))
