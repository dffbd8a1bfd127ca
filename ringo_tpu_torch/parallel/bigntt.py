"""Coefficient-sharded big-field NTT: the four-step with an all-to-all.

A cyclic NTT of size n = n1 * n2 over Z_p by the four-step (Bailey)
decomposition, the coefficient grid split over the mesh's ``sp`` axis:

1. n2-point NTTs along the local axis of the rank's grid rows (no
   communication), with the sub-plan's output put into true DFT order;
2. the twiddles root^(i1*k2), elementwise Barrett products;
3. the transpose [n1, n2] -> [n2, n1] as one ``all_to_all_single``;
4. n1-point NTTs along the new local axis, then an all-gather that puts
   the result into natural order on every rank.

Input x[i1 + n1*i2] lives at grid [i1, i2]; output X[k2 + n2*k1] lands at
[k1, k2].  The sub-transforms are ``MatmulBigNTT(order="dft")`` for the
fields of 14 digits or more and the stage engine (``BigNTTDev``) with its
tables rebuilt from the four-step's root below, under the same
``RINGO_BIG_NTT`` rule as ``make_device_plan``.  ``inv`` runs the same
with root^-1 and scales by 1/n.  Counterpart of
``ringo_tpu.parallel.bigntt``; equal to the direct DFT
(tests/test_torch_parallel.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..fields import limb
from ..fields.spec import FieldSpec
from ..ops.bigmul import BigMul
from ..ops.bigntt import BigNTTDev
from ..ops.bigntt_matmul import MatmulBigNTT, engine_mode
from .mesh import check_device, mesh_axes


class ShardedBigNTT:
    """Four-step cyclic NTT of size n = n1 * n2 over Z_p, split over the
    mesh's ``sp`` axis.  ``fwd`` / ``inv`` take and return natural-order
    coefficient planes [w, *batch, n], whole on every rank."""

    def __init__(self, spec: FieldSpec, n: int, mesh, n1: int | None = None,
                 device=None):
        self.spec = spec
        self.n = n
        self.mesh = mesh
        self.device = dev = torch.device(mesh.device_type if device is None
                                         else device)
        self.sp = mesh_axes(mesh, dev)[2]
        if n1 is None:
            n1 = 1 << ((n - 1).bit_length() // 2)
        n2 = n // n1
        if n1 * n2 != n:
            raise ValueError("n1 must divide n")
        if n1 % self.sp.size or n2 % self.sp.size:
            raise ValueError(f"sp = {self.sp.size} must divide n1 = {n1} "
                             f"and n2 = {n2}")
        self.n1, self.n2 = n1, n2
        self.w_root = spec.find_generator(n, False)
        self.big = BigMul(spec)
        p = spec.p
        self._pipes = {"fwd": self._build(self.w_root),
                       "inv": self._build(pow(self.w_root, p - 2, p))}
        self._ninv = limb.ints_to_digits([pow(n, p - 2, p)], spec.w).to(dev)

    def _build(self, root: int):
        """Sub-plans, the rank's rows of the twiddle grid and the DFT-order
        fixes of one direction (root = w forward, w^-1 inverse)."""
        spec, n1, n2, dev = self.spec, self.n1, self.n2, self.device
        p = spec.p
        mode = engine_mode()
        r2, r1 = pow(root, n1, p), pow(root, n2, p)
        if mode == "matmul" or (mode == "auto" and spec.w >= 14):
            sub2 = MatmulBigNTT(spec, n2, False, device=dev, generator=r2,
                                order="dft")
            sub1 = MatmulBigNTT(spec, n1, False, device=dev, generator=r1,
                                order="dft")
        else:
            sub2 = BigNTTDev(spec, n2, False, device=dev, generator=r2)
            sub1 = BigNTTDev(spec, n1, False, device=dev, generator=r1)
        rows = self.sp.take(n1, "cpu").tolist()
        flat = []
        for i1 in rows:
            acc, r = 1, pow(root, i1, p)
            for _ in range(n2):
                flat.append(acc)
                acc = acc * r % p
        tw = limb.ints_to_digits(flat, spec.w).reshape(spec.w, len(rows), n2)
        return (sub2, sub1, tw.to(dev), torch.tensor(rows, device=dev),
                self._dft_order(sub2, r2, n2), self._dft_order(sub1, r1, n1))

    def _dft_order(self, plan, root: int, m: int) -> torch.Tensor:
        """The gather that puts ``plan.fwd``'s output into true DFT order
        X[k] = sum_i x[i] root^(ik), read off an impulse run on the plan
        itself (on this rank's device): DFT(e_1)[k] = root^k."""
        e = torch.zeros((self.spec.w, m), dtype=torch.int64, device=self.device)
        e[0, 1] = 1
        out = limb.digits_to_ints(plan.fwd(e))
        pos = {pow(root, k, self.spec.p): k for k in range(m)}
        inv = torch.empty(m, dtype=torch.int64)
        inv[torch.tensor([pos[v] for v in out])] = torch.arange(m)
        return inv.to(self.device)

    def _run(self, x: torch.Tensor, pipe, scale=None) -> torch.Tensor:
        check_device(self.mesh, x)
        sub2, sub1, tw, rows, ord2, ord1 = pipe
        w, n1, n2, sp = self.spec.w, self.n1, self.n2, self.sp
        s = sp.size
        lead = x.shape[1:-1]
        x = x.reshape(w, -1, n2, n1)                       # [w, b, i2, i1]
        b = x.shape[1]
        # grid rows i1 of this rank: [w, b, n1/s, i2]
        g = x.transpose(2, 3)[:, :, rows]
        # step 1: n2-point NTTs along i2, into DFT order k2
        g = sub2.fwd(g)[..., ord2]
        # step 2: twiddles root^(i1*k2)
        g = self.big.mul_mod(g, tw[:, None])
        # step 3: the transpose; block j of k2 goes to rank j
        blocks = g.reshape(w, b, n1 // s, s, n2 // s).permute(3, 0, 1, 2, 4
                                                            ).contiguous()
        recv = torch.empty_like(blocks)
        dist.all_to_all_single(recv, blocks, group=sp.group)
        # [src rank (i1 block), w, b, n1/s, k2 local] -> [w, b, k2, i1]
        h = recv.permute(1, 2, 4, 0, 3).reshape(w, b, n2 // s, n1)
        # step 4: n1-point NTTs along i1, then natural order X[k2 + n2*k1]
        h = sub1.fwd(h)[..., ord1]                         # [w, b, k2, k1]
        out = sp.gather(h, 2, n2).transpose(2, 3).reshape(w, b, n1 * n2)
        if scale is not None:
            out = self.big.mul_mod(out, scale.reshape(w, 1, 1))
        return out.reshape((w,) + lead + (self.n,))

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """X[k] = sum_i x[i] w^(ik), natural order; x plain planes
        [w, *batch, n]."""
        return self._run(x, self._pipes["fwd"])

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """The exact inverse of ``fwd``, with the 1/n scale."""
        return self._run(x, self._pipes["inv"], self._ninv)
