"""Polynomial evaluation over the big prime field, on digit planes.

The evaluations y_i = v_i(x) of the Jindo proof (reference
jindo/prover.go:318-323) with exact Barrett arithmetic (ops/bigmul.py) on
the tensors' device.  On the card ``HornerPlan.eval_stacked`` and
``powers`` are one launch each of csrc/bigfield.cu (Horner's rule per
lane, the lanes' powers from shared tables, the sum across blocks in the
same launch).  On the CPU they run the plain versions, three vectorised
phases:

1. powers P[i] = x^i by doubling, P_2m = P_m ++ P_m * x^m: log2(n) vector
   products, about n elementwise ones in all (the step scalars x^(2^k)
   are Python ints from the host);
2. the pointwise products v[i] * P[i] of all polynomials at once;
3. a balanced tree of modular additions over the coefficient axis.

Both give the same digits: every value is reduced mod p exactly, and a
sum mod p does not depend on its order.  Counterpart of
``ringo_tpu.ops.horner``; equal results (tests/test_torch_bigmul.py,
tests/test_torch_horner_kernel.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import bigfield, limb
from ..fields.spec import FieldSpec
from .bigmul import BigMul


def tree_sum(big: BigMul, x: torch.Tensor) -> torch.Tensor:
    """Sum mod p over the last axis of digit planes [w, ..., m] -> [w, ...]:
    one launch of csrc/bigfield.cu on the card (canonical values), the
    plain version's halving additions on the CPU."""
    if bigfield.on_card(x):
        return bigfield.tree_sum_cuda(big, x)
    return tree_sum_plain(big, x)


def tree_sum_plain(big: BigMul, x: torch.Tensor) -> torch.Tensor:
    pd = torch.tensor(big.p_digits, dtype=torch.int64, device=x.device
                      ).reshape(big.w, *([1] * (x.dim() - 1)))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        s = limb.add_plain(x[..., :half], x[..., half:2 * half], pd)
        x = torch.cat([s, x[..., 2 * half:]], dim=-1)
    return x[..., 0]


class HornerPlan:
    """Evaluation of coefficient vectors at a point, for one field."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.big = BigMul(spec)

    def steps_for(self, x: int, n: int) -> torch.Tensor:
        """Host digits [logn, w] of x^(2^k), each the square of the one
        before."""
        spec = self.spec
        s, rows = x % spec.p, []
        for _ in range(max(1, (n - 1).bit_length())):
            rows.append(spec.to_digits_int(s))
            s = s * s % spec.p
        return torch.tensor(rows, dtype=torch.int64)

    def stack_inputs(self, vs_list, n: int, device) -> torch.Tensor:
        """Value planes [w, n_i] (numpy or tensors on any device), zero
        padded to n and stacked as [w, t, n] on ``device``."""
        out = torch.zeros((self.spec.w, len(vs_list), n), dtype=torch.int64,
                          device=device)
        for i, v in enumerate(vs_list):
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v).astype(np.int64))
            out[:, i, :v.shape[1]] = v.to(device)
        return out

    def powers_plain(self, steps: torch.Tensor, n: int) -> torch.Tensor:
        """[w, n] digit planes of x^0 .. x^(n-1) from the step digits, by
        doubling."""
        P = torch.zeros((self.spec.w, 1), dtype=torch.int64,
                        device=steps.device)
        P[0, 0] = 1
        for k in range(steps.shape[0]):
            if P.shape[1] >= n:
                break
            P = torch.cat([P, self.big.mul_mod_plain(P, steps[k][:, None])],
                          dim=1)
        return P[:, :n]

    def powers(self, x: int, n: int, device) -> torch.Tensor:
        """Digit planes [w, n] of x^0 .. x^(n-1) on ``device``: one launch
        on the card."""
        steps = self.steps_for(x, n).to(device)
        if bigfield.on_card(steps):
            return bigfield.powers_cuda(self.big, steps, n)
        return self.powers_plain(steps, n)

    def eval_stacked(self, vs: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
        """vs [w, t, n] plain digits, steps [logn, w] digits of x^(2^k) on
        the same device -> [w, t] digits of v_i(x): one launch on the
        card."""
        if bigfield.on_card(vs):
            return bigfield.horner_cuda(self.big, vs, steps)
        return self.eval_stacked_plain(vs, steps)

    def eval_stacked_plain(self, vs: torch.Tensor,
                           steps: torch.Tensor) -> torch.Tensor:
        P = self.powers_plain(steps, vs.shape[2])
        return tree_sum_plain(self.big,
                              self.big.mul_mod_plain(vs, P[:, None, :]))

    def evaluate_many(self, vs_list, x: int, device) -> list[int]:
        """Evaluate several coefficient vectors at the same point on
        ``device``; returns Python ints."""
        if not vs_list:
            return []
        n = max(v.shape[1] for v in vs_list)
        out = self.eval_stacked(self.stack_inputs(vs_list, n, device),
                                self.steps_for(x, n).to(device))
        return limb.digits_to_ints(out)
