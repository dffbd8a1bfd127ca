"""Interpolation encoder (reference buckler/encoder.go).

A witness vector is the evaluations of its polynomial on the size-rank
cyclic subgroup; encoding is the cyclic INTT zero-padded into the
embedding ring, and the randomised variant adds an X^rank blind that
vanishes on the subgroup.  Values are plain digit planes on the
encoder's device, with any batch axes between the digit and the
coefficient axis.  The port's copy of ``ringo_tpu.buckler.encoder`` in its
plain (device) branch.
"""

from __future__ import annotations

import torch

from .. import backend
from ..fields import limb
from ..ops.bigntt_matmul import make_device_plan
from ..rings.bigring import FPoly


class Encoder:
    def __init__(self, spec, rank: int, embed_rank: int, device=None):
        self.spec = spec
        self.rank = rank
        self.embed_rank = embed_rank
        self.device = backend.resolve_device(device)
        self.dev_plan = make_device_plan(spec, rank, negacyclic=False,
                                         device=self.device)
        self.pd = limb.ints_to_digits([spec.p], spec.w).to(self.device)

    def _pad(self, coeffs: torch.Tensor, width: int) -> torch.Tensor:
        return coeffs.new_zeros(coeffs.shape[:-1] + (width,))

    def encode_planes(self, v: torch.Tensor) -> torch.Tensor:
        """[w, *batch, rank] value planes -> [w, *batch, embed_rank]
        coefficient planes."""
        coeffs = self.dev_plan.inv(v[..., :self.rank])
        return torch.cat([coeffs, self._pad(coeffs, self.embed_rank
                                             - self.rank)], dim=-1)

    def rand_encode_planes(self, v: torch.Tensor,
                           blind: torch.Tensor) -> torch.Tensor:
        """Randomised encode of [w, *batch, rank] with blinds [w, *batch]:
        coeff[rank] = blind, coeff[0] -= blind (reference RandEncodeTo,
        encoder.go:50-54)."""
        coeffs = self.dev_plan.inv(v[..., :self.rank])
        bl = blind[..., None]
        q = self.pd.reshape((self.spec.w,) + (1,) * (coeffs.dim() - 1))
        c0 = limb.sub(coeffs[..., 0:1], bl, q)
        return torch.cat([c0, coeffs[..., 1:self.rank], bl,
                          self._pad(coeffs, self.embed_rank - self.rank - 1)],
                         dim=-1)

    def rand_encode(self, v: torch.Tensor, blind: torch.Tensor) -> FPoly:
        """Randomised encode of one witness, value planes [w, rank] with
        the blind [w]: the cyclic INTT, then the X^rank blind (reference
        RandEncodeTo, encoder.go:50-54)."""
        return FPoly(self.rand_encode_planes(v, blind), False)

    def encode(self, v: torch.Tensor) -> FPoly:
        """[w, rank] value planes -> embed_rank coefficient poly."""
        return FPoly(self.encode_planes(v), False)
