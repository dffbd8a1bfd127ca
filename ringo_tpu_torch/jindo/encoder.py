"""Jindo encoder: the Z_p <-> R_q bridge (reference jindo/encoder.go).

Values are base-b digit-decomposed with the strided slot layout
coeff[j*slots + i]; the randomized encoding adds p * (a discrete Gaussian
drift correction) so commitments leak nothing about the digits.  Every
step is elementwise on tensors and exact, and equals the JAX package's
``Encoder`` bit for bit: the same integer results, and the float64 drift
centres from the same IEEE operations in the same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..csprng import COSACSampler
from ..fields import limb
from ..rings.rns import RnsReconstructor
from .params import Parameters


def _delta_inv(params: Parameters) -> list[float]:
    """[-1/p, -b/p, ..., -b^(k-1)/p] as float64 with the reference's
    small-value flush to zero (encoder.go:50-67)."""
    spec = params.spec
    threshold = math.exp2(-50) / (float(spec.b) * float(spec.k))
    out = []
    num = -1  # running -b^i
    for _ in range(spec.k):
        v = num / spec.p  # Python int ratio -> correctly rounded float64
        out.append(0.0 if abs(v) < threshold else v)
        num *= spec.b
    return out


class Encoder:
    def __init__(self, params: Parameters, seed: bytes | None = None,
                 ring=None):
        """``ring`` is ``params.ring_q`` on the device the plain encodes
        run on (default: the parameters' own ring, on the CPU)."""
        if params.base >= 1 << 21:
            raise ValueError("the float64 digit ladder needs b < 2^21")
        self.params = params
        self.spec = params.spec
        self.ring = params.ring_q if ring is None else ring
        self.rns = RnsReconstructor(params.ring_q)
        self.cosac = COSACSampler(None if seed is None else seed + b"co")
        self.delta_inv = _delta_inv(params)

    def base_digits(self, values: torch.Tensor) -> torch.Tensor:
        """Plain digit planes [w, *batch, slots] -> base-b digits
        [*batch, d] int64 laid out coeff[j*slots + i] (reference
        baseEncodeTo, encoder.go:120-146).

        32-bit-chunk long division in float64 (cur = r * 2^32 + chunk <
        b * 2^32 < 2^53, exact), with the chunk count shrinking as the
        quotient loses log2(b) bits per extracted digit."""
        p = self.params
        k = p.exp
        b = float(p.base)
        inv_b = 1.0 / b
        w = values.shape[0]
        chunks = []
        for j in range(-(-w // 2)):
            lo = values[2 * j].to(torch.float64)
            if 2 * j + 1 < w:
                lo = lo + values[2 * j + 1].to(torch.float64) * 65536.0
            chunks.append(lo)
        log2b = math.log2(p.base)
        digs = []
        for i in range(k - 1):
            need = min(max(1, -(-int((k - i) * log2b + 2) // 32)), len(chunks))
            del chunks[need:]
            r = chunks[0] * 0.0
            for j in reversed(range(need)):
                cur = r * 4294967296.0 + chunks[j]
                q = torch.floor(cur * inv_b)
                r = cur - q * b
                q = torch.where(r < 0, q - 1.0, q)
                r = torch.where(r < 0, r + b, r)
                q = torch.where(r >= b, q + 1.0, q)
                r = torch.where(r >= b, r - b, r)
                chunks[j] = q
            digs.append(r.to(torch.int64))
        last = chunks[0]
        for j in range(1, len(chunks)):
            last = last + chunks[j] * float(1 << (32 * j))
        digs.append(last.to(torch.int64))
        dg = torch.stack(digs, dim=-2)  # [*batch, k, slots]
        return dg.reshape(*dg.shape[:-2], p.degree)

    def drift_centers(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Gaussian drift centres -fp of the randomized encoding
        (encoder.go:152-164): coeffs [*batch, d] int64 -> float64."""
        p = self.params
        d, slots = p.degree, p.slots
        c0 = coeffs.to(torch.float64)
        fp = torch.zeros(coeffs.shape, dtype=torch.float64,
                         device=coeffs.device)
        for i, di in enumerate(self.delta_inv):
            if di == 0.0:
                continue
            dd = d - (i + 1) * slots
            fp = fp + torch.cat(
                [-di * c0[..., d - dd:], di * c0[..., :d - dd]], dim=-1)
        return -fp

    def correction_total(self, coeffs: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
        """coeffs + (X^slots - b) * c, the drift correction that keeps the
        decoded value (encoder.go:186-196); int64 [*batch, d]."""
        p = self.params
        d, slots = p.degree, p.slots
        shifted = torch.cat([-c[..., d - slots:], c[..., :d - slots]], dim=-1)
        return coeffs + shifted - int(p.base) * c

    def host_centers(self, values: torch.Tensor) -> np.ndarray:
        """Drift centres of CPU digit planes, as a flat numpy array for
        the host samplers."""
        return self.drift_centers(self.base_digits(values)).reshape(-1).numpy()

    # -- plain encode and decode ----------------------------------------------

    def encode(self, values: torch.Tensor) -> torch.Tensor:
        """Plain digit planes [w, *batch, slots] -> NTT + MForm residues
        [L, *batch, d] on the encoder's ring (reference encodeTo,
        encoder.go:113-117)."""
        ring = self.ring
        coeffs = self.base_digits(values.to(ring.device))
        return ring.ntt_mform(ring.embed_int64(coeffs))

    def encode_scalars(self, ints: list[int]) -> torch.Tensor:
        """Host ints -> one single-slot encode each: [L, len, d]."""
        w = self.spec.w
        vals = torch.zeros((w, len(ints), self.params.slots),
                           dtype=torch.int64)
        vals[:, :, 0] = limb.ints_to_digits([v % self.spec.p for v in ints], w)
        return self.encode(vals)

    def decode(self, poly: torch.Tensor) -> list[int]:
        """Plain coefficient-domain residues [L, d] -> slots field values
        (reference DecodeTo, encoder.go:204-219), in Python ints on the
        host."""
        p = self.params
        coeffs = self.rns.reconstruct(poly)
        out = []
        for i in range(p.slots):
            acc = 0
            for j in reversed(range(p.exp)):
                acc = (acc * p.base + coeffs[j * p.slots + i]) % self.spec.p
            out.append(acc)
        return out
