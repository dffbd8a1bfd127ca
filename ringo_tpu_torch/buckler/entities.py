"""Buckler proof object (reference buckler/entities.go) and its wire format:
the JAX package's layout byte for byte (element marshal layout,
element.go:879-888), so proofs cross between the packages with
``to_bytes`` / ``from_bytes``.

``from_bytes`` takes a field scalar only in its canonical form, below p:
v + p would spell a second byte string of the same proof (one proof, one
encoding, as for the Jindo lanes).  The JAX package reduces such a scalar
mod p and accepts it."""

from __future__ import annotations

import dataclasses

from ..jindo.entities import Commitment
from ..jindo.entities import Proof as JindoProof


@dataclasses.dataclass
class Proof:
    witness: list[Commitment]
    lin_check_mask_sum: int
    sum_check_mask_sum: int
    evals: list[int]
    eval_proof: JindoProof

    def to_bytes(self, params) -> bytes:
        spec = params.spec
        out = [len(self.witness).to_bytes(4, "big")]
        for c in self.witness:
            blob = c.to_bytes()
            out.append(len(blob).to_bytes(8, "big"))
            out.append(blob)
        out.append(spec.marshal(self.lin_check_mask_sum))
        out.append(spec.marshal(self.sum_check_mask_sum))
        out.append(len(self.evals).to_bytes(4, "big"))
        out.extend(spec.marshal(e) for e in self.evals)
        out.append(self.eval_proof.to_bytes(params))
        return b"".join(out)

    @classmethod
    def from_bytes(cls, params, data: bytes) -> "Proof":
        spec = params.spec
        nb = -(-spec.bits // 64) * 8  # marshal width (64-bit-limb layout)
        off = 0

        def take(n: int) -> bytes:
            nonlocal off
            if off + n > len(data):
                raise ValueError("Buckler proof: truncated")
            off += n
            return data[off - n:off]

        def scalar(what: str) -> int:
            v = int.from_bytes(take(nb), "big")
            if v >= spec.p:
                raise ValueError(f"Buckler proof: {what} is not below p")
            return v

        witness = []
        for _ in range(int.from_bytes(take(4), "big")):
            ln = int.from_bytes(take(8), "big")
            witness.append(Commitment.from_bytes(params, take(ln)))
        lin_sum = scalar("lin_check_mask_sum")
        sum_sum = scalar("sum_check_mask_sum")
        evals = [scalar(f"evals[{i}]")
                 for i in range(int.from_bytes(take(4), "big"))]
        eval_proof = JindoProof.from_bytes(params, data[off:])
        return cls(witness, lin_sum, sum_sum, evals, eval_proof)
