"""Challenge encodings, evaluation vectors and the statement binding of
the Jindo evaluation proof (reference jindo/utils.go, prover.go:220-228).
Host code; the port's own copy of ``ringo_tpu.jindo.challenge``."""

from __future__ import annotations

import torch

from ..utils.transcript import Shake128Stream
from .params import Parameters


def encode_challenges(params: Parameters, ring, chal_list) -> torch.Tensor:
    """Batch of 128-bit challenges -> sparse signed ring polynomials,
    NTT + MForm, as residues [L, n, d] on ``ring``'s device (reference
    encodeChallengeTo, jindo/utils.go:21-46)."""
    p = params
    bound = p.challenge_bound
    coeffs = torch.zeros((len(chal_list), p.degree), dtype=torch.int64)
    for j, chal_bytes in enumerate(chal_list):
        c = ((int.from_bytes(chal_bytes[8:16], "big") << 64)
             | int.from_bytes(chal_bytes[:8], "big"))
        for i in range(p.exp):
            c, r = divmod(c, bound)
            coeffs[j, i * p.slots] = r - bound if r > bound // 2 else r
    return ring.ntt_mform(ring.embed_int64(coeffs.to(ring.device)))


def read_challenges(oracle: Shake128Stream, n: int) -> list[bytes]:
    """The next n 16-byte challenges of the oracle, squeezed in one read
    (the bytes n reads of 16 would give)."""
    buf = oracle.read(16 * n)
    return [buf[16 * i:16 * (i + 1)] for i in range(n)]


def left_vec(params: Parameters, x: int) -> list[int]:
    """Row multipliers 1, s, s^2, ..., with the last row replaced by x,
    s = x^(cols*slots) (reference leftVec, jindo/utils.go:62-72)."""
    p = params.spec.p
    skip = pow(x, params.cols * params.slots, p)
    left = [1] * params.rows
    for i in range(1, params.rows):
        left[i] = left[i - 1] * skip % p
    left[params.rows - 1] = x % p
    return left


def right_vec(params: Parameters, x: int) -> list[int]:
    """Powers 1, x, ..., x^(cols*slots-1) (reference rightVec)."""
    p = params.spec.p
    out = [1] * (params.cols * params.slots)
    for i in range(1, len(out)):
        out[i] = out[i - 1] * x % p
    return out


def bind_statement(params: Parameters, ck, coms, x: int):
    """The oracle of one evaluation proof after it absorbed the statement:
    CRS bytes, commitment bytes and the point (prover.go:220-228).  For
    batch > 1 the 16-byte batch challenges are squeezed first and the
    oracle restarts with them appended.  Returns (oracle, batch challenge
    bytes or None); prover and verifier both start here."""
    def absorb(oracle):
        oracle.write(ck.raw_bytes())
        for c in coms:
            oracle.write(c.raw_bytes())
        oracle.write(params.spec.marshal(x))

    oracle = Shake128Stream()
    absorb(oracle)
    if params.batch == 1:
        return oracle, None
    batch_bytes = read_challenges(oracle, params.batch)
    oracle.reset()
    absorb(oracle)
    oracle.write(b"".join(batch_bytes))
    return oracle, batch_bytes
