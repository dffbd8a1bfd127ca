"""Prove that a BFV ciphertext is well formed, c0 = -c1*s + Delta*m + e
with |m| < t and |e| <= N + t, over ZP240 (the reference's examples/bfv).

The ciphertext comes from the port's BGV (schemes/bgv.py) in the RNS
modulus q of 4 x 60 bits; Buckler proves over one large prime p, so the
ciphertext is switched from q to p first and the switched error (|e'| about
N + t) recomputed (``circuits.bfv_case``).  Decryption must return m.

    python3 -m ringo_tpu_torch.examples.bfv [--log-n 13] [--seed S] [--device cpu]
"""

import random

import numpy as np

from .. import backend, buckler, circuits
from ..fields import ZP240
from ..rings.bigring import CyclotomicRing
from . import cli, clock, run


def setup(log_n: int = 13, seed=None, device=None) -> dict:
    """Key, encryption and decryption on ``device`` (default: the card),
    then the switched circuit at rank 2^log_n, compiled; all from
    ``seed``.  Raises unless decryption returns the message."""
    device = backend.resolve_device(device)
    rng = random.Random(seed)
    t0 = clock(device)
    bgv, sk, m, c0, c1 = circuits.bfv_encrypt(log_n, rng.randbytes(16), device)
    t1 = clock(device)
    if not np.array_equal(bgv.decrypt(sk, c0, c1).numpy(), m):
        raise AssertionError("decryption did not return the message")
    t2 = clock(device)
    spec, n = ZP240, 1 << log_n
    ring = CyclotomicRing(spec, n, device=device)
    circuit, a, pub = circuits.bfv_case(buckler, ring, bgv, sk, m, c0, c1,
                                        checker_kw={"device": device})
    t3 = clock(device)
    prv, vrf = buckler.compile_circuit(spec, n, circuit, rng.randbytes(16),
                                       seed=rng.randbytes(16), device=device)
    t4 = clock(device)
    return dict(prv=prv, vrf=vrf, assignment=a, public=pub, spec=spec,
                bgv=bgv, secret_key=sk, message=m, ciphertext=(c0, c1),
                encrypt_s=t1 - t0,
                decrypt_s=t2 - t1, inputs_s=t3 - t2, compile_s=t4 - t3,
                **prv.timings)


def main(log_n: int = 13, seed=None, device=None) -> dict:
    return run(setup, log_n, seed, device)


if __name__ == "__main__":
    cli(main, "Prove that a BFV ciphertext is well formed over ZP240.")
