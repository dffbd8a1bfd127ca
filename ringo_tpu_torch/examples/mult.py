"""Prove X * Y = Z over R_p = Z_p[X]/(X^rank + 1) with |X|_inf <= 5 over
ZP128 (the reference's examples/mult): the ring relation as NTT-domain
linear and pointwise arithmetic constraints,

    XNTT = NTT(X); ZNTT = NTT(Z); XNTT * YNTT - ZNTT = 0; |X| <= 5.

    python3 -m ringo_tpu_torch.examples.mult [--log-n 13] [--seed S] [--device cpu]
"""

import random

from .. import backend, buckler, circuits
from ..fields import ZP128
from ..rings.bigring import CyclotomicRing
from . import cli, clock, run


def setup(log_n: int = 13, seed=None, device=None) -> dict:
    """The mult circuit of ``circuits`` at rank 2^log_n, its inputs from
    ``seed``, compiled on ``device`` (default: the card)."""
    device = backend.resolve_device(device)
    rng = random.Random(seed)
    spec, n = ZP128, 1 << log_n
    t0 = clock(device)
    ring = CyclotomicRing(spec, n, device=device)
    circuit, a, pub = circuits.build("mult", buckler, ring,
                                     seed=rng.randrange(1 << 63),
                                     checker_kw={"device": device})
    t1 = clock(device)
    prv, vrf = buckler.compile_circuit(spec, n, circuit, rng.randbytes(16),
                                       seed=rng.randbytes(16), device=device)
    t2 = clock(device)
    return dict(prv=prv, vrf=vrf, assignment=a, public=pub, spec=spec,
                inputs_s=t1 - t0, compile_s=t2 - t1, **prv.timings)


def main(log_n: int = 13, seed=None, device=None) -> dict:
    return run(setup, log_n, seed, device)


if __name__ == "__main__":
    cli(main, "Prove X * Y = Z with |X|_inf <= 5 over ZP128.")
