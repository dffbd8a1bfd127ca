"""Entry points of the port at the sizes the JAX package's graft entry
uses (``__graft_entry__.py`` at the repository root, which stays the JAX
package's).

``entry(device=None)``    -- the Jindo commit core (encode NTTs, inner
                            Ajtai MAC, exact CRT cutoff, outer commitment)
                            on the flagship field ZP255 at N = 2^10, with
                            its example inputs: ``fn(*args)`` runs it.
``dryrun_multichip(n)``   -- every sharded builder of ``parallel`` once at
                            tiny shapes over a world of n processes, one
                            per device (NCCL on the cards, or gloo
                            processes with ``device="cpu"``).

Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

CRS = b"Jindo!"


def _make_prover(device=None, log_n: int = 10, batch: int = 1,
                 seed: bytes = b"graft"):
    from . import jindo
    from .fields import ZP255

    params = jindo.new_parameters(ZP255, 1 << log_n, batch)
    return params, jindo.Prover(params, CRS, seed=seed, device=device)


def example_inputs(params, lead=()):
    """Signed encode coefficients [*lead, B, R, d] in [-1000, 1000) and
    MLWE noise [*lead, B, K, d] in [-6, 6], from seed 0 (the JAX
    package's ``__graft_entry__._example_inputs``), as numpy int64."""
    rng = np.random.default_rng(0)
    B, R = params.cols + 1, params.rows
    K = params.mlwe_rank + params.in_msis_rank
    d = params.degree
    e = rng.integers(-1000, 1000, (*lead, B, R, d), dtype=np.int64)
    noise = rng.integers(-6, 7, (*lead, B, K, d), dtype=np.int64)
    return e, noise


def entry(device=None):
    """(``raw_stages()["commit_core"]``, (e, noise, pk_in, pk_out)) at
    ZP255, N = 2^10, on ``device``."""
    params, prover = _make_prover(device)
    e, noise = example_inputs(params)
    put = lambda a: torch.from_numpy(a).to(prover.device)
    return (prover.raw_stages()["commit_core"],
            (put(e), put(noise), *prover.ck_device()))


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def _dryrun(mesh, device) -> None:
    """Every sharded builder once over ``mesh`` at tiny shapes."""
    from . import buckler, jindo
    from .fields import ZP110, ZP255, limb
    from .parallel import (ShardedBigNTT, build_sharded_buckler_round,
                           build_sharded_commit, build_sharded_evaluate,
                           shard_jindo_prover, shard_jindo_verifier)

    params, prover = _make_prover(device)
    dev = prover.device
    put = lambda a: torch.as_tensor(a).to(dev)
    t = mesh.shape[0]                                 # the dp size
    e, noise = example_inputs(params, lead=(t,))
    outer = build_sharded_commit(prover, mesh)(put(e), put(noise),
                                               *prover.ck_device())[3]
    _expect(outer.shape == (t, params.ring_q_out.L, params.out_msis_rank,
                            params.degree), "sharded commit shape")

    # the Buckler first round: randomised encodes and embedding NTTs (dp)
    # fused with Jindo commit cores (dp / tp / sp)
    class TinyCircuit:
        def __init__(self):
            self.x = buckler.Witness()
            self.y = buckler.Witness()

        def define(self, ctx):
            c = buckler.ArithmeticConstraint()
            c.add_term(1, None, self.x)
            c.add_term(-1, None, self.y)
            ctx.add_arithmetic_constraint(c)

    bprv, _ = buckler.compile_circuit(ZP110, 1 << 7, TinyCircuit(), b"graft!",
                                      seed=b"mc", device=dev)
    jp = bprv.jindo.params
    rng = np.random.default_rng(1)
    w_planes = rng.integers(0, 997, (t, ZP110.w, bprv.ctx.rank))
    blinds = rng.integers(0, 997, (t, ZP110.w))
    be, bnz = example_inputs(jp, lead=(t,))
    bouter = build_sharded_buckler_round(bprv, mesh)(
        put(w_planes), put(blinds), put(be), put(bnz),
        *bprv.jindo.ck_device())[3]
    _expect(bouter.shape == (t, jp.ring_q_out.L, jp.out_msis_rank, jp.degree),
            "Buckler round shape")

    # the evaluation stages: openings over dp, planes over tp
    L, d = params.ring_q.L, params.degree
    B, R = params.cols + 1, params.rows
    K = params.mlwe_rank + params.in_msis_rank
    q = torch.tensor(params.ring_q.primes).reshape(L, *([1] * 4))

    def rand_res(*shape):
        v = torch.from_numpy(rng.integers(0, 1 << 31, (L, *shape))) % q.reshape(
            L, *([1] * len(shape)))
        return v.to(torch.int32).to(dev)

    part = build_sharded_evaluate(prover, mesh)(
        rand_res(R, d), torch.stack([rand_res(B, R, d) for _ in range(t)]),
        torch.stack([rand_res(B, K, d) for _ in range(t)]),
        rand_res(params.cols, d))[0]
    _expect(part.shape == (t, L, B, d), "sharded evaluate shape")

    # the four-step big-field NTT over sp, forward and back, on the wide
    # field (the matmul sub-transforms)
    sh = ShardedBigNTT(ZP255, 256, mesh, n1=16, device=dev)
    vals = [int(v) % ZP255.p for v in rng.integers(0, 1 << 62, size=256)]
    x = limb.ints_to_digits(vals, ZP255.w).to(dev)
    _expect(limb.digits_to_ints(sh.inv(sh.fwd(x))) == vals,
            "four-step round trip")

    # the whole Jindo round trip on a mesh-attached prover and verifier
    sprv = shard_jindo_prover(jindo.Prover(params, CRS, seed=b"graft-mc",
                                           device=dev), mesh)
    v = limb.ints_to_digits([int.from_bytes(rng.bytes(30), "little")
                             % ZP255.p for _ in range(1 << 10)], ZP255.w)
    com, op = sprv.commit(v)
    ys, pf = sprv.evaluate(12345, [v], [com], [op])
    svrf = shard_jindo_verifier(jindo.Verifier(params, CRS, device=dev,
                                               ck=sprv.ck), mesh)
    _expect(svrf.verify(12345, [com], ys, pf) is True,
            "sharded Jindo round trip")


def _dryrun_rank(rank: int, n: int, store: str, device: str) -> None:
    import torch.distributed as dist

    from .parallel import init_multihost, make_mesh

    init_multihost(f"file://{store}", n, rank, device=device)
    try:
        _dryrun(make_mesh(n, device=device), device)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every sharded builder once over a world of ``n_devices``
    processes (``device=None``: one card each, NCCL; ``"cpu"``: gloo).
    Raises if any rank fails."""
    import torch.multiprocessing as mp

    device = "cuda" if device is None else str(torch.device(device).type)
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} cards asked for, "
                           f"{torch.cuda.device_count()} present")
    tmp = tempfile.mkdtemp(prefix="ringo-dryrun-")
    try:
        mp.spawn(_dryrun_rank, args=(n_devices, os.path.join(tmp, "store"),
                                     device), nprocs=n_devices, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["multichip"]:
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 1
        dev = sys.argv[3] if len(sys.argv) > 3 else None
        dryrun_multichip(n, dev)
        print(f"dryrun_multichip({n}): OK")
    else:
        fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else None)
        print("entry(): OK", [tuple(o.shape) for o in fn(*args)])
