"""What tests/test_torch_parallel.py runs in its two gloo processes, and
the single-device results it holds them to.

``worker`` (the target of one ``torch.multiprocessing.spawn`` of world
size 2) runs every case of ``run_cases`` on the meshes (2, 1, 1),
(1, 2, 1) and (1, 1, 2) in turn and saves its results; ``single`` computes
the same cases with the port on one device, no mesh.  Sizes are the JAX
package's tests/test_parallel.py's: N = 2^9 for Jindo, N = 2^8 for
Buckler, n = 256 for the four-step.  Nothing here imports JAX.
"""

import numpy as np
import torch
import torch.distributed as dist

import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch import buckler as bk, circuits, fields
from ringo_tpu_torch import parallel as P
from ringo_tpu_torch.fields import ZP128, ZP255, limb
from ringo_tpu_torch.rings.bigring import CyclotomicRing

MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]
CASES = ("commit", "commit_uneven", "evaluate", "buckler_round",
         "dft_stage", "dft_matmul", "buckler_prove", "jindo_roundtrip",
         "bcast", "barrier")
CRS = b"Jindo!"
PAYLOAD = b"ringo-challenge-0123456789abcdef"
X = 987654321


def jindo_prover(batch: int = 1, seed: bytes = b"par"):
    params = tj.new_parameters(ZP255, 1 << 9, batch)
    return params, tj.Prover(params, CRS, seed=seed, device="cpu")


def commit_inputs(params, t: int, seed: int):
    rng = np.random.default_rng(seed)
    B, R, d = params.cols + 1, params.rows, params.degree
    K = params.mlwe_rank + params.in_msis_rank
    return (torch.from_numpy(rng.integers(-(1 << 20), 1 << 20, (t, B, R, d))),
            torch.from_numpy(rng.integers(-30, 31, (t, B, K, d))))


def evaluate_inputs(params, t: int = 2):
    """left_ecd, enc [t, ...], mlwe [t, ...], chals: residues below each
    prime."""
    rng = np.random.default_rng(9)
    L, d = params.ring_q.L, params.degree
    B, R = params.cols + 1, params.rows
    K = params.mlwe_rank + params.in_msis_rank
    q = torch.tensor(params.ring_q.primes)

    def res(*shape):
        v = torch.from_numpy(rng.integers(0, 1 << 31, (L, *shape)))
        return (v % q.reshape(L, *([1] * len(shape)))).to(torch.int32)

    return (res(R, d), torch.stack([res(B, R, d) for _ in range(t)]),
            torch.stack([res(B, K, d) for _ in range(t)]), res(params.cols, d))


def buckler_case():
    """The PublicKey circuit at (N = 2^8, ZP220), compiled on the CPU."""
    field, log_n = circuits.CASES["public_key"]
    spec, n = getattr(fields, field), 1 << log_n
    ring = CyclotomicRing(spec, n, device="cpu")
    c, a, pub = circuits.build("public_key", bk, ring,
                               checker_kw={"device": "cpu"})
    prv, vrf = bk.compile_circuit(spec, n, c, circuits.CRS,
                                  seed=circuits.seed_of("public_key"),
                                  device="cpu")
    return prv, vrf, a, pub


def round_inputs(prv, t: int = 4):
    rng = np.random.default_rng(12)
    jp, w = prv.jindo.params, prv.spec.w
    B, R, d = jp.cols + 1, jp.rows, jp.degree
    K = jp.mlwe_rank + jp.in_msis_rank
    return tuple(torch.from_numpy(a) for a in (
        rng.integers(0, 997, (t, w, prv.ctx.rank)),
        rng.integers(0, 997, (t, w)),
        rng.integers(-1000, 1000, (t, B, R, d)),
        rng.integers(-6, 7, (t, B, K, d))))


def dft_input(spec, n: int = 256, seed: int = 21) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int(v) % spec.p for v in rng.integers(0, 1 << 63, size=n)]


def jindo_values(n: int = 1 << 9):
    rng = np.random.default_rng(31)
    return [limb.ints_to_digits(
        [int.from_bytes(rng.bytes(30), "little") % ZP255.p for _ in range(n)],
        ZP255.w) for _ in range(2)]


def jindo_roundtrip(mesh=None):
    """commit_many of two, evaluate at X, verify, and a tampered y; with
    ``mesh`` on a mesh-attached prover and verifier."""
    params, prv = jindo_prover(batch=2, seed=b"rt")
    vrf = tj.Verifier(params, CRS, device="cpu", ck=prv.ck)
    if mesh is not None:
        P.shard_jindo_prover(prv, mesh)
        P.shard_jindo_verifier(vrf, mesh)
    vs = jindo_values()
    pairs = prv.commit_many(vs)
    coms = [c for c, _ in pairs]
    ys, pf = prv.evaluate(X, vs, coms, [o for _, o in pairs])
    return dict(coms=[c.to_bytes() for c in coms], ys=ys,
                proof=pf.to_bytes(params), ok=vrf.verify(X, coms, ys, pf),
                bad=vrf.verify(X, coms, [ys[0] + 1, ys[1]], pf))


def buckler_prove(case, mesh=None):
    """The PublicKey proof of ``buckler_case()`` (the four-step forced on
    with a mesh), the verdict on it and on a tampered evaluation."""
    prv, vrf, a, pub = case
    if mesh is not None:
        P.shard_buckler_prover(prv, mesh, min_ntt_rank=prv.ctx.rank)
        assert isinstance(prv.poly_ring.dev_plan, P.ShardedBigNTT)
        P.shard_jindo_verifier(vrf.jindo, mesh)
    pf = prv.prove(a)
    data = pf.to_bytes(prv.params)
    bad = bk.Proof.from_bytes(prv.params, data)
    bad.evals[0] = (bad.evals[0] + 1) % prv.spec.p
    return dict(proof=data, ok=vrf.verify(pub, pf), bad=vrf.verify(pub, bad))


def run_cases(mesh) -> dict:
    """Every case over ``mesh`` on this rank."""
    out = {}
    params, prv = jindo_prover()
    ck = prv.ck_device()
    e, noise = commit_inputs(params, 4, 3)
    out["commit"] = P.commit_batch(prv, mesh, e.numpy(), noise.numpy())
    out["commit_uneven"] = P.build_sharded_commit(prv, mesh)(
        *commit_inputs(params, 3, 5), *ck)
    out["evaluate"] = P.build_sharded_evaluate(prv, mesh)(
        *evaluate_inputs(params))
    # the round draws nothing from the prover's samplers: the proof below
    # is the one a fresh prover gives
    bcase = buckler_case()
    bprv = bcase[0]
    out["buckler_round"] = P.build_sharded_buckler_round(bprv, mesh)(
        *round_inputs(bprv), *bprv.jindo.ck_device())
    for case, spec in (("dft_stage", ZP128), ("dft_matmul", ZP255)):
        sh = P.ShardedBigNTT(spec, 256, mesh, n1=16, device="cpu")
        x = limb.ints_to_digits(dft_input(spec), spec.w)
        out[case] = dict(root=sh.w_root, engine=type(sh._pipes["fwd"][0]).__name__,
                         fwd=limb.digits_to_ints(sh.fwd(x)),
                         inv=limb.digits_to_ints(sh.inv(x)),
                         back=limb.digits_to_ints(sh.inv(sh.fwd(x))))
    out["buckler_prove"] = buckler_prove(bcase, mesh)
    out["jindo_roundtrip"] = jindo_roundtrip(mesh)
    rank0 = dist.get_rank() == 0
    out["bcast"] = P.bcast_bytes(PAYLOAD if rank0 else None, len(PAYLOAD))
    P.sync_global_devices("t")
    out["barrier"] = True
    return out


def worker(rank: int, world: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    P.init_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        res = {}
        for shape in MESHES:
            res[shape] = run_cases(P.make_mesh(shape=shape, device="cpu"))
        torch.save(res, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def single() -> dict:
    """The cases on one device, no mesh: the per-item stages of the
    port's provers, its unsharded rings and provers."""
    out = {}
    params, prv = jindo_prover()
    st = prv.raw_stages()
    ck = prv.ck_device()

    def per_item(fn, *batched):
        items = [fn(*[b[i] for b in batched]) for i in range(len(batched[0]))]
        return tuple(torch.stack(o) for o in zip(*items))

    out["commit"] = per_item(lambda e, n: st["commit_core"](e, n, *ck),
                             *commit_inputs(params, 4, 3))
    out["commit_uneven"] = per_item(lambda e, n: st["commit_core"](e, n, *ck),
                                    *commit_inputs(params, 3, 5))
    left, enc, mlwe, chals = evaluate_inputs(params)
    out["evaluate"] = per_item(
        lambda en, ml: (st["partial"](left, en),
                        *st["response"](chals, en, ml)), enc, mlwe)
    bcase = buckler_case()
    bprv = bcase[0]
    w_planes, blinds, e, nz = round_inputs(bprv)
    ecd = [bprv.ecd.rand_encode(w_planes[i], blinds[i])
           for i in range(len(e))]
    bst = bprv.jindo.raw_stages()
    core = per_item(lambda a, b: bst["commit_core"](
        a, b, *bprv.jindo.ck_device()), e, nz)
    out["buckler_round"] = (
        torch.stack([x.coeffs for x in ecd]),
        torch.stack([bprv.poly_ring.ntt(x).coeffs for x in ecd]),
        core[2], core[3])
    out["buckler_prove"] = buckler_prove(bcase)
    out["jindo_roundtrip"] = jindo_roundtrip()
    return out
