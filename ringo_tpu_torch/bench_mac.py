"""The Ajtai MAC kernel (csrc/mac.cu) on the card: held against its plain
version at the main paths' shapes, and timed beside its bound and the
float64 route it replaced.

    python3 -m ringo_tpu_torch.bench_mac [--check]

For every MAC launch of a commit (t = 1 and a ``commit_many`` of 4), an
evaluate and a verify at ZP255, N = 2^19 (and of the batch of 2, whose
parameters have other rings), and of a PublicKey (13, ZP220) prove and
verify (commits of 4 and 1), in the call site's layout (``mac_shapes``),
and at K = KERNEL_MAX_K with q - 1 throughout: random residues with q - 1
in one key row and one input lane, the kernel (``mod_mac_cuda`` on
``folded``) equal to the plain version (``mod_mac_plain``, the float64
product on the card) and to ``bench.mac_plain`` (int64, one k at a time); then, without --check, by CUDA events (``timings``): in turns,
the kernel's C entry with its arguments packed once back to back
(``device_ms``), the wrapper back to back (``ms``) and the float64 route's
``torch.matmul`` of held planes by the byte planes plus the recombine
(``library_ms``: the yardstick, which the port never calls on the card);
the C entry one call at a time after reading 128 MB (``cold_ms``) and the
plain version; beside the bound of the function's bytes
(``bench.mac_work``).  Logs the kernels' registers, stack and spills from
ptxas and fails on local memory.  Prints the card's name and power limit
and one JSON object, and writes it to chiprun_out/bench_mac.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# the two largest primes below 2^31 that are 1 mod 512: q - 1 at its widest
TOP_PRIMES = (2147483137, 2147478017)


def mac_shapes(p, ts) -> list:
    """(label, ring attribute, J, K, n, layout) of the MAC launches of the
    commits of ``ts`` items, an evaluate and a verify on Jindo parameters
    ``p``, read off jindo/stages.py and jindo/verifier.py.  The layout is
    how the call site hands x over: "cat" contiguous, "t12" a transposed
    [L, n, K, d], "slice" the first K of K + 1 rows, "col" [L, K, d] with a
    unit n axis."""
    B, R, cols = p.cols + 1, p.rows, p.cols
    J, KK = p.in_msis_rank, p.rows + p.mlwe_rank
    outR, dcmp = p.out_msis_rank, p.in_com_dcmp_len
    out = []
    for t in ts:
        out += [(f"commit inner t={t}", "ring_q", J, KK, t * B, "cat"),
                (f"commit outer t={t}", "ring_q_out", outR, dcmp, t, "t12")]
    out += [("evaluate partial", "ring_q", 1, R, B, "t12"),
            ("evaluate response encode", "ring_q", 1, cols, R, "slice"),
            ("evaluate response mlwe", "ring_q", 1, cols, p.mlwe_rank + J,
             "slice"),
            ("verify outer", "ring_q_out", outR, dcmp, 1, "col"),
            ("verify challenges", "ring_q", 1, cols, J, "slice"),
            ("verify inner", "ring_q", J, KK, 1, "col"),
            ("verify left", "ring_q", 1, R, 1, "col"),
            ("verify partial", "ring_q", 1, cols, 1, "col")]
    if p.batch > 1:
        out.append(("verify batch", "ring_q_out", 1, p.batch, outR, "cat"))
    return out


def mac_key(primes, J: int, x) -> tuple:
    """What tells the work of one MAC launch from another's: the primes,
    the key rows, x's K and n, and the kernel's branch for x's layout
    (csrc/mac.cu ``ringo_mac``'s kn_order: n's stride at most k's)."""
    _, K, n, _ = x.shape
    return ("mac", tuple(int(q) for q in primes), J, K, n,
            int(x.stride(2) <= x.stride(1)))


def inputs(rg, J: int, K: int, n: int, layout: str, gen, extreme=False):
    """Key residues [L, J, K, d] and x [L, K, n, d] in ``layout`` on the
    card, below each prime; q - 1 in key row 0 and in x's lane (0, 0), or
    everywhere when ``extreme``."""
    import torch

    q = torch.tensor(rg.primes, dtype=torch.int64).reshape(-1, 1, 1, 1)
    L, d = rg.L, rg.d

    def draw(*shape):
        return (torch.randint(0, 1 << 62, (L, *shape), generator=gen)
                % q.reshape(-1, *([1] * len(shape)))).to(torch.int32)

    key = draw(J, K, d)
    if layout == "t12":
        x = draw(n, K, d).transpose(1, 2)
    elif layout == "slice":
        x = draw(K + 1, n, d)[:, :K]
    elif layout == "col":
        x = draw(K, d)[:, :, None, :]
    else:
        x = draw(K, n, d)
    q1 = (q.reshape(-1) - 1).to(torch.int32)
    if extreme:
        key[:] = q1.reshape(-1, 1, 1, 1)
        x[:] = q1.reshape(-1, 1, 1, 1)
    else:
        key[:, 0] = q1.reshape(-1, 1, 1)
        x[:, :, 0, 0] = q1.reshape(-1, 1)
    return key.to("cuda"), x.to("cuda")


def hold(rg, key, x) -> tuple[int, object]:
    """(the larger of max |kernel - plain| and max |kernel -
    bench.mac_plain|, the folded key); raises unless both are 0."""
    import torch

    from . import bench
    from .ops import mac_matmul

    kres = mac_matmul.folded(rg, key)
    got = mac_matmul.mod_mac_cuda(rg, kres, x)
    want = mac_matmul.mod_mac_plain(rg, kres, x)
    ints = bench.mac_plain(rg, key, x)
    torch.cuda.synchronize()
    errs = []
    for w, what in ((want, "plain version"), (ints, "bench.mac_plain")):
        err = int((got.long() - w.long()).abs().max().item()) if got.numel() else 0
        if err or got.shape != w.shape:
            raise AssertionError(f"MAC kernel != {what} ({int((got != w).sum())} "
                                 f"of {got.numel()} lanes)")
        errs.append(err)
    return max(errs), kres


def c_entry(rg, kres, x):
    """A call of the C entry ``ringo_mac`` with the wrapper's arguments
    packed once (the call holds its output): the kernel's device time
    without the wrapper's host work."""
    import torch

    from . import backend
    from .ops import mac_matmul

    L, K, n, _ = x.shape
    J = kres.shape[1]
    fn = backend.lib().ringo_mac
    consts = mac_matmul._consts_on(rg, x.device)
    out = torch.empty((L, J, n, x.shape[3]), dtype=torch.int32, device=x.device)
    args = (kres.data_ptr(), x.data_ptr(), consts.data_ptr(), out.data_ptr(),
            L, J, K, n, x.stride(0), x.stride(1), x.stride(2),
            backend.stream_ptr(x))

    def call(out=out):
        backend.check(fn(*args), "mac")
    return call


def timings(rg, key, x, kres) -> dict:
    """In turns (kernel, float64 route, kernel, float64 route): the
    kernel's C entry back to back (``device_ms``), the wrapper back to back
    (``ms``), the float64 route (its planes held); then the C entry one
    call at a time after reading 128 MB (``cold_ms``) and the plain version
    (which builds the planes each call); beside the bound of the function's
    bytes."""
    import torch

    from . import bench
    from .ops import mac_matmul

    L, K, n, d = x.shape
    J = key.shape[1]
    planes = mac_matmul.key_planes(rg, kres)
    corr = mac_matmul.fold_corr(planes)
    xa = mac_matmul.byte_planes(x.permute(0, 3, 1, 2), dim=2)
    call = c_entry(rg, kres, x)

    def kernel():
        return mac_matmul.mod_mac_cuda(rg, kres, x)

    def route():   # the float64 product of held planes, and the recombine
        t = torch.matmul(planes, xa).to(torch.int64) + corr[..., None]
        t = t.reshape(L, d, mac_matmul.P7, J, n).permute(0, 3, 4, 2, 1)
        return mac_matmul.recombine_mod_q(rg.q, t.reshape(L, J, n, -1), d)

    dev, ms, lib = [], [], []
    for _ in range(2):
        dev.append(bench.time_ms(call))
        ms.append(bench.time_ms(kernel))
        lib.append(bench.time_ms(route, reps=3))
    cold = bench.cold_ms(call)
    plain = bench.time_ms(lambda: mac_matmul.mod_mac_plain(rg, kres, x),
                          reps=3)
    b, by = bench.bound_ms(*bench.mac_work(L, d, J, K, n))
    del xa, planes
    return dict(ms=min(ms), device_ms=min(dev), device_turns=dev,
                cold_ms=cold, plain_ms=plain, library_ms=min(lib),
                library_turns=lib, bound_ms=b, bound_by=by,
                cold_share=b / cold)


def kernel_usage() -> dict:
    """ptxas's registers, stack and spills of every ``mac_kernel``;
    raises on local memory."""
    from . import backend

    usage = {k: v for k, v in backend.kernel_resources().items()
             if "mac_kernel" in k}
    if not usage:
        raise AssertionError("ptxas reported no mac_kernel")
    for k, v in usage.items():
        if v["stack"] or v["spill_stores"] or v["spill_loads"] or v["lmem"]:
            raise AssertionError(f"{k}: local memory {v}")
    return usage


def cases(check: bool):
    """(parameter tag, Jindo parameters, commit sizes) whose MAC shapes
    are held and timed."""
    from . import jindo
    from .fields import ZP220, ZP255

    out = [("ZP255 N=2^19 t=1", jindo.new_parameters(ZP255, 1 << 19, 1), (1, 4))]
    if not check:
        out += [("ZP255 N=2^19 batch 2", jindo.new_parameters(ZP255, 1 << 19, 2),
                 (1, 2)),
                ("PublicKey (13, ZP220)", jindo.new_parameters(ZP220, 16512, 9),
                 (4, 1))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="hold the shapes of one parameter set; no timing")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_mac: CUDA is not available", file=sys.stderr)
        return 2
    from . import backend
    from .ops import mac_matmul
    from .rings import rns

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    backend.lib()
    rec = {"card": smi, "ptxas": kernel_usage(), "shapes": []}
    print(json.dumps(rec["ptxas"]), flush=True)
    gen = torch.Generator().manual_seed(17)
    for tag, p, ts in cases(args.check):
        rings = {"ring_q": p.ring_q.on("cuda"), "ring_q_out": p.ring_q_out.on("cuda")}
        for label, which, J, K, n, layout in mac_shapes(p, ts):
            rg = rings[which]
            key, x = inputs(rg, J, K, n, layout, gen)
            err, kres = hold(rg, key, x)
            row = dict(params=tag, label=label, L=rg.L, J=J, K=K, n=n,
                       layout=layout, tile=mac_matmul.tiles(J, n),
                       max_abs_err=err)
            if not args.check:
                row.update(timings(rg, key, x, kres))
            rec["shapes"].append(row)
            print(json.dumps(row), flush=True)
            del key, x, kres
            torch.cuda.empty_cache()
    # the int32 and reduction bounds: K = MAX_K, q - 1 throughout
    top = rns.RnsRing(256, TOP_PRIMES, "cuda")
    for n in (1, 8):
        key, x = inputs(top, 1, mac_matmul.KERNEL_MAX_K, n, "cat", gen,
                        extreme=True)
        err = hold(top, key, x)[0]
        row = dict(params="q < 2^31", label=f"K = {mac_matmul.KERNEL_MAX_K}, q - 1, n={n}", L=2,
                   J=1, K=mac_matmul.KERNEL_MAX_K, n=n, max_abs_err=err)
        rec["shapes"].append(row)
        print(json.dumps(row), flush=True)
        del key, x
        torch.cuda.empty_cache()
    with open(os.path.join(here, "chiprun_out", "bench_mac.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in rec.items() if k != "shapes"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
