"""Host cost a call of the big-field wrappers on the card, and the
``mul_mod`` / ``reduce_cols`` kernels' device time, this source's beside
an earlier one's.

    python3 -m ringo_tpu_torch.bench_bigfield [--earlier DIR]
    python3 -m ringo_tpu_torch.bench_bigfield --kernels [--earlier DIR]

Host microseconds a call of ``fields/bigfield.py``'s wrappers at a
2^10-lane shape ([16, 2^10] ZP255, where the kernel takes a few
microseconds), back to back, and the split of one ``mul_mod`` call into
its parts (argument checks, layout and header, ``torch.empty``, the
stream, the ctypes call alone).  The parts are those of the wrapper
found: the header built per call (``pack``) or kept per layout
(``_header``).  Each part runs 400 times in a row, fewer than the launch
queue holds, so the host, not the card, sets the loop's time.
--earlier DIR: the same measurement of the package in DIR (a checkout, for
instance an earlier commit unpacked with ``git archive``) in a
subprocess, in turns: earlier, this, this, earlier.

--kernels: csrc/bigfield.cu built alone into a library per variant (this
source, and with --earlier DIR that checkout's), each variant's
registers, stack and spills from ptxas (the mul_mod, reduce_cols, horner
and powers kernels at every width), its mul_mod at [16, 2^19] (ZP255)
and [14, 4, 2^15] x [14, 1, 2^15] (ZP220, the Buckler ring), reduce_cols
at [29, 32, 2048] (ZP220, BigLinMap's 2w + 1 columns), HORNER at [16, 1,
2^19] (the Jindo evaluate) and [14, 4, 2^15], POWERS at [14, 2^15]
(the PublicKey prove and verify) and TREE_SUM at [14, 4, 2^15] and [16, 1,
2^19] held exactly against the plain
versions, then timed in turns (the variants in order, then reversed) by
CUDA events around calls of the C entry point
(no wrapper): over back-to-back calls (``event_ms``, ``bench.time_ms``
with 50 calls a window: the operands stay in the 50 MB L2 between calls
where they fit) and one call at a time after
reading a 128 MB buffer (``bench.cold_ms``: operands in device memory) or
after a wait on the card that reads nothing (``bench.warm_ms``: operands
left in L2 by the last call, where they fit); beside
them the shipped wrapper's time by ``bench.time_ms``, which chip_smoke.py
reports (its host cost a call bounds it where the kernel is shorter), and
the three timings' floor: a one-element fill timed the same ways.

Prints the card's name and power limit and one JSON object, and writes
the same to chiprun_out/bench_bigfield.json (--kernels:
chiprun_out/bench_bigfield_kernels.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

REPS = 400


def per_call_us(fn, reps: int = REPS) -> float:
    """Host microseconds a call of ``fn`` over ``reps`` calls in a row,
    after a warm-up; the card is drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def wrapper_costs(root: str) -> dict:
    """The host cost of the wrappers of the package under ``root``."""
    sys.path.insert(0, root)
    import torch

    from ringo_tpu_torch import backend
    from ringo_tpu_torch.fields import ZP255, bigfield, limb
    from ringo_tpu_torch.ops import horner
    from ringo_tpu_torch.ops.bigmul import BigMul

    backend.lib()
    big, w, n = BigMul(ZP255), ZP255.w, 1 << 10
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 1 << 15, (w, n), generator=gen).to("cuda")
    y = torch.randint(0, 1 << 15, (w, n), generator=gen).to("cuda")
    q = torch.tensor(big.p_digits, device="cuda").reshape(w, 1)
    x3 = x.reshape(w, 4, n // 4)
    plan = horner.HornerPlan(ZP255)
    steps = plan.steps_for(12345, n).to("cuda")
    rec = dict(root=root, calls={}, mul_mod_parts={})
    calls = rec["calls"]
    calls["mul_mod"] = per_call_us(lambda: big.mul_mod(x, y))
    calls["add"] = per_call_us(lambda: limb.add(x, y, q))
    calls["tree_sum [16, 4, 256]"] = per_call_us(lambda: horner.tree_sum(big, x3))
    calls["eval_stacked [16, 4, 256]"] = per_call_us(
        lambda: plan.eval_stacked(x3, steps))
    launches = backend.LAUNCHES["bigfield"]
    plan.eval_stacked(x3, steps)
    rec["eval_stacked_launches"] = backend.LAUNCHES["bigfield"] - launches

    parts = rec["mul_mod_parts"]
    cst = big.consts
    lib = backend.lib().ringo_bigfield
    out = torch.empty((w, n), dtype=torch.int64, device="cuda")
    stream = backend.stream_ptr(x)
    parts["check"] = per_call_us(lambda: bigfield._check((x, y), "mul_mod", w))
    parts["torch.empty"] = per_call_us(
        lambda: torch.empty((w, n), dtype=torch.int64, device="cuda"))
    parts["stream pointer"] = per_call_us(lambda: backend.stream_ptr(x))
    parts["data_ptr x3"] = per_call_us(
        lambda: (out.data_ptr(), x.data_ptr(), y.data_ptr()))
    if hasattr(bigfield, "_header"):
        key = (bigfield.MUL_MOD, w, 0, w, bigfield._key((x, y)))
        parts["key"] = per_call_us(lambda: bigfield._key((x, y)))
        parts["header lookup"] = per_call_us(lambda: bigfield._header(key, None))
        addr = bigfield._header(key, None)[1]
        parts["ctypes call"] = per_call_us(lambda: lib(
            bigfield.MUL_MOD, addr, big.consts_addr, out.data_ptr(),
            x.data_ptr(), y.data_ptr(), 0, 0, 0, stream))
    else:
        parts["operand_layout"] = per_call_us(lambda: bigfield.operand_layout(x, y))
        parts["pack (layout + header)"] = per_call_us(
            lambda: bigfield.pack(w, (x, y)))
        _, _, hdr = bigfield.pack(w, (x, y))
        hdr[bigfield.H_OUT] = out.data_ptr()
        parts["header and constants addresses"] = per_call_us(
            lambda: (hdr.ctypes.data, cst.ctypes.data))
        parts["backend.lib()"] = per_call_us(backend.lib)
        parts["ctypes call"] = per_call_us(lambda: lib(
            bigfield.MUL_MOD, hdr.ctypes.data, cst.ctypes.data, stream))
    return rec


BIGFIELD_KERNELS = ("mul_mod", "reduce_cols", "horner", "powers")


def build_variants(variants, entry: str = "ringo_bigfield",
                   kernels=BIGFIELD_KERNELS) -> list:
    """[(name, source)] -> [(name, ctypes function ``entry``, ptxas usage
    of the ``<kind>_kernel``s of ``kernels``)]: one nvcc each, all at
    once."""
    from . import backend

    os.makedirs(backend.BUILD_DIR, exist_ok=True)
    procs = []
    for k, (name, src) in enumerate(variants):
        so = os.path.join(backend.BUILD_DIR, f"{entry}_variant{k}.so")
        procs.append((name, so, subprocess.Popen(
            [backend._nvcc(), *backend.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", src, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    out = []
    for name, so, pr in procs:
        text = pr.communicate()[0].decode(errors="replace")
        if pr.returncode != 0:
            raise RuntimeError(f"nvcc of variant {name} failed:\n{text}")
        usage = {k: v for k, v in backend.parse_ptxas(text).items()
                 if any(f"{kind}_kernel" in k for kind in kernels)}
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = [backend._CT[c] for c in backend._SIGNATURES[entry]]
        fn.restype = ctypes.c_int
        out.append((name, fn, usage))
    return out


def kernel_cases():
    """(label, BigMul, op, operands, m, wrapper call, plain version) at
    the shapes the main paths give mul_mod, reduce_cols, HORNER (m: the
    coefficients), POWERS (m: the powers) and TREE_SUM (the verifier's
    decoded-evaluation sum and the PublicKey ring's)."""
    import torch

    from .fields import ZP220, ZP255, bigfield
    from .ops import horner
    from .ops.bigmul import BigMul

    gen = torch.Generator().manual_seed(15)

    def planes(spec, shape):
        d = torch.randint(0, 1 << 16, (spec.w,) + shape, generator=gen)
        d[-1] %= spec.p >> (16 * (spec.w - 1))
        return d.to("cuda")

    b255, b220 = BigMul(ZP255), BigMul(ZP220)
    x, y = planes(ZP255, (1 << 19,)), planes(ZP255, (1 << 19,))
    v, P = planes(ZP220, (4, 1 << 15)), planes(ZP220, (1 << 15,))[:, None, :]
    cols = torch.randint(0, 1 << 18, (2 * ZP220.w + 1, 32, 2048),
                         generator=gen).to("cuda")
    h255, h220 = horner.HornerPlan(ZP255), horner.HornerPlan(ZP220)
    pt = 0x1234567890ABCDEF1234567890ABCDEF
    s255 = h255.steps_for(pt % ZP255.p, 1 << 19).to("cuda")
    s220 = h220.steps_for(pt % ZP220.p, 1 << 15).to("cuda")
    xv = x[:, None, :]
    return [
        ("mul_mod ZP255 [16, 2^19]", b255, bigfield.MUL_MOD, (x, y), 0,
         lambda: b255.mul_mod(x, y), lambda: b255.mul_mod_plain(x, y)),
        ("mul_mod ZP220 [14, 4, 2^15] x [14, 1, 2^15]", b220, bigfield.MUL_MOD,
         (v, P), 0, lambda: b220.mul_mod(v, P), lambda: b220.mul_mod_plain(v, P)),
        ("reduce_cols ZP220 [29, 32, 2048]", b220, bigfield.REDUCE_COLS, (cols,),
         cols.shape[0], lambda: b220.reduce_cols(cols),
         lambda: b220.reduce_cols_plain(cols)),
        ("HORNER ZP255 [16, 1, 2^19]", b255, bigfield.HORNER, (xv, s255),
         1 << 19, lambda: h255.eval_stacked(xv, s255),
         lambda: h255.eval_stacked_plain(xv, s255)),
        ("HORNER ZP220 [14, 4, 2^15]", b220, bigfield.HORNER, (v, s220),
         1 << 15, lambda: h220.eval_stacked(v, s220),
         lambda: h220.eval_stacked_plain(v, s220)),
        ("POWERS ZP220 [14, 2^15]", b220, bigfield.POWERS, (s220,), 1 << 15,
         lambda: bigfield.powers_cuda(b220, s220, 1 << 15),
         lambda: h220.powers_plain(s220, 1 << 15)),
        ("TREE_SUM ZP220 [14, 4, 2^15]", b220, bigfield.TREE_SUM, (v,), 0,
         lambda: horner.tree_sum(b220, v), lambda: horner.tree_sum_plain(b220, v)),
        ("TREE_SUM ZP255 [16, 1, 2^19]", b255, bigfield.TREE_SUM, (xv,), 0,
         lambda: horner.tree_sum(b255, xv),
         lambda: horner.tree_sum_plain(b255, xv)),
    ]


def kernel_times(args, here: str, rec: dict) -> None:
    """--kernels: the variants' ptxas usage, exactness and times."""
    import torch

    from . import backend, bench
    from .fields import bigfield

    src = os.path.join(here, "ringo_tpu_torch", "csrc", "bigfield.cu")
    variants = []
    if args.earlier:
        variants.append(("earlier", os.path.join(
            os.path.abspath(args.earlier), "ringo_tpu_torch", "csrc",
            "bigfield.cu")))
    variants.append(("shipped", src))
    # the package's own library (the wrapper's) builds beside the variants
    lib = threading.Thread(target=backend.build)
    lib.start()
    built = build_variants(variants)
    lib.join()
    rec["ptxas"] = {name: usage for name, _, usage in built}
    stream = backend.stream_ptr(torch.empty(1, device="cuda"))
    # the method's floor: a one-element fill, timed the same three ways
    one = torch.zeros(1, device="cuda")
    rec["floor"] = dict(label="one-element fill", event_ms=bench.time_ms(
        one.zero_, reps=50, windows=5), cold_ms=bench.cold_ms(one.zero_),
        warm_ms=bench.warm_ms(one.zero_))
    print(json.dumps(rec["floor"]), flush=True)
    rec["kernels"] = []
    for label, big, op, ts, m, wrapped, plain in kernel_cases():
        want = plain()
        n = want[0].numel()
        hdr, ptrs, scratch, count = bigfield.launch_args(big, op, ts, m)
        out = torch.empty_like(want)

        def call(fn):
            backend.check(fn(op, hdr.ctypes.data, big.consts_addr,
                             out.data_ptr(), *ptrs, scratch, count, stream),
                          label)

        for name, fn, _ in built:
            out.zero_()
            call(fn)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                bad = int((out != want).any(0).sum())
                raise AssertionError(f"{label}: variant {name} differs from "
                                     f"the plain version in {bad} of {n} lanes")
        times: dict = {name: [] for name, _, _ in built}
        cold: dict = {name: [] for name, _, _ in built}
        warm: dict = {name: [] for name, _, _ in built}
        for name, fn, _ in built + built[::-1]:
            times[name].append(bench.time_ms(lambda: call(fn), reps=50,
                                             windows=5))
            cold[name].append(bench.cold_ms(lambda: call(fn)))
            warm[name].append(bench.warm_ms(lambda: call(fn)))
        row = dict(label=label, lanes=n, event_ms=times, cold_ms=cold,
                   warm_ms=warm,
                   wrapper_time_ms=bench.time_ms(wrapped))
        rec["kernels"].append(row)
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.root:                   # the subprocess of --earlier
        print(json.dumps(wrapper_costs(args.root)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_bigfield: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.kernels:
        rec: dict = {"card": smi}
        kernel_times(args, here, rec)
        os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
        with open(os.path.join(here, "chiprun_out",
                               "bench_bigfield_kernels.json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(smi)
        print(json.dumps(rec))
        return 0
    rec = {"card": smi, "wrapper": []}

    def earlier():
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root",
             os.path.abspath(args.earlier)],
            capture_output=True, text=True, check=True)
        rec["wrapper"].append(json.loads(res.stdout.strip().splitlines()[-1]))

    if args.earlier:
        earlier()
    rec["wrapper"].append(wrapper_costs(here))
    rec["wrapper"].append(wrapper_costs(here))
    if args.earlier:
        earlier()
    for r in rec["wrapper"]:
        print(json.dumps(r), flush=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "bench_bigfield.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
