"""Host cost a call of the big-field wrappers on the card.

    python3 -m ringo_tpu_torch.bench_bigfield [--earlier DIR]

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

Prints the card's name and power limit and one JSON object, and writes
the same to chiprun_out/bench_bigfield.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier")
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
    rec: dict = {"card": smi, "wrapper": []}

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
