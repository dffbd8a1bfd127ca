"""Where the time of a Jindo commit, evaluate and verify goes on the card.

    python -m ringo_tpu_torch.profile_commit [--out DIR]

Builds the ZP255 prover and verifier at N = 2^19 on the card and, for each
of ``commit``, ``evaluate`` and ``verify``: calls it once to warm up, times
three calls on the host clock (each ending in a synchronise), then traces
one call with ``torch.profiler`` (CPU and CUDA).  Prints the host time of
each ``jindo.<phase>.*`` span, the device kernels by total time, the device
busy time (union of kernel and copy intervals), the count of device
operations and the idle share of the traced call, and writes them to
``--out``/profile_commit.json.  The Chrome trace is written for the commit
only (an evaluate makes tens of thousands of launches, and its trace is
tens of MB).  Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

LOG_N = 19  # the main path's size
PHASES = ("commit", "evaluate", "verify")


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profile_call(phase: str, fn, trace_path: str | None = None) -> dict:
    """Warm up, time and trace ``fn``; ``phase`` names its spans
    (``jindo.<phase>.*``)."""
    from . import backend

    fn()
    torch.cuda.synchronize()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0

    prefix = f"jindo.{phase}."
    spans = defaultdict(float)
    kernels = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        on_dev = e.device_type != torch.autograd.DeviceType.CPU
        if e.name.startswith(prefix):
            spans[("device " if on_dev else "host ") + e.name] += dur
        elif on_dev:
            kernels[e.name][0] += 1
            kernels[e.name][1] += dur
            intervals.append((e.time_range.start, e.time_range.end))
    busy_us = _union_us(intervals)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:20]
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    return dict(
        wall_s=wall, median_s=statistics.median(wall), traced_s=traced_s,
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / traced_s,
        device_ops=sum(c for c, _ in kernels.values()),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        spans_ms={k: v / 1e3 for k, v in sorted(spans.items())},
        top_kernels=[dict(name=k[:120], calls=c, ms=t / 1e3)
                     for k, (c, t) in top],
        launches=dict(backend.LAUNCHES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ringo_tpu_torch.profile_commit")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_commit: CUDA is not available", file=sys.stderr)
        return 2
    from . import backend, jindo
    from .fields import ZP255

    backend.lib()
    p = jindo.new_parameters(ZP255, 1 << LOG_N, 1)
    t0 = time.perf_counter()
    ck = jindo.CommitKey(p, b"Jindo!", device="cuda")
    crs_s = time.perf_counter() - t0
    prv = jindo.Prover(p, b"Jindo!", seed=b"profile", device="cuda", ck=ck)
    vrf = jindo.Verifier(p, b"Jindo!", device="cuda", ck=ck)
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 16, (p.spec.w, 1 << LOG_N), dtype=np.int64)
    v[-1] %= int(p.spec.p_digits[-1])
    x = int.from_bytes(b"profile evaluation point 0123456", "big") % p.spec.p
    com, op = prv.commit(v)
    ys, pf = prv.evaluate(x, [v], [com], [op])

    def verify():
        if vrf.verify(x, [com], ys, pf) is not True:
            raise AssertionError("verify rejected an honest proof")

    calls = dict(commit=lambda: prv.commit(v),
                 evaluate=lambda: prv.evaluate(x, [v], [com], [op]),
                 verify=verify)
    os.makedirs(args.out, exist_ok=True)
    traces = dict(commit=os.path.join(args.out, "profile_commit_trace.json"))
    rec = dict(card=torch.cuda.get_device_name(0), log_n=LOG_N,
               crs_expand_s=crs_s)
    for phase in PHASES:
        r = rec[phase] = profile_call(phase, calls[phase], traces.get(phase))
        print(f"== {phase}")
        for k, t in r["spans_ms"].items():
            print(f"{k:40s} {t:10.3f} ms")
        for k in r["top_kernels"]:
            print(f"{k['ms']:10.3f} ms {k['calls']:5d}x  {k['name']}")
    with open(os.path.join(args.out, "profile_commit.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for phase in PHASES:
        r = rec[phase]
        print(json.dumps(dict(
            phase=phase, card=rec["card"], log_n=LOG_N,
            **{k: r[k] for k in ("median_s", "traced_s", "device_busy_ms",
                                 "device_idle_share", "device_ops",
                                 "peak_mem_gib", "launches")})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
