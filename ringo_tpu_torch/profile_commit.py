"""Where the time of one Jindo commit goes on the card.

    python -m ringo_tpu_torch.profile_commit [--out DIR]

Builds the ZP255 prover at N = 2^19 on the card, commits once to warm
up, times three commits on the host clock (each ending in a synchronise),
then traces one commit with ``torch.profiler`` (CPU and CUDA).  Prints the
host time of each ``jindo.commit.*`` span, the device kernels by total
time, the device busy time (union of kernel and copy intervals), the
count of device operations and the idle share of the traced commit, and
writes them with the Chrome trace to ``--out``.  Needs a card; exits 2
without one.
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
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 16, (p.spec.w, 1 << LOG_N), dtype=np.int64)
    v[-1] %= int(p.spec.p_digits[-1])
    prv.commit(v)
    torch.cuda.synchronize()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        prv.commit(v)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prv.commit(v)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0

    spans = defaultdict(float)
    kernels = defaultdict(lambda: [0, 0.0])
    intervals = []
    for e in prof.events():
        dur = e.time_range.elapsed_us()
        on_dev = e.device_type != torch.autograd.DeviceType.CPU
        if e.name.startswith("jindo.commit."):
            spans[("device " if on_dev else "host ") + e.name] += dur
        elif on_dev:
            kernels[e.name][0] += 1
            kernels[e.name][1] += dur
            intervals.append((e.time_range.start, e.time_range.end))
    busy_us = _union_us(intervals)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:20]
    rec = dict(
        card=torch.cuda.get_device_name(0), log_n=LOG_N,
        crs_expand_s=crs_s, commit_wall_s=wall,
        commit_median_s=statistics.median(wall), traced_commit_s=traced_s,
        device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / 1e6 / traced_s,
        device_ops=sum(c for c, _ in kernels.values()),
        spans_ms={k: v / 1e3 for k, v in sorted(spans.items())},
        top_kernels=[dict(name=k[:120], calls=c, ms=t / 1e3)
                     for k, (c, t) in top],
        launches=dict(backend.LAUNCHES))
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "profile_commit_trace.json"))
    with open(os.path.join(args.out, "profile_commit.json"), "w") as f:
        json.dump(rec, f, indent=1)
    for k, v in rec["spans_ms"].items():
        print(f"{k:40s} {v:10.3f} ms")
    for k in rec["top_kernels"]:
        print(f"{k['ms']:10.3f} ms {k['calls']:5d}x  {k['name']}")
    print(json.dumps({k: rec[k] for k in (
        "card", "log_n", "crs_expand_s", "commit_median_s", "traced_commit_s",
        "device_busy_ms", "device_idle_share", "device_ops")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
