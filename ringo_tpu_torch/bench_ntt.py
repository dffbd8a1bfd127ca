"""Checks and times the matmul-NTT kernel (csrc/ntt_mform.cu) on the card.

    python3 -m ringo_tpu_torch.bench_ntt [--check] [--steps] [--earlier DIR]
                                         [--variant NAME=SOURCE[,DEFINE...]]

Every result is held against ``ntt_mform_plain`` on the same inputs (exact
equality) before it is timed.  The shapes are those of the Jindo commit on
ZP255 at N = 2^19.

--check    a small shape first ([1, 64, 256], mismatches printed), then
           ragged row counts and the six shapes of the commit; no timing.
--steps    rebuilds the source with other compile-time constants and times
           the encode pass of each: one A stage and one tile pair per block
           (wgmma without a ring), four stages and one tile pair per block
           (the ring), and the shipped kernel (resident map slice,
           persistent blocks).
--variant  another source with the same C interface (an experiment on a
           copy of the kernel), built with the given -D defines, checked
           and timed in the same turns; may be given several times.
--earlier  a directory holding a checkout with the earlier mma.sync kernel
           (C interface v, planes_t, corr, q, out, L, n, stream; for
           instance that commit unpacked with ``git archive``); it is built
           and timed in turns with this one: earlier, this, this, earlier.

Prints the card's name and power limit and one JSON object, and writes
the same to chiprun_out/bench_ntt.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from . import backend, jindo
from .fields import ZP255
from .ops import ntt_matmul
from .rings.rns import RnsRing, ntt_friendly_primes

ROOT = os.path.dirname(backend.PKG_DIR)
SRC = os.path.join(backend.CSRC_DIR, "ntt_mform.cu")


def time_ms(fn, reps: int = 20, windows: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return float(np.median(out))


def residues(rg, n: int, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.tensor(rg.primes, dtype=torch.int64).reshape(-1, 1, 1)
    v = (torch.randint(0, 1 << 62, (rg.L, n, rg.d), generator=gen) % q
         ).to(torch.int32)
    v[:, 0, :4] = (q.reshape(-1) - 1).to(torch.int32)[:, None]
    return v.to(dev)


def commit_shapes(p):
    B, R = p.cols + 1, p.rows
    K = p.mlwe_rank + p.in_msis_rank
    return [("encode ntt", "q", "fwd", B * R), ("mlwe ntt", "q", "fwd", B * K),
            ("inner intt", "q", "inv", p.in_msis_rank * B),
            ("outer ntt", "out", "fwd", p.in_com_dcmp_len),
            ("outer intt", "out", "inv", p.out_msis_rank),
            ("final ntt", "out", "fwd", p.out_msis_rank)]


def check_equal(got, want, what: str, show: bool = False) -> None:
    if torch.equal(got, want):
        return
    bad = (got != want).nonzero()
    msg = f"{what}: {bad.shape[0]} of {got.numel()} lanes differ"
    if show:
        rows = sorted(set(bad[:, 1].tolist()))
        cols = sorted(set(bad[:, 2].tolist()))
        msg += (f"\n rows {rows[:70]}\n cols {cols[:70]}\n first "
                f"{bad[:8].tolist()}\n got {got[tuple(bad[0])].item()} want "
                f"{want[tuple(bad[0])].item()}")
    raise AssertionError(msg)


def build_variant(src: str, tag: str, defines: list[str]) -> ctypes.CDLL:
    """One nvcc of ``src`` alone into build/<tag>.so."""
    os.makedirs(backend.BUILD_DIR, exist_ok=True)
    so = os.path.join(backend.BUILD_DIR, f"ntt_{tag}.so")
    subprocess.run([backend._nvcc(), *backend.NVCC_FLAGS, *defines, "-shared",
                    src, "-o", so], check=True)
    return ctypes.CDLL(so)


def call_variant(handle, sig: str, args) -> None:
    fn = handle.ringo_ntt_mform
    fn.argtypes = [backend._CT[c] for c in sig]
    fn.restype = ctypes.c_int
    backend.check(fn(*args), "ntt_mform variant")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--earlier")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    dev = backend.resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    backend.build(verbose=True)
    p = jindo.new_parameters(ZP255, 1 << 19, 1)
    rings = {"q": p.ring_q.on(dev), "out": p.ring_q_out.on(dev)}
    rec: dict = {"card": smi}

    def run(rg, way, v):
        mm = rg._matmul_ntt()
        tab = getattr(mm, way)
        got = ntt_matmul.ntt_mform_cuda(v, tab, mm.q32)
        torch.cuda.synchronize()
        return got, ntt_matmul.ntt_mform_plain(v, tab, rg.q), tab, mm

    if args.check:
        rg = rings["q"]
        v = residues(rg, 64, 1, dev)[:1].contiguous()
        mm = rg._matmul_ntt()
        one = ntt_matmul._Map.__new__(ntt_matmul._Map)
        for name in ("planes", "planes_k", "corr", "mu"):
            setattr(one, name, getattr(mm.fwd, name)[:1].contiguous())
        one._planes_f64 = None
        got = ntt_matmul.ntt_mform_cuda(v, one, mm.q32[:1].contiguous())
        torch.cuda.synchronize()
        check_equal(got, ntt_matmul.ntt_mform_plain(v, one, rg.q[:1]),
                    "[1, 64, 256]", show=True)
        print("[1, 64, 256]: equal to plain", flush=True)
        for n in (1, 6, 63, 64, 65, 127, 129, 1000):
            got, want, _, _ = run(rg, "fwd", residues(rg, n, n, dev))
            check_equal(got, want, f"rows={n}", show=True)
        print("ragged row counts: equal to plain", flush=True)
        # both branches of the reduction: primes above and below 2^24
        for bits in (30, 20):
            rb = RnsRing(rg.d, ntt_friendly_primes(bits, 2 * rg.d, 2), dev)
            for way in ("fwd", "inv"):
                got, want, _, _ = run(rb, way, residues(rb, 129, bits, dev))
                check_equal(got, want, f"{bits}-bit primes {way}", show=True)
        print("30-bit and 20-bit primes: equal to plain", flush=True)

    shapes = {}
    for label, ring, way, n in commit_shapes(p):
        rg = rings[ring]
        v = residues(rg, n, 19, dev)
        got, want, tab, mm = run(rg, way, v)
        check_equal(got, want, label)
        if args.check:
            print(f"{label} rows={n}: equal to plain", flush=True)
            continue
        shapes[label] = dict(L=rg.L, rows=n, ms=time_ms(
            lambda: ntt_matmul.ntt_mform_cuda(v, tab, mm.q32)))
        print(label, shapes[label], flush=True)
    rec["shapes"] = shapes

    if args.steps or args.earlier or args.variant:
        rg = rings["q"]
        mm = rg._matmul_ntt()
        n = commit_shapes(p)[0][3]
        v = residues(rg, n, 19, dev)
        want = ntt_matmul.ntt_mform_plain(v, mm.fwd, rg.q)
        out = torch.empty_like(v)
        tail = (rg.L, n, backend.stream_ptr(v))
        new_args = (v.data_ptr(), mm.fwd.planes_k.data_ptr(),
                    mm.q32.data_ptr(), mm.fwd.mu.data_ptr(), out.data_ptr(),
                    *tail)
        variants = []
        if args.steps:
            big = "-DNTT_MAX_GROUPS=1048576"
            variants += [
                ("wgmma, 1 stage, tile pair per block", SRC,
                 ["-DNTT_A_STAGES=1", big], "pppppiip", new_args),
                ("wgmma, 4-stage ring, tile pair per block", SRC, [big],
                 "pppppiip", new_args)]
        variants.append(("shipped", SRC, [], "pppppiip", new_args))
        for spec in args.variant:
            name, _, rest = spec.partition("=")
            src, *defs = rest.split(",")
            variants.append((name, src, [f"-D{x}" for x in defs], "pppppiip",
                             new_args))
        if args.earlier:
            planes_t = mm.fwd.planes.transpose(1, 2).contiguous()
            variants.insert(0, (
                "earlier (mma.sync)", os.path.join(args.earlier, "ringo_tpu_torch", "csrc",
                                       "ntt_mform.cu"), [], "pppppiip",
                (v.data_ptr(), planes_t.data_ptr(), mm.fwd.corr.data_ptr(),
                 mm.q32.data_ptr(), out.data_ptr(), *tail)))
        built = []
        for i, (name, src, defs, sig, a) in enumerate(variants):
            h = build_variant(src, f"v{i}", defs)
            out.zero_()
            call_variant(h, sig, a)
            torch.cuda.synchronize()
            check_equal(out, want, name)
            built.append((name, h, sig, a))
        times: dict = {name: [] for name, *_ in built}
        for name, h, sig, a in built + built[::-1]:
            times[name].append(time_ms(lambda: call_variant(h, sig, a)))
        rec["encode_pass_ms"] = times
        print(json.dumps(times, indent=1), flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bench_ntt.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
