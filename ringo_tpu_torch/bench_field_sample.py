"""The field-sample kernel's device time (csrc/field_sample.cu), this
source's beside an earlier checkout's, in turns.

    python3 -m ringo_tpu_torch.bench_field_sample [--earlier DIR]

Builds csrc/field_sample.cu alone into a library per variant (this source
and, with --earlier DIR, that checkout's, e.g. an earlier commit unpacked
with ``git archive``; one nvcc each, at once) and prints each one's ptxas
registers, stack and spills.  At a Jindo commit's segments (N = 2^19,
ZP255), a PublicKey (13, ZP220) commitment's, a three-commit batch's and
Buckler's 40 one-lane blinds it draws the segments with each variant's C
entry from one read-ahead and first state, its arguments packed once by
the slot layout of that checkout's ``csprng/field_sample.py``, holds the
digits, bytes and end state to the plain version's, then times the
variants in turns (in order, then reversed) by CUDA events around calls
of the C entry: over back-to-back calls (``event_ms``, ``bench.time_ms``,
50 calls a window) and one call at a time after reading a 128 MB buffer
(``bench.cold_ms``) or after a wait on the card (``bench.warm_ms``).
Prints the card's name and power limit and one JSON object, and writes
the same to chiprun_out/bench_field_sample.json.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np


def cases():
    """(label, field spec, segments) of the timed draws."""
    from . import jindo
    from .bench import commit_segments
    from .fields import ZP220, ZP255

    jp = jindo.new_parameters(ZP255, 1 << 19, 1)
    pk = jindo.new_parameters(ZP220, 1 << 13, 1)
    r = pk.rank
    return [("Jindo commit N=2^19", ZP255, commit_segments(jp, [jp.rank])),
            ("PublicKey (13, ZP220) commitment", ZP220, commit_segments(pk, [r])),
            ("PublicKey three-commit batch", ZP220,
             commit_segments(pk, [r, r // 2, 1000])),
            ("blinds (40 one-lane segments)", ZP220, [("field", 1)] * 40)]


def load_module(root: str):
    """That checkout's csprng/field_sample.py, for its slot layout."""
    path = os.path.join(root, "ringo_tpu_torch", "csprng", "field_sample.py")
    spec = importlib.util.spec_from_file_location(
        f"field_sample_{abs(hash(root))}", path,
        submodule_search_locations=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "ringo_tpu_torch.csprng"
    spec.loader.exec_module(mod)
    return mod


def pack(fsm, D, st0):
    """(the C entry's int64 arguments in the layout of module ``fsm`` for
    a launch from state ``st0`` over D's tensors, the scratch area where
    that layout has one, else None)."""
    import torch

    ext, start, avail = D.win
    w = D.spec.w
    a = np.zeros(fsm.A_LEN, dtype=np.int64)
    a[fsm.A_OUT], a[fsm.A_STRIDE] = D.out.data_ptr(), D.out.shape[1]
    a[fsm.A_RAW], a[fsm.A_WIN] = D.raw.data_ptr(), ext.data_ptr()
    a[fsm.A_START], a[fsm.A_AVAIL] = start, avail
    a[fsm.A_NEED], a[fsm.A_NMAX] = D.need.data_ptr(), D.need.shape[1]
    a[fsm.A_SEGS], a[fsm.A_NSEG] = D.segs_dev.data_ptr(), len(D.tab)
    a[fsm.A_W], a[fsm.A_TOP_MASK] = w, D.top_mask
    a[fsm.A_ST_OUT] = D.st_dev.data_ptr()
    scr = None
    if hasattr(fsm, "A_SCRATCH"):
        cap = (avail // (2 * w) + 63) // 32 * 32
        scr = torch.empty(fsm.scratch_ints(cap), dtype=torch.int32,
                          device=ext.device)
        a[fsm.A_SCRATCH], a[fsm.A_SCRATCH_CAP] = scr.data_ptr(), cap
    a[fsm.A_P:fsm.A_P + w] = D.spec.p_digits
    a[fsm.A_ST:] = st0
    return a, scr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_field_sample: CUDA is not available", file=sys.stderr)
        return 2
    from . import backend, bench
    from .bench_bigfield import build_variants
    from .csprng import field_sample
    from .csprng.uniform import UniformSampler

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    roots = ([("earlier", os.path.abspath(args.earlier))] if args.earlier else [])
    roots.append(("shipped", here))
    built = build_variants(
        [(n, os.path.join(r, "ringo_tpu_torch", "csrc", "field_sample.cu"))
         for n, r in roots], entry="ringo_field_sample", kernels=("field_sample",))
    mods = {n: (field_sample if n == "shipped" else load_module(r))
            for n, r in roots}
    rec = dict(card=smi, ptxas={n: u for n, _, u in built}, draws=[])
    stream = backend.stream_ptr(torch.empty(1, device="cuda"))
    for label, spec, segs in cases():
        D = field_sample._Draw(spec, UniformSampler(
            b"field bench " + label.encode(), device="cuda"), segs)
        D.open(D.budget())
        st0 = D.st.copy()
        field_sample.launch_args(D)       # the device state and segment table
        field_sample.field_sample_plain(D)
        want_st, out, raw = D.st.copy(), D.out.clone(), D.raw.clone()
        calls = {}
        for name, fn, _ in built:
            a, scr = pack(mods[name], D, st0)
            D.out.zero_()
            D.raw.zero_()
            calls[name] = (fn, a, scr)
            backend.check(fn(a.ctypes.data, stream), f"{name} {label}")
            torch.cuda.synchronize()
            if not (torch.equal(D.out, out) and torch.equal(D.raw, raw) and
                    np.array_equal(D.st_dev.cpu().numpy(), want_st)):
                raise AssertionError(f"field sample {label}: variant {name} "
                                     "differs from the plain version")
        times = {name: [] for name, _, _ in built}
        cold = {name: [] for name, _, _ in built}
        warm = {name: [] for name, _, _ in built}
        for name, _, _ in built + built[::-1]:
            fn, a, _ = calls[name]

            def call():
                backend.check(fn(a.ctypes.data, stream), label)

            times[name].append(bench.time_ms(call, reps=50, windows=5))
            cold[name].append(bench.cold_ms(call))
            warm[name].append(bench.warm_ms(call))
        row = dict(label=label, segments=len(segs), rounds=int(want_st[
            field_sample.S_ROUNDS]), used=int(want_st[field_sample.S_OFF]),
            event_ms=times, cold_ms=cold, warm_ms=warm)
        rec["draws"].append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "bench_field_sample.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
