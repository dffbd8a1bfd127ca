"""The port's benchmark: one cell of BENCHMARK.json per process, on one card.

    python3 -m ringo_tpu_torch.bench --cell NAME [--seed S] [--reps R]

``NAME`` is a workload of ``BENCHMARK.json``; its configuration file
(``configs/``) gives the kind and the parameters:

* kind ``jindo`` (``field``, ``log_n``): the Jindo prover and verifier at
  t = 1.  Each sample commits to one polynomial of uniform field elements
  drawn as the JAX package's ``bench.py`` draws them
  (``random.Random(seed).randrange(p)``), evaluates it at one point and
  verifies the opening.  Metrics ``jindo_commit_coeffs_per_sec_logN<n>``
  (all the coefficients of the timed commits over their summed seconds),
  ``logN<n>_commit_s``, ``logN<n>_evaluate_s``, ``logN<n>_verify_s`` and
  ``jindo_setup_s`` (commit key, prover and verifier).
* kind ``buckler`` (``circuit``, ``field``, ``log_n``): a circuit of
  ``circuits.py`` built from the seed, compiled, then proved and verified
  each sample.  Metrics ``buckler_<circuit>_<n>_<bits>_prove_s``,
  ``..._verify_s`` and ``buckler_compile_s``.

Closed loop, one caller: one warm-up sample, then ``--reps`` timed ones,
each call on the host clock and ending in ``torch.cuda.synchronize()``,
with the span registry off and no profiler.  Every sample is checked (the
commitment and the proof re-parse, the evaluation equals Horner's rule in
Python ints, the proof verifies, a tampered one does not); at the seed of
the cell's digest file (``testdata/bench_digests/<cell>.json``) each
sample's outputs must equal the ones the JAX package computed for the same
sample of the same seeded prover.  Then one traced call of each operation
gives the per-layer numbers (``profile_commit.trace_call``: self time of
each span, device busy time, idle share and its longest stretches, device
operations, peak memory, kernel launches), and ``kernel_rows`` times the
three CUDA kernels and the inner MAC at the cell's commit shapes against
the card's bound for the function's work.

The last line of standard output is one JSON object: every metric by name
with its unit, value, median, quartiles and sample count, ``correct``, the
card (``hardware``), its power limit and the device count.  The whole
record goes to ``--out``/bench_<cell>.json.  Exits 2 without CUDA and 1
when a check failed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
DIGEST_DIR = os.path.join(PKG_DIR, "testdata", "bench_digests")

DEFAULT_SEED = 7      # bench.py's
DEFAULT_REPS = 10
X_POINT = 0x1234567890ABCDEF   # tools/bench_grid.py's evaluation point
JINDO_CRS = b"Jindo!"
BUCKLER_CRS = b"Buckler!"
CIRCUIT_TAGS = {"public_key": "pk"}   # the JAX grid's buckler_pk_* names


def prover_seed(seed: int) -> bytes:
    return b"bench" + str(seed).encode()


# ---------------------------------------------------------------- yardstick
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s.  32-bit integer
# operations: 132 SMs x 128 lanes x 1.98 GHz boost,
# one operation per lane and clock (the FP32 lane count; the data sheet's
# 67 TFLOP/s counts an FMA as two).  The white paper lists 64 INT32 lanes
# per SM, but the compiler fuses source operations (IADD3, LOP3, PRMT), so
# the larger rate is the one that keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9

# The work counts below are the function's, whatever implements it: each
# input read once, each output written once, the tables the function
# itself needs, and the least arithmetic.  A modular multiply-add counts
# as two 32-bit operations (a multiply and an add; the reduction is left
# out, so the count stays a lower bound).


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float = INT32_OPS_PER_S):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over ``ops_rate``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ntt_work(L: int, rows: int, d: int) -> tuple[int, int]:
    """ntt(mform(x)) of [L, rows, d] u32 residues: x in, the result out,
    d twiddles and q per prime; L * rows * (d / 2) * log2(d) butterflies
    (mform folds into the first stage's twiddles)."""
    n_bytes = 2 * L * rows * d * 4 + L * (d + 1) * 4
    return n_bytes, 2 * L * rows * (d // 2) * int(math.log2(d))


def chacha_work(keys: int, n_blocks: int) -> tuple[int, int]:
    """ChaCha20 keystreams of ``n_blocks`` 64-byte blocks for ``keys``
    32-byte keys: 10 double rounds of 8 quarter-rounds (4 adds, 4 xors, 4
    rotates each) and 16 final adds per block."""
    return keys * (32 + n_blocks * 64), keys * n_blocks * (80 * 12 + 16)


def twin_work(lanes: int, T: int, second: int) -> tuple[int, int]:
    """Twin-CDT search: per lane c0, c1 (int32) and u (u64) in and two
    int64 results out, the [128, T] u64 table once; a binary search of
    row c0 in each lane and of row c1 in the ``second`` lanes where it
    differs, floor(log2 T) probes each (the fewest a search of T entries
    takes), a probe a load, a compare and two selects."""
    return (lanes * (4 + 4 + 8 + 8 + 8) + 128 * T * 8,
            4 * (lanes + second) * int(math.log2(T)))


def mac_work(L: int, d: int, J: int, K: int, B: int) -> tuple[int, int]:
    """The Ajtai MAC out[l, j, b] = sum_k key[l, j, k] * x[l, k, b] mod q
    over d NTT slots: key, x and out as u32 residues, q per prime;
    L * d * J * K * B modular multiply-adds."""
    return 4 * L * d * (J * K + K * B + J * B) + 4 * L, 2 * L * d * J * K * B


# ---------------------------------------------------------- measurement

def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device):
    """(result, host seconds, peak GiB on the card or None) of one call
    that ends in a synchronise."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    s = time.perf_counter() - t0
    return out, s, (torch.cuda.max_memory_allocated() / 2 ** 30
                    if on_card else None)


def time_ms(fn, reps: int = 10, windows: int = 3) -> float:
    """Median over ``windows`` of the mean CUDA-event time of ``reps``
    calls, after one warm-up call."""
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
    return statistics.median(out)


def cold_ms(fn, reps: int = 30) -> float:
    """Median CUDA-event time of one call at a time, each after a read of
    a 128 MB buffer that leaves none of the call's operands in L2."""
    flush = torch.ones(1 << 25, dtype=torch.float32, device="cuda")
    return _one_call_ms(fn, flush.sum, reps)


def warm_ms(fn, reps: int = 30) -> float:
    """As ``cold_ms``, with a wait on the card of about the read's length
    in its place (``torch.cuda._sleep``, 10^5 clock cycles) that touches
    no memory: the operands the last call left in L2 stay there, and the
    host has queued the call before the card reaches it, as after the
    read."""
    return _one_call_ms(fn, lambda: torch.cuda._sleep(100_000), reps)


def _one_call_ms(fn, before, reps: int) -> float:
    """Median CUDA-event time of ``fn``, one call at a time, each queued
    behind ``before()``."""
    fn()
    out = []
    for _ in range(reps):
        before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def stats(xs) -> dict:
    """Median, quartiles and count of the samples ``xs``."""
    p25, med, p75 = np.percentile(np.asarray(xs, dtype=np.float64),
                                  [25, 50, 75])
    return dict(median=float(med), p25=float(p25), p75=float(p75),
                n=len(xs), samples=[float(x) for x in xs])


def metric(unit: str, better: str, xs, value: float | None = None) -> dict:
    """A metric of the samples ``xs``; ``value``, the number its bound
    applies to, is their median unless given."""
    s = stats(xs)
    return dict(unit=unit, better=better,
                value=s["median"] if value is None else value, **s)


def horner_ints(spec, v, x: int) -> int:
    """v(x) mod p by Horner's rule in Python ints; v digit planes [w, n]."""
    w = v.shape[0]
    raw = np.ascontiguousarray(np.asarray(v).T.astype("<u2")).tobytes()
    acc = 0
    for i in reversed(range(v.shape[1])):
        acc = (acc * x + int.from_bytes(raw[2 * w * i:2 * w * (i + 1)],
                                        "little")) % spec.p
    return acc


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def uniform_values(spec, n: int, seed: int):
    """n field elements drawn as the JAX package's bench.py draws them,
    as digit planes [w, n] on the CPU."""
    from .fields import limb

    rng = random.Random(seed)
    return limb.ints_to_digits([rng.randrange(spec.p) for _ in range(n)],
                               spec.w)


def verdict(checks: dict, outputs: list, digests: list | None) -> bool:
    """True iff every check held in every sample and, where golden
    digests are given, each sample's outputs that they cover equal them
    (sample i, the warm-up first, against ``digests[i]``)."""
    if digests is not None:
        pinned = list(zip(outputs, digests))
        checks["golden_digests"] = bool(pinned) and all(
            o == d for o, d in pinned)
    return bool(checks) and all(checks.values())


# ---------------------------------------------------------------- checks

def jindo_checks(params, vrf, x: int, com, ys, pf, want_y: int,
                 verified) -> dict:
    """The checks of one Jindo sample; ``verified`` is what its timed
    ``verify`` returned."""
    from . import jindo

    data = com.to_bytes()
    bad_y = (ys[0] + 1) % params.spec.p
    return dict(
        commitment_reparses=jindo.Commitment.from_bytes(
            params, data).to_bytes() == data,
        evaluation_is_horner=list(ys) == [want_y],
        verifies=verified is True,
        flipped_evaluation_refused=vrf.verify(x, [com], [bad_y], pf) is False)


def buckler_checks(params, vrf, public, pf, verified) -> dict:
    """The checks of one Buckler sample; ``verified`` is what its timed
    ``verify`` returned."""
    from . import buckler

    data = pf.to_bytes(params)
    bad = buckler.Proof.from_bytes(params, data)
    bad.lin_check_mask_sum = (bad.lin_check_mask_sum + 1) % params.spec.p
    return dict(
        proof_reparses=buckler.Proof.from_bytes(params, data).to_bytes(
            params) == data,
        verifies=verified is True,
        tampered_lin_sum_refused=vrf.verify(public, bad) is False)


def commit_batches(ctx) -> list[int]:
    """Commitments per ``commit_many`` of a Buckler prove, round by round
    (buckler/prover.py): first-round witnesses; second-round witnesses and
    the sum-check masks; the round-3 quotients and remainders."""
    second = len(ctx.w_second)
    lin, sumc = int(ctx.has_linear_check()), int(ctx.has_sum_check())
    ts = [ctx.w_cnt - second, second + lin + sumc,
          int(ctx.has_arithmetic_check()) + 3 * lin + 3 * sumc]
    return [t for t in ts if t]


def commit_segments(params, ns) -> list:
    """The uniform segments (``csprng/field_sample.py`` ``draw_segments``)
    of a commit batch of polynomials of ``ns`` values (jindo/prover.py
    ``_meta``): per commitment its last row, its mask column (the rows
    Prover._mask_rows keeps, slots values each) and the two ChaCha20
    keys."""
    p = params
    cs = p.cols * p.slots
    segs = []
    for n in ns:
        rows = 2 + int(np.count_nonzero(np.arange(1, p.rows - 1) * cs <= n))
        segs += [("field", cs - 1), ("field", rows * p.slots), ("bytes", 32),
                 ("bytes", 32)]
    return segs


def _fold(checks: dict, new: dict) -> None:
    for k, ok in new.items():
        checks[k] = checks.get(k, True) and ok


class _Samples:
    """Host seconds, peak GiB and kernel launches of the timed calls of
    each operation; a call with ``keep`` false (the warm-up) is run but
    not kept."""

    def __init__(self, device):
        self.device = device
        self.times, self.peaks, self.launches = {}, {}, {}

    def run(self, op: str, fn, keep: bool):
        from . import backend

        backend.reset_launches()
        out, s, peak = timed(fn, self.device)
        if keep:
            self.times.setdefault(op, []).append(s)
            self.peaks[op] = max(self.peaks.get(op, 0.0), peak or 0.0)
            self.launches[op] = dict(backend.LAUNCHES)
        return out


# ----------------------------------------------------------------- cells

def bench_jindo_single(log_n: int = 19, field: str = "ZP255", seed: int = DEFAULT_SEED,
                       reps: int = DEFAULT_REPS, device=None,
                       digests: list | None = None):
    """The Jindo cell: set-up, then ``reps`` + 1 samples of commit ->
    evaluate -> verify of one polynomial (the first is the warm-up); the
    outputs of sample i are held to ``digests[i]``.  Returns (record,
    calls, context): ``calls`` are the operations to trace, (phase, fn)
    by name; ``context`` holds the Jindo parameters and the commit batch
    t (``kernel_rows``'s shapes), the verifier and the first sample's
    inputs and outputs."""
    from . import backend, fields, jindo

    device = backend.resolve_device(device)
    spec, n = getattr(fields, field), 1 << log_n
    params = jindo.new_parameters(spec, n, 1)
    v = uniform_values(spec, n, seed)
    x = X_POINT % spec.p
    want_y = horner_ints(spec, v, x)

    def setup():
        ck = jindo.CommitKey(params, JINDO_CRS, device=device)
        return (jindo.Prover(params, JINDO_CRS, seed=prover_seed(seed),
                             device=device, ck=ck),
                jindo.Verifier(params, JINDO_CRS, device=device, ck=ck))

    (prv, vrf), setup_s, _ = timed(setup, device)
    sm, checks, outputs = _Samples(device), {}, []
    for i in range(reps + 1):
        com, opening = sm.run("commit", lambda: prv.commit(v), i > 0)
        ys, pf = sm.run("evaluate", lambda: prv.evaluate(
            x, [v], [com], [opening]), i > 0)
        ok = sm.run("verify", lambda: vrf.verify(x, [com], ys, pf), i > 0)
        _fold(checks, jindo_checks(params, vrf, x, com, ys, pf, want_y, ok))
        outputs.append(dict(commitment_sha256=sha256_hex(com.to_bytes()),
                            proof_sha256=sha256_hex(pf.to_bytes(params)),
                            evaluation=hex(ys[0])))
        if i == 0:
            c0, o0, ys0, pf0 = com, opening, ys, pf
    correct = verdict(checks, outputs, digests)
    m, ts = f"logN{log_n}", sm.times["commit"]
    rec = dict(
        metrics={
            f"jindo_commit_coeffs_per_sec_{m}": metric(
                "coeff/s", "higher", [n / s for s in ts],
                value=n * len(ts) / sum(ts)),
            f"{m}_commit_s": metric("s", "lower", ts),
            f"{m}_evaluate_s": metric("s", "lower", sm.times["evaluate"]),
            f"{m}_verify_s": metric("s", "lower", sm.times["verify"]),
            "jindo_setup_s": metric("s", "lower", [setup_s])},
        headline=f"jindo_commit_coeffs_per_sec_{m}",
        correct=correct, checks=checks, outputs=outputs,
        golden_samples=min(len(outputs), len(digests or [])),
        peak_gib=sm.peaks, launches=sm.launches,
        shape=dict(field=field, log_n=log_n, t=1, cols=params.cols,
                   rows=params.rows, d=params.degree, L=params.ring_q.L,
                   LO=params.ring_q_out.L))
    calls = dict(commit=("commit", lambda: prv.commit(v)),
                 evaluate=("evaluate", lambda: prv.evaluate(x, [v], [c0], [o0])),
                 verify=("verify", lambda: vrf.verify(x, [c0], ys0, pf0)))
    ctx = dict(params=params, t=1, vrf=vrf, x=x, com=c0, ys=ys0, proof=pf0)
    return rec, calls, ctx


def buckler_tag(circuit: str, log_n: int, field: str) -> str:
    """The prefix of a Buckler cell's prove and verify metrics, as the JAX
    grid names them: ``buckler_pk_13_220`` for PublicKey (13, ZP220)."""
    return f"buckler_{CIRCUIT_TAGS.get(circuit, circuit)}_{log_n}_{field[2:]}"


def bench_buckler(circuit: str = "public_key", log_n: int = 13,
                  field: str = "ZP220", seed: int = DEFAULT_SEED,
                  reps: int = DEFAULT_REPS, device=None,
                  pseed: bytes | None = None, digests: list | None = None):
    """The Buckler cell: the instance of ``circuit`` from ``seed``,
    ``compile_circuit`` (prover seed ``pseed``, default
    ``prover_seed(seed)``), then ``reps`` + 1 samples of prove -> verify
    (the first is the warm-up); the proof of sample i is held to
    ``digests[i]``.  Returns (record, calls, context) as
    ``bench_jindo_single``."""
    from . import backend, buckler, circuits, fields
    from .rings.bigring import CyclotomicRing

    device = backend.resolve_device(device)
    spec, n = getattr(fields, field), 1 << log_n
    ring = CyclotomicRing(spec, n, device=device)
    c, a, pub = circuits.build(circuit, buckler, ring, seed=seed,
                               checker_kw={"device": device})
    (prv, vrf), compile_s, _ = timed(lambda: buckler.compile_circuit(
        spec, n, c, BUCKLER_CRS, seed=pseed or prover_seed(seed),
        device=device), device)
    params = prv.params
    sm, checks, outputs = _Samples(device), {}, []
    for i in range(reps + 1):
        pf = sm.run("prove", lambda: prv.prove(a), i > 0)
        ok = sm.run("verify", lambda: vrf.verify(pub, pf), i > 0)
        _fold(checks, buckler_checks(params, vrf, pub, pf, ok))
        outputs.append(dict(proof_sha256=sha256_hex(pf.to_bytes(params))))
        if i == 0:
            pf0 = pf
    correct = verdict(checks, outputs, digests)
    tag = buckler_tag(circuit, log_n, field)
    rec = dict(
        metrics={f"{tag}_prove_s": metric("s", "lower", sm.times["prove"]),
                 f"{tag}_verify_s": metric("s", "lower", sm.times["verify"]),
                 "buckler_compile_s": metric("s", "lower", [compile_s])},
        headline=f"{tag}_prove_s",
        correct=correct, checks=checks, outputs=outputs,
        golden_samples=min(len(outputs), len(digests or [])),
        peak_gib=sm.peaks, launches=sm.launches,
        shape=dict(circuit=circuit, field=field, log_n=log_n, jindo_rank=params.rank,
                   rows=params.rows, cols=params.cols,
                   L=params.ring_q.L, batch=params.batch))
    calls = dict(prove=("buckler_prove", lambda: prv.prove(a)),
                 verify=("buckler_verify", lambda: vrf.verify(pub, pf0)))
    ctx = dict(params=params, t=max(commit_batches(prv.ctx)), vrf=vrf,
               public=pub, proof=pf0)
    return rec, calls, ctx


# ----------------------------------------------------------- kernel rows

def _residues(ring, shape, gen):
    """Residues int32 [L, *shape] below each prime of ``ring``, on the card."""
    q = torch.tensor(ring.primes, dtype=torch.int64).reshape(
        -1, *([1] * len(shape)))
    return (torch.randint(0, 1 << 62, (ring.L, *shape), generator=gen) % q
            ).to(torch.int32).to("cuda")


def _same(a, b, what: str) -> None:
    if a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel != plain version")


def mac_plain(ring, key, x):
    """sum_k key[:, j, k] * x[:, k, b] * R^-1 mod q in int64, one k at a
    time: what ``mac_matmul.mod_mac`` gives with the key folded."""
    q = ring.q.reshape(-1, 1, 1, 1)
    acc = torch.zeros((key.shape[0], key.shape[1], x.shape[2], x.shape[3]),
                      dtype=torch.int64, device=x.device)
    for k in range(key.shape[2]):
        acc = (acc + key[:, :, k, None].long() * x[:, None, k].long()) % q
    return (acc * ring.rinv.reshape(-1, 1, 1, 1) % q).to(torch.int32)


def kernel_rows(params, t: int, seed: int = DEFAULT_SEED) -> list[dict]:
    """The three CUDA kernels and the inner MAC at the shapes of one
    commit chunk of ``t`` commitments on ``params``, on the card: each
    held against its plain version on the same inputs (exact), timed with
    CUDA events and set against the least time of its function's work.
    A share of the bound above 1 is a fault in the count and raises."""
    from .csprng import chacha, gaussian
    from .ops import mac_matmul, ntt_matmul

    gen = torch.Generator().manual_seed(seed)
    B, R, d = params.cols + 1, params.rows, params.degree
    J, K = params.in_msis_rank, params.rows + params.mlwe_rank
    ring = params.ring_q.on("cuda")
    L = ring.L
    rows = []

    def row(name, kernel, route, source, replaces, shape, fn, work):
        ms = time_ms(fn)
        b, by = bound_ms(*work)
        share = b / ms
        if share > 1.0:
            raise AssertionError(f"{name}: bound share {share:.3f} > 1: the "
                                 "work count is wrong")
        rows.append({"name": name, "kernel": kernel, "route": route,
                     "source": source, "replaces": replaces, "shape": shape,
                     "ms": ms, "bytes": work[0], "operations": work[1],
                     "bound_ms": b, "bound_by": by,
                     f"{kernel}_bound_share": share})

    # the encode NTT: [L, t * B * R, d], the commit's largest launch
    mm = ring._matmul_ntt()
    v = _residues(ring, (t * B * R, d), gen)
    _same(ntt_matmul.ntt_mform_cuda(v, mm.fwd, mm.q32),
          ntt_matmul.ntt_mform_plain(v, mm.fwd, ring.q), "ntt_mform")
    row("ntt_mform", "ntt", "cuda", "ringo_tpu_torch/csrc/ntt_mform.cu",
        "ringo_tpu/ops/ntt_pallas.py:106", f"[{L}, {t * B * R}, {d}] int32",
        lambda: ntt_matmul.ntt_mform_cuda(v, mm.fwd, mm.q32),
        ntt_work(L, t * B * R, d))
    del v
    # ChaCha20: the encode stream of each of the t commitments
    keys = torch.randint(-(1 << 31), 1 << 31, (t, 8), generator=gen,
                         dtype=torch.int64).to(torch.int32).to("cuda")
    nb = -(-B * R * d // 8)
    _same(chacha.keystream_u32_cuda(keys, nb),
          chacha.keystream_u32_plain(keys, nb), "chacha20")
    row("chacha20", "chacha", "cuda", "ringo_tpu_torch/csrc/chacha20.cu",
        "ringo_tpu/ops/chacha_pallas.py:47", f"{t} keys x {nb} blocks",
        lambda: chacha.keystream_u32_cuda(keys, nb), chacha_work(t, nb))
    # the twin search of the encode lanes (sigma_ecd)
    n = t * B * R * d
    tw = gaussian.TwinCDTDevice(params.ecd_std_dev, "cuda")
    c0 = torch.randint(0, 128, (n,), generator=gen, dtype=torch.int32)
    c1 = (c0 + torch.randint(0, 2, (n,), generator=gen,
                             dtype=torch.int32)) % 128
    c0, c1 = c0.to("cuda"), c1.to("cuda")
    u = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                      dtype=torch.int64).to("cuda")
    got = gaussian.twin_search_cuda(tw.tables_raw, c0, c1, u)
    want = gaussian.twin_search_plain(tw.tables_flipped, c0, c1, u)
    for i in range(2):
        _same(got[i], want[i], "twin_search")
    T = tw.tables.shape[1]
    row("twin_search", "twin", "cuda", "ringo_tpu_torch/csrc/twin_search.cu",
        "ringo_tpu/ops/twin_pallas.py:57", f"{n} lanes, T={T}",
        lambda: gaussian.twin_search_cuda(tw.tables_raw, c0, c1, u),
        twin_work(n, T, int((c1 != c0).sum())))
    del got, want, c0, c1, u
    # the inner Ajtai MAC (stages.encode_mac): key [L, J, K, d] . x
    # [L, K, t * B, d], K the encode rows and the MLWE rank
    key = _residues(ring, (J, K, d), gen)
    x = _residues(ring, (K, t * B, d), gen)
    kp = mac_matmul.folded(ring, key)
    _same(mac_matmul.mod_mac(ring, kp, x), mac_plain(ring, key, x), "mac")
    row("mod_mac", "mac", "cuda",
        "ringo_tpu_torch/csrc/mac.cu", "ringo_tpu/ops/mac_matmul.py:179",
        f"[{L}, {J}, {K}] x [{L}, {K}, {t * B}] x d={d}",
        lambda: mac_matmul.mod_mac(ring, kp, x), mac_work(L, d, J, K, t * B))
    del key, x, kp
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ main

def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def workloads() -> dict:
    """The cells of BENCHMARK.json by name."""
    with open(BENCHMARK) as f:
        return {w["name"]: w for w in json.load(f)["workloads"]}


def cell_config(cell: str) -> dict:
    """The configuration file that the cell's workload names."""
    with open(os.path.join(ROOT, workloads()[cell]["config"])) as f:
        return json.load(f)


def digest_path(cell: str) -> str:
    return os.path.join(DIGEST_DIR, cell + ".json")


def load_digests(cell: str, seed: int) -> list | None:
    """The JAX package's outputs of the cell's samples, in order, if its
    digest file was written at ``seed``."""
    with open(digest_path(cell)) as f:
        rec = json.load(f)
    return rec["samples"] if rec["seed"] == seed else None


KINDS = {"jindo": bench_jindo_single, "buckler": bench_buckler}


def run_cell(cell: str, seed: int, reps: int) -> dict:
    """One cell on the card: the timed samples, one traced call of each
    operation and the kernel rows."""
    from .profile_commit import trace_call
    from .utils import profiling

    cfg = cell_config(cell)
    profiling.enable(False)
    rec, calls, ctx = KINDS[cfg["kind"]](
        **cfg["params"], seed=seed, reps=reps, device="cuda",
        digests=load_digests(cell, seed))
    rec["layers"] = {op: trace_call(phase, call)
                     for op, (phase, call) in calls.items()}
    rec["kernel_rows"] = kernel_rows(ctx["params"], ctx["t"], seed)
    rec.update(cell=cell, config=cfg["name"], seed=seed, reps=reps)
    return rec


def report(rec: dict) -> None:
    """The breakdown, for reading: spans by self time, the device
    operations that took longest, the longest idle stretches, the kernel
    rows."""
    for op, lay in rec["layers"].items():
        print(f"== {op}: traced {lay['traced_s']:.4f} s, device busy "
              f"{lay['device_busy_ms']:.2f} ms, idle share "
              f"{lay['device_idle_share']:.4f}, {lay['device_ops']} device "
              f"operations, peak {lay['peak_mem_gib']:.3f} GiB, launches "
              f"{lay['launches']}")
        for k, ms in sorted(lay["spans_self_ms"].items(), key=lambda kv: -kv[1]):
            print(f"   self {ms:10.3f} ms  {k}")
        for k in lay["top_kernels"][:8]:
            print(f"   device {k['ms']:10.3f} ms {k['calls']:6d}x  {k['name']}")
        for g in lay["idle_gaps"]:
            print(f"   idle {g['ms']:10.3f} ms at {g['at_ms']:.1f} ms, host in "
                  f"{g['span']}")
    for r in rec["kernel_rows"]:
        share = r[f"{r['kernel']}_bound_share"]
        print(f"kernel {r['name']} {r['shape']}: {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share {share:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ringo_tpu_torch.bench")
    ap.add_argument("--cell", required=True, choices=sorted(workloads()))
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--reps", type=int, default=DEFAULT_REPS)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 2
    from . import backend

    smi = card()
    t0 = time.perf_counter()
    backend.build()
    backend.lib()
    build_s = time.perf_counter() - t0
    rec = run_cell(args.cell, args.seed, args.reps)
    name, _, limit = smi.partition(",")
    rec.update(hardware=torch.cuda.get_device_name(0), power_limit=limit.strip(),
               device_count=torch.cuda.device_count(), card=smi, build_s=build_s)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_{args.cell}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    report(rec)
    print(smi)
    line = {k: rec[k] for k in ("cell", "config", "correct", "hardware",
                                "power_limit", "device_count", "seed", "reps")}
    head = rec["metrics"][rec["headline"]]
    line.update(metric=rec["headline"], value=head["value"], unit=head["unit"],
                golden_samples=rec["golden_samples"],
                metrics={k: {f: m[f] for f in ("value", "median", "p25", "p75",
                                               "n", "unit", "better")}
                         for k, m in rec["metrics"].items()},
                checks=rec["checks"],
                layers={op: {k: lay[k] for k in (
                    "spans_self_ms", "device_busy_ms", "device_idle_share",
                    "device_ops", "peak_mem_gib", "launches")}
                    for op, lay in rec["layers"].items()},
                kernel_rows=[{k: r[k] for k in (
                    "name", "shape", "ms", "bound_ms", "bound_by",
                    f"{r['kernel']}_bound_share")} for r in rec["kernel_rows"]])
    print(json.dumps(line), flush=True)
    return 0 if rec["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
