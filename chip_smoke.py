#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ringo_tpu_torch) on one card.

    python3 chip_smoke.py

1. builds the CUDA kernels from ringo_tpu_torch/csrc into build/ and prints
   the card's name and power limit;
2. kernel phase: calls each kernel's wrapper at the shapes of the Jindo
   commit on ZP255 at N = 2^19, holds the result against its plain PyTorch
   version on the same inputs (exact equality: every value is an integer)
   and times kernel, plain version and, where one exists, the single
   PyTorch call computing the same function.  The NTT kernel is timed and
   bounded at each of the six shapes of a commit and at the batched encode
   shape of commit_many with t = 4, checked at ragged row counts and with
   primes on both sides of 2^24, and measured against two yardsticks the
   port never calls (float64 bmm, torch._int_mm);
   The NTT kernel is also held against its plain version, and timed beside
   its bound, at every further shape that ``evaluate`` and ``verify`` give
   it at N = 2^19, for t = 1 and for a batch of 2 (whose parameters have
   other rings); the warm-up calls of phases 3 and 4 and the calls of
   phase 5 fail if they launch it at a shape that was not held here;
3. commit phase: builds the N = 2^19 prover on the card (CRS expansion timed
   on the host), commits once to warm up, then with every launch count at
   0 drives ``commit`` three times (timed) and ``commit_many`` once, reads
   each one's peak device memory, and fails unless every kernel was
   launched;
4. round-trip phase on the same prover and key: with the counts at 0,
   ``evaluate`` at a fixed point (median of 3, peak memory, NTT launches;
   the evaluation held against Horner's rule in Python ints over all 2^19
   coefficients), then with the counts at 0 again ``Verifier.verify``
   (must accept; median of 3), then five tampered inputs (evaluation,
   wrong CRS, encode, in_commit, partial_mask: each must be rejected);
5. batch phase: ``new_parameters(ZP255, 2^19, 2)``, ``commit_many`` of two,
   ``evaluate``, ``verify`` (must accept, and reject a swapped pair), with
   peak memory;
6. the card against the port's CPU plain path at N = 2^13 (commitments,
   evaluations and proof bytes equal for t = 1 and a batch of 2; each
   device's verifier accepts the other's proof) and against the golden
   JAX-package fixtures at N = 2^10 (commitment and proof bytes equal; the
   card's verifier accepts the JAX proof).

Any failure raises.  The line before the last is the kernel table as JSON;
the last line is {"ok": true, "device": {...}}.  It needs the repository
beside it and exits non-zero, printing no result, when CUDA is absent.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and int8 tensor
# ops/s.  32-bit integer operations: 132 SMs x 128 lanes x 1.98 GHz boost,
# one operation per lane and clock (the FP32 lane count; the data sheet's
# 67 TFLOP/s counts an FMA as two).  The white paper lists 64 INT32 lanes
# per SM, but the compiler fuses source operations (IADD3, LOP3, PRMT), so
# the larger rate is the one that keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1.979e15
INT32_OPS_PER_S = 132 * 128 * 1.98e9

LOG_N = 19
CRS = b"Jindo!"
SEED = b"chip-smoke"
X_POINT = int.from_bytes(b"chip-smoke evaluation point 0123", "big")


def log(*args):
    print(*args, flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 10, windows: int = 3) -> float:
    """Median over ``windows`` of the mean CUDA-event time of ``reps``
    calls, after one warm-up call."""
    import torch

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


def max_abs_err(a, b, what: str) -> int:
    """max |kernel - plain| over the lanes; raises unless it is 0 (every
    value compared is an integer)."""
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shape {tuple(a.shape)} != {tuple(b.shape)}")
    err = int((a.long() - b.long()).abs().max().item()) if a.numel() else 0
    if err:
        bad = int((a != b).sum().item())
        raise AssertionError(f"{what}: kernel != plain version ({bad} lanes)")
    return err


def int_mm_yardstick(xa8, tab, rg, want):
    """Time of ``torch._int_mm`` per prime on the kernel's int8 operands
    plus the same recombine, or None where the installed PyTorch lacks the
    call or refuses the shape.  A measurement only: the port never calls it."""
    import torch

    from ringo_tpu_torch.ops import mac_matmul

    if not hasattr(torch, "_int_mm"):
        log("torch._int_mm: absent from this PyTorch")
        return None
    corr = tab.corr[:, None, :].to(torch.int64)

    def run():
        t = torch.stack([torch._int_mm(xa8[l], tab.planes[l])
                         for l in range(rg.L)])
        return mac_matmul.recombine_mod_q(rg.q, t.to(torch.int64) + corr,
                                          xa8.shape[2] // 4)

    try:
        got = run()
    except RuntimeError as e:
        log(f"torch._int_mm refused the shape: {e}")
        return None
    max_abs_err(got, want, "torch._int_mm yardstick")
    return time_ms(run, reps=3)


# ------------------------------------------------------------- kernel phase

def ntt_key(m, q32, n: int):
    """What tells the work of one NTT launch from another's: the primes,
    the map (by its first bytes: forward and inverse differ) and the rows."""
    return (tuple(q32.tolist()),
            m.planes_k.flatten()[:256].cpu().numpy().tobytes(), n)


@contextlib.contextmanager
def ntt_shapes_held(checked: set, what: str):
    """Every launch of the NTT kernel within the block must be at a (ring,
    direction, rows) in ``checked``, the set that the kernel phase held
    against the plain version: a shape the paths gain later fails here
    until ``roundtrip_ntt_shapes`` lists it.  The launch itself is the
    wrapper's, untouched."""
    from ringo_tpu_torch.ops import ntt_matmul

    real, seen = ntt_matmul.ntt_mform_cuda, []

    def noting(v, m, q32):
        seen.append(ntt_key(m, q32, v.shape[1]))
        return real(v, m, q32)

    ntt_matmul.ntt_mform_cuda = noting
    try:
        yield
    finally:
        ntt_matmul.ntt_mform_cuda = real
    missing = sorted({(len(k[0]), k[2]) for k in seen if k not in checked})
    if missing or not seen:
        raise AssertionError(f"{what}: NTT launches at (L, rows) {missing} of "
                             f"{len(seen)} were not held against the plain "
                             "version in the kernel phase")
    log(f"{what}: {len(seen)} NTT launches at {len(set(seen))} shapes, each "
        "held against the plain version in the kernel phase")


def roundtrip_ntt_shapes(p):
    """(label, ring attribute, direction, rows) of the NTT launches of
    ``evaluate`` and ``verify`` that a commit at t = 1 does not make, read
    off jindo/prover.py, jindo/verifier.py and jindo/challenge.py;
    ``ntt_shapes_held`` holds the paths to it."""
    B, R = p.cols + 1, p.rows
    K, J = p.mlwe_rank + p.in_msis_rank, p.in_msis_rank
    shapes = [
        ("left encode", "ring_q", "fwd", R),
        ("challenges", "ring_q", "fwd", p.cols),
        ("partial intt", "ring_q", "inv", p.cols),
        ("encode intt", "ring_q", "inv", R),
        ("mlwe intt", "ring_q", "inv", K),
        ("in_commit intt", "ring_q_out", "inv", p.in_com_dcmp_len),
        ("outer residual intt", "ring_q_out", "inv", p.out_msis_rank),
        ("lift ntt", "ring_q", "fwd", p.in_com_dcmp_len),
        ("inner residual intt", "ring_q", "inv", J)]
    if p.batch > 1:
        t = p.batch
        shapes += [
            ("batch challenges", "ring_q", "fwd", t),
            ("batch challenges out", "ring_q_out", "fwd", t),
            ("batch decode intt", "ring_q", "inv", t),
            ("combine mlwe ntt", "ring_q", "fwd", t * B * K),
            ("combine encode ntt", "ring_q", "fwd", t * B * R)]
    return shapes


def kernel_phase(params, params_batch):
    import torch

    from ringo_tpu_torch.csprng import chacha, gaussian
    from ringo_tpu_torch.ops import mac_matmul, ntt_matmul
    from ringo_tpu_torch.rings import rns

    dev = torch.device("cuda")
    p = params
    gen = torch.Generator(device="cpu").manual_seed(19)
    rng = np.random.default_rng(19)
    B, R, d = p.cols + 1, p.rows, p.degree
    K = p.mlwe_rank + p.in_msis_rank
    J, dcmp, outR = p.in_msis_rank, p.in_com_dcmp_len, p.out_msis_rank
    rows = []
    errs = {"ntt": 0, "chacha": 0, "twin": 0}

    # -- NTT: every shape of the commit timed beside its bound; the encode
    # pass also against the plain version and two library yardsticks
    ring, ring_out = p.ring_q.on(dev), p.ring_q_out.on(dev)
    shapes = [("encode ntt", ring, "fwd", B * R), ("mlwe ntt", ring, "fwd", B * K),
              ("inner intt", ring, "inv", J * B), ("outer ntt", ring_out, "fwd", dcmp),
              ("outer intt", ring_out, "inv", outR), ("final ntt", ring_out, "fwd", outR)]

    def residues(rg, n):
        q = torch.tensor(rg.primes, dtype=torch.int64).reshape(-1, 1, 1)
        v = (torch.randint(0, 1 << 62, (rg.L, n, d), generator=gen) % q
             ).to(torch.int32).to(dev)
        v[:, 0, :4] = (rg.q - 1).to(torch.int32)[:, None]
        return v

    def ntt_bound(L, n):
        # v in, out, the int8 map, q and the Barrett constants; all four
        # byte planes against all five 7-bit planes
        nbytes = 2 * L * n * d * 4 + L * 1280 * 1024 + L * (4 + 8)
        return bound_ms(nbytes, 2.0 * L * n * 1024 * 1280, INT8_TC_OPS_PER_S)

    checked = set()

    def ntt_equal(rg, mm, tab, v, what):
        """Kernel against plain version on v; notes the shape as held."""
        got = ntt_matmul.ntt_mform_cuda(v, tab, mm.q32)
        want = ntt_matmul.ntt_mform_plain(v, tab, rg.q)
        torch.cuda.synchronize()
        errs["ntt"] = max(errs["ntt"], max_abs_err(got, want, what))
        checked.add(ntt_key(tab, mm.q32, v.shape[1]))
        return want

    ntt_row, ntt_passes = None, []
    for label, rg, way, n in shapes:
        mm = rg._matmul_ntt()
        tab = getattr(mm, way)
        v = residues(rg, n)
        want = ntt_equal(rg, mm, tab, v, f"ntt {label}")
        ms = time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, tab, mm.q32))
        b, by = ntt_bound(rg.L, n)
        ntt_passes.append(dict(label=label, L=rg.L, rows=n, ms=ms, bound_ms=b,
                               bound_by=by))
        log(f"ntt {label}: L={rg.L} rows={n} kernel {ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}), equal to plain")
        if label == "encode ntt":
            plain_ms = time_ms(lambda: ntt_matmul.ntt_mform_plain(v, tab, rg.q),
                               reps=3)
            xa = mac_matmul.byte_planes(v, dim=2)
            pf = tab.planes_f64
            corr = tab.corr[:, None, :].to(torch.int64)
            lib_ms = time_ms(lambda: mac_matmul.recombine_mod_q(
                rg.q, torch.bmm(xa, pf).to(torch.int64) + corr, d), reps=3)
            int_mm_ms = int_mm_yardstick(xa.to(torch.int8), tab, rg, want)
            ntt_row = dict(
                name="ntt_mform", route="cuda",
                source="ringo_tpu_torch/csrc/ntt_mform.cu",
                replaces="ringo_tpu/ops/ntt_pallas.py:106",
                ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                library_ms=lib_ms, int_mm_ms=int_mm_ms,
                shape=f"[{rg.L}, {n}, {d}] int32", kernel="ntt")
            del xa
    ntt_row["passes"] = ntt_passes
    log(f"ntt per commit (6 launches): kernel "
        f"{sum(r['ms'] for r in ntt_passes):.4f} ms, sum of bounds "
        f"{sum(r['bound_ms'] for r in ntt_passes):.4f} ms")
    log(f"ntt encode pass yardsticks: f64 bmm + recombine "
        f"{ntt_row['library_ms']:.4f} ms, torch._int_mm per prime + recombine "
        f"{ntt_row['int_mm_ms']}")

    # ragged row counts, and the batched encode shape of commit_many (t=4)
    mm = ring._matmul_ntt()
    for n in (1, 6, 63, 64, 65, 127, 129, 4 * B * R):
        v = residues(ring, n)
        ntt_equal(ring, mm, mm.fwd, v, f"ntt rows={n}")
        if n == 4 * B * R:
            ms = time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, mm.fwd, mm.q32))
            b, by = ntt_bound(ring.L, n)
            ntt_row["t4"] = dict(L=ring.L, rows=n, ms=ms, bound_ms=b, bound_by=by)
            log(f"ntt commit_many t=4 encode: L={ring.L} rows={n} kernel "
                f"{ms:.4f} ms, bound {b:.4f} ms ({by}), equal to plain")
    log("ntt ragged rows 1, 6, 63, 64, 65, 127, 129: equal to plain")
    # both branches of the kernel's reduction: primes above and below 2^24
    for bits in (30, 20):
        rb = rns.RnsRing(d, rns.ntt_friendly_primes(bits, 2 * d, 2), dev)
        mb = rb._matmul_ntt()
        for tab in (mb.fwd, mb.inv):
            ntt_equal(rb, mb, tab, residues(rb, 129), f"ntt {bits}-bit primes")
    log("ntt 30-bit and 20-bit primes, both directions: equal to plain")
    # the further shapes of evaluate and verify, t = 1 and a batch of 2
    ntt_row["roundtrip"] = []
    for pp in (params, params_batch):
        rings = {"ring_q": pp.ring_q.on(dev), "ring_q_out": pp.ring_q_out.on(dev)}
        for label, which, way, n in roundtrip_ntt_shapes(pp):
            rg = rings[which]
            mm = rg._matmul_ntt()
            tab = getattr(mm, way)
            v = residues(rg, n)
            ntt_equal(rg, mm, tab, v, f"ntt t={pp.batch} {label}")
            ms = time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, tab, mm.q32))
            b, by = ntt_bound(rg.L, n)
            ntt_row["roundtrip"].append(dict(
                t=pp.batch, label=label, ring=which, way=way, L=rg.L, rows=n,
                ms=ms, bound_ms=b, bound_by=by))
            log(f"ntt t={pp.batch} {label}: {which} {way} L={rg.L} rows={n} "
                f"kernel {ms:.4f} ms, bound {b:.4f} ms ({by}), equal to plain")
        del rings
    del v, want
    torch.cuda.empty_cache()
    rows.append(ntt_row)

    # -- ChaCha20: u_enc and u_ml streams, u_enc timed
    keys = torch.randint(-(1 << 31), 1 << 31, (1, 8), generator=gen,
                         dtype=torch.int64).to(torch.int32).to(dev)
    nb_enc = -(-B * R * d // 8)
    nb_ml = -(-p.cols * K * d // 8)
    for nb in (nb_enc, nb_ml):
        got = chacha.keystream_u32_cuda(keys, nb)
        want = chacha.keystream_u32_plain(keys, nb)
        torch.cuda.synchronize()
        errs["chacha"] = max(errs["chacha"],
                             max_abs_err(got, want, f"chacha20 n_blocks={nb}"))
        log(f"chacha20 n_blocks={nb}: equal to plain")
    ms = time_ms(lambda: chacha.keystream_u32_cuda(keys, nb_enc))
    plain_ms = time_ms(lambda: chacha.keystream_u32_plain(keys, nb_enc), reps=2)
    b, by = bound_ms(32 + nb_enc * 64, nb_enc * 976.0, INT32_OPS_PER_S)
    rows.append(dict(
        name="chacha20", route="cuda", source="ringo_tpu_torch/csrc/chacha20.cu",
        replaces="ringo_tpu/ops/chacha_pallas.py:47", ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"1 key x {nb_enc} blocks", kernel="chacha"))

    # -- twin search: encode lanes (sigma_ecd) and MLWE lanes (sigma_mlwe)
    twin_row = None
    for label, sigma, n, zero in (("ecd", p.ecd_std_dev, B * R * d, False),
                                  ("mlwe", p.mlwe_std_dev, p.cols * K * d, True)):
        tw = gaussian.TwinCDTDevice(sigma, dev)
        host_t = tw.tables
        if zero:
            c0 = torch.zeros(n, dtype=torch.int32)
            c1 = c0.clone()
        else:
            c0 = torch.randint(0, 128, (n,), generator=gen, dtype=torch.int32)
            c1 = (c0 + torch.randint(0, 2, (n,), generator=gen,
                                     dtype=torch.int32)) % 128
        u = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        # boundary draws (tests/test_twin_pallas.py:22-25): exact table
        # hits, their neighbours and 24-bit-prefix ties
        u[:8] = [0, 1, (1 << 64) - 1, host_t[5][10], host_t[7][3] + 1,
                 host_t[7][3] - 1, (host_t[9][2] >> np.uint64(40)) << np.uint64(40),
                 host_t[0][host_t.shape[1] // 2]]
        u = torch.from_numpy(u.view(np.int64))
        c0, c1, u = c0.to(dev), c1.to(dev), u.to(dev)
        got = gaussian.twin_search_cuda(tw.tables_raw, c0, c1, u)
        want = gaussian.twin_search_plain(tw.tables_flipped, c0, c1, u)
        torch.cuda.synchronize()
        for i in range(2):
            errs["twin"] = max(errs["twin"], max_abs_err(
                got[i], want[i], f"twin {label} v{i}"))
        ms = time_ms(lambda: gaussian.twin_search_cuda(tw.tables_raw, c0, c1, u))
        log(f"twin {label}: lanes={n} T={host_t.shape[1]} kernel {ms:.4f} ms, "
            "equal to plain")
        if label == "ecd":
            plain_ms = time_ms(lambda: gaussian.twin_search_plain(
                tw.tables_flipped, c0, c1, u), reps=1)
            searches = n + int((c0 != c1).sum())
            nbytes = n * (4 + 4 + 8 + 8 + 8) + 128 * host_t.shape[1] * 8
            # 7 steps of load, compare and two selects per search
            b, by = bound_ms(nbytes, searches * 7 * 4.0, INT32_OPS_PER_S)
            twin_row = dict(
                name="twin_search", route="cuda",
                source="ringo_tpu_torch/csrc/twin_search.cu",
                replaces="ringo_tpu/ops/twin_pallas.py:57", ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                shape=f"{n} lanes, T={host_t.shape[1]}", kernel="twin")
    rows.append(twin_row)
    for r in rows:
        r["max_abs_err"] = errs[r["kernel"]]
    return rows, checked


# -------------------------------------------------------------- slice phase

def random_values(spec, n: int, seed: int):
    """Digit planes [w, n] of values below p (top digit below p's)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 16, (spec.w, n), dtype=np.int64)
    v[-1] %= int(spec.p_digits[-1])
    return v


def check_commitment(params, com, op):
    import torch

    p = params
    d = p.degree
    want = (2, p.ring_q_out.L, p.out_msis_rank, d)
    if tuple(com.value.shape) != want:
        raise AssertionError(f"commitment shape {tuple(com.value.shape)} != {want}")
    for name, t in (("commitment", com.value), ("in_commit", op.in_commit)):
        if t.min().item() < 0 or t.max().item() >= 1 << 16:
            raise AssertionError(f"{name}: digits out of range")
    res = (com.value[0] | (com.value[1] << 16))
    q = torch.tensor(p.ring_q_out.primes).reshape(-1, 1, 1)
    if not bool((res < q).all()):
        raise AssertionError("commitment residues not reduced")
    if tuple(op.seeds[0].shape) != (p.cols + 1, p.rows, d):
        raise AssertionError("opening seed shape")


def same_commit(a, b, what: str):
    import torch

    (ca, oa), (cb, ob) = a, b
    if ca.to_bytes() != cb.to_bytes():
        raise AssertionError(f"{what}: commitment bytes differ")
    for x, y, name in ((oa.in_commit, ob.in_commit, "in_commit"),
                       (oa.seeds[0], ob.seeds[0], "e_i64 seed"),
                       (oa.seeds[1], ob.seeds[1], "noise seed")):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: {name} differs")


def timed(fn, reps: int = 3):
    """(last result, host-clock seconds of each of ``reps`` calls, each
    ending in a synchronise, peak device memory of the calls in GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, times, torch.cuda.max_memory_allocated() / 2 ** 30


def commit_phase(backend, jindo, params, checked):
    """The N = 2^19 commit path; returns its record and what the round
    trip goes on with (prover, vector, commitment, opening).  ``checked``:
    the NTT shapes that the kernel phase held against the plain version."""
    import torch

    t0 = time.perf_counter()
    ck = jindo.CommitKey(params, CRS, device="cuda")
    crs_s = time.perf_counter() - t0
    log(f"CRS expansion (AES-256-CTR on the host) N=2^{LOG_N}: {crs_s:.3f} s")
    prv = jindo.Prover(params, CRS, seed=SEED, device="cuda", ck=ck)
    v = random_values(params.spec, 1 << LOG_N, 1)
    v2 = random_values(params.spec, (1 << LOG_N) - 12345, 2)
    t0 = time.perf_counter()
    with ntt_shapes_held(checked, "warm-up commit"):
        com, op = prv.commit(v)
    torch.cuda.synchronize()
    log(f"warm-up commit: {time.perf_counter() - t0:.3f} s")
    check_commitment(params, com, op)

    # the peaks below are the commits' own, not the kernel phase's
    held_before = torch.cuda.memory_allocated() / 2 ** 30
    backend.reset_launches()
    (com, op), times, peak = timed(lambda: prv.commit(v))
    many, _, peak_many = timed(lambda: prv.commit_many([v, v2]), reps=1)
    launches = dict(backend.LAUNCHES)
    for c, o in [(com, op)] + many:
        check_commitment(params, c, o)
    med = statistics.median(times)
    log(f"commit N=2^{LOG_N}: times {times} s, median {med:.4f} s, "
        f"{(1 << LOG_N) / med:.1f} coeffs/s")
    log(f"launches over 3 commits + commit_many(2): {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"peak device memory: 3 commits {peak:.3f} GiB, commit_many(2) "
        f"{peak_many:.3f} GiB (held before: "
        f"{held_before:.3f} GiB)")
    rec = dict(log_n=LOG_N, commit_s=times, commit_median_s=med,
               coeffs_per_s=(1 << LOG_N) / med, crs_expand_s=crs_s,
               launches=launches, peak_mem_gib=peak,
               peak_mem_many_gib=peak_many, held_before_gib=held_before)
    return rec, (prv, v, com, op)


def horner_ints(spec, v, x: int) -> int:
    """v(x) mod p by Horner's rule in Python ints; v digit planes [w, n]."""
    w = v.shape[0]
    raw = np.ascontiguousarray(np.asarray(v).T.astype("<u2")).tobytes()
    acc = 0
    for i in reversed(range(v.shape[1])):
        acc = (acc * x + int.from_bytes(raw[2 * w * i:2 * w * (i + 1)],
                                        "little")) % spec.p
    return acc


def tampered(jindo, params, pf, field: str):
    """A copy of the proof with the lowest bit of ``field``'s first digit
    flipped (tests/test_jindo_device.py of the JAX package)."""
    bad = jindo.Proof.from_bytes(params, pf.to_bytes(params))
    planes = getattr(bad, field).clone()
    planes[(0,) * planes.dim()] ^= 1
    setattr(bad, field, planes)
    return bad


def roundtrip_phase(backend, jindo, params, checked, prv, v, com, op):
    """evaluate -> verify at N = 2^19, t = 1, on the commit phase's prover
    and key; the five tampers."""
    import torch

    spec = params.spec
    x = X_POINT % spec.p
    held = torch.cuda.memory_allocated() / 2 ** 30
    with ntt_shapes_held(checked, "warm-up evaluate"):
        ys, pf = prv.evaluate(x, [v], [com], [op])
    backend.reset_launches()
    (ys, pf), ev_times, ev_peak = timed(
        lambda: prv.evaluate(x, [v], [com], [op]))
    ev_launches = dict(backend.LAUNCHES)
    t0 = time.perf_counter()
    want = horner_ints(spec, v, x)
    log(f"Horner's rule in Python ints over 2^{LOG_N} coefficients: "
        f"{time.perf_counter() - t0:.3f} s")
    if ys != [want]:
        raise AssertionError("evaluate: y != v(x)")
    lay = jindo.Proof.layout(params)
    for f in jindo.Proof.FIELDS:
        planes = getattr(pf, f)
        if tuple(planes.shape) != (2,) + lay[f][1] or planes.min().item() < 0 \
                or planes.max().item() >= 1 << 16:
            raise AssertionError(f"proof.{f}: shape or digits out of range")

    vrf = jindo.Verifier(params, CRS, device="cuda", ck=prv.ck)
    with ntt_shapes_held(checked, "warm-up verify"):
        if vrf.verify(x, [com], ys, pf) is not True:
            raise AssertionError("verify rejected an honest proof")
    backend.reset_launches()
    ok, vf_times, vf_peak = timed(lambda: vrf.verify(x, [com], ys, pf))
    vf_launches = dict(backend.LAUNCHES)
    if ok is not True:
        raise AssertionError("verify rejected an honest proof")
    for name, n in (("evaluate", ev_launches["ntt"]),
                    ("verify", vf_launches["ntt"])):
        if n <= 0:
            raise AssertionError(f"the NTT kernel was not launched in {name}")
    ev_med, vf_med = statistics.median(ev_times), statistics.median(vf_times)
    log(f"evaluate N=2^{LOG_N}: times {ev_times} s, median {ev_med:.4f} s, "
        f"peak {ev_peak:.3f} GiB (held before: {held:.3f} GiB), NTT launches "
        f"per evaluate {ev_launches['ntt'] / 3:g}; y = v(x) in Python ints")
    log(f"verify N=2^{LOG_N}: accepted; times {vf_times} s, median "
        f"{vf_med:.4f} s, peak {vf_peak:.3f} GiB, NTT launches per verify "
        f"{vf_launches['ntt'] / 3:g}")

    # the reference's five tampers, each rejected
    if vrf.verify(x, [com], [ys[0] ^ 1], pf) is not False:
        raise AssertionError("verify accepted a wrong evaluation")
    for field in ("encode", "in_commit", "partial_mask"):
        if vrf.verify(x, [com], ys, tampered(jindo, params, pf, field)) \
                is not False:
            raise AssertionError(f"verify accepted a tampered {field}")
    del vrf
    t0 = time.perf_counter()
    wrong = jindo.Verifier(params, b"wrong", device="cuda")
    if wrong.verify(x, [com], ys, pf) is not False:
        raise AssertionError("a verifier with another CRS accepted the proof")
    log(f"tampers rejected: eval, encode, in_commit, partial_mask, crs "
        f"(second key and verifier: {time.perf_counter() - t0:.3f} s)")
    del wrong
    torch.cuda.empty_cache()
    return dict(x=str(x), evaluate_s=ev_times, evaluate_median_s=ev_med,
                evaluate_peak_gib=ev_peak, held_before_gib=held,
                evaluate_launches=ev_launches, ntt_per_evaluate=ev_launches["ntt"] / 3,
                verify_s=vf_times, verify_median_s=vf_med,
                verify_peak_gib=vf_peak, verify_launches=vf_launches,
                ntt_per_verify=vf_launches["ntt"] / 3, tampers_rejected=5)


def batch_phase(backend, jindo, params, checked):
    """commit_many of two -> evaluate -> verify at N = 2^19 with the
    parameters of a batch of 2; untimed, with its peak memory."""
    import torch

    spec = params.spec
    x = X_POINT % spec.p
    t0 = time.perf_counter()
    prv = jindo.Prover(params, CRS, seed=SEED, device="cuda")
    log(f"batch-2 prover (own key: CRS expansion and fold): "
        f"{time.perf_counter() - t0:.3f} s")
    vs = [random_values(spec, 1 << LOG_N, 5),
          random_values(spec, (1 << LOG_N) - 777, 6)]
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    out = prv.commit_many(vs)
    coms, opens = [c for c, _ in out], [o for _, o in out]
    torch.cuda.synchronize()
    peak_commit = torch.cuda.max_memory_allocated() / 2 ** 30
    with ntt_shapes_held(checked, "batch evaluate"):
        (ys, pf), ev_s, peak_ev = timed(
            lambda: prv.evaluate(x, vs, coms, opens), reps=1)
    if ys != [horner_ints(spec, v, x) for v in vs]:
        raise AssertionError("batch evaluate: y != v(x)")
    vrf = jindo.Verifier(params, CRS, device="cuda", ck=prv.ck)
    with ntt_shapes_held(checked, "batch verify"):
        ok, vf_s, peak_vf = timed(lambda: vrf.verify(x, coms, ys, pf), reps=1)
    if ok is not True:
        raise AssertionError("batch verify rejected an honest proof")
    if vrf.verify(x, coms[::-1], ys, pf) is not False:
        raise AssertionError("batch verify accepted swapped commitments")
    launches = dict(backend.LAUNCHES)
    log(f"batch of 2 at N=2^{LOG_N}: commit_many, evaluate ({ev_s[0]:.3f} s, "
        f"first call), verify ({vf_s[0]:.3f} s, first call): accepted, "
        f"swapped commitments rejected; peak device memory commit_many "
        f"{peak_commit:.3f} GiB, evaluate {peak_ev:.3f} GiB, verify "
        f"{peak_vf:.3f} GiB; launches {launches}")
    return dict(peak_commit_gib=peak_commit, peak_evaluate_gib=peak_ev,
                peak_verify_gib=peak_vf, first_evaluate_s=ev_s[0],
                first_verify_s=vf_s[0], launches=launches)


def card_vs_cpu(jindo, ZP255, batch: int):
    """Commit, evaluate and verify at N = 2^13 on the card and on the CPU
    plain path: equal commitments, evaluations and proof bytes, and each
    device's verifier accepts the other's proof."""
    p13 = jindo.new_parameters(ZP255, 1 << 13, batch)
    spec = p13.spec
    x = X_POINT % spec.p
    vs = [random_values(spec, 1 << 13, 3), random_values(spec, 5000, 4)]
    outs, proofs, vrfs = {}, {}, {}
    for devname in ("cuda", "cpu"):
        pr = jindo.Prover(p13, CRS, seed=SEED, device=devname)
        if batch == 1:
            outs[devname] = [pr.commit(vs[0])] + pr.commit_many(vs)
            picked = outs[devname][:1]
        else:
            outs[devname] = picked = pr.commit_many(vs)
        proofs[devname] = pr.evaluate(
            x, vs[:batch], [c for c, _ in picked], [o for _, o in picked])
        vrfs[devname] = jindo.Verifier(p13, CRS, device=devname, ck=pr.ck)
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        same_commit(a, b, f"N=2^13 t={batch} commit {i}: card vs CPU")
    (ys_c, pf_c), (ys_h, pf_h) = proofs["cuda"], proofs["cpu"]
    if ys_c != ys_h or ys_c != [horner_ints(spec, v, x) for v in vs[:batch]]:
        raise AssertionError(f"N=2^13 t={batch}: evaluations differ")
    if pf_c.to_bytes(p13) != pf_h.to_bytes(p13):
        raise AssertionError(f"N=2^13 t={batch}: proof bytes differ, card vs CPU")
    coms = [c for c, _ in outs["cuda"][:batch]]
    if vrfs["cuda"].verify(x, coms, ys_h, pf_h) is not True \
            or vrfs["cpu"].verify(x, coms, ys_c, pf_c) is not True:
        raise AssertionError(f"N=2^13 t={batch}: cross verification failed")
    if vrfs["cuda"].verify(x, coms, [ys_c[0] ^ 1] + ys_c[1:], pf_c) is not False:
        raise AssertionError(f"N=2^13 t={batch}: wrong evaluation accepted")
    log(f"N=2^13 t={batch}: card equals the CPU plain path (commits, "
        "evaluations, proof bytes); each verifier accepts the other's proof")


def card_vs_fixtures(jindo, ZP255):
    """The card against the golden JAX-package fixtures at N = 2^10."""
    data = os.path.join(ROOT, "ringo_tpu_torch", "testdata")
    fx = np.load(os.path.join(data, "commit_zp255_n10.npz"))
    p10 = jindo.new_parameters(ZP255, 1 << int(fx["log_n"]), 1)
    pr = jindo.Prover(p10, bytes(fx["crs"]), seed=bytes(fx["seed"]),
                      device="cuda")
    c, o = pr.commit(fx["v"])
    if c.to_bytes() != bytes(fx["commit_bytes"]):
        raise AssertionError("N=2^10: commitment differs from the JAX fixture")
    for t, key in ((o.in_commit, "in_commit"), (o.seeds[0], "e_i64"),
                   (o.seeds[1], "noise")):
        if not np.array_equal(t.cpu().numpy(), fx[key].astype(np.int64)):
            raise AssertionError(f"N=2^10: {key} differs from the JAX fixture")
    rt = np.load(os.path.join(data, "roundtrip_zp255_n10.npz"))
    if not np.array_equal(rt["v"], fx["v"]) or \
            bytes(rt["commit_bytes"]) != bytes(fx["commit_bytes"]):
        raise AssertionError("the two fixtures disagree")
    x = int.from_bytes(bytes(rt["x"]), "big")
    y = int.from_bytes(bytes(rt["evaluation"]), "big")
    ys, pf = pr.evaluate(x, [rt["v"]], [c], [o])
    if ys != [y] or pf.to_bytes(p10) != bytes(rt["proof_bytes"]):
        raise AssertionError("N=2^10: evaluation or proof bytes differ from "
                             "the JAX fixture")
    vrf = jindo.Verifier(p10, bytes(rt["crs"]), device="cuda", ck=pr.ck)
    jax_pf = jindo.Proof.from_bytes(p10, bytes(rt["proof_bytes"]))
    jax_com = jindo.Commitment.from_bytes(p10, bytes(rt["commit_bytes"]))
    if vrf.verify(x, [jax_com], [y], jax_pf) is not True:
        raise AssertionError("N=2^10: the card's verifier rejected the JAX proof")
    log("N=2^10: card equals the JAX-package golden fixtures (commitment, "
        "opening, evaluation, proof bytes); its verifier accepts the JAX proof")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from ringo_tpu_torch import backend, jindo
        from ringo_tpu_torch.fields import ZP255
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    so = backend.build(verbose=True)
    backend.lib()
    log(f"built {os.path.relpath(so, ROOT)} in {time.perf_counter() - t0:.1f} s")

    params = jindo.new_parameters(ZP255, 1 << LOG_N, 1)
    params_batch = jindo.new_parameters(ZP255, 1 << LOG_N, 2)
    rows, checked = kernel_phase(params, params_batch)
    phase = lambda what: log(f"-- {what} (at {time.perf_counter() - t_start:.1f} s)")
    phase("commit phase")
    slice_rec, held = commit_phase(backend, jindo, params, checked)
    phase("round-trip phase")
    rt_rec = roundtrip_phase(backend, jindo, params, checked, *held)
    del held
    torch.cuda.empty_cache()
    phase("batch phase")
    batch_rec = batch_phase(backend, jindo, params_batch, checked)
    torch.cuda.empty_cache()
    phase("card vs CPU, card vs fixtures")
    for batch in (1, 2):
        card_vs_cpu(jindo, ZP255, batch)
    card_vs_fixtures(jindo, ZP255)
    # launches of the main paths, each read after a run that began with the
    # counts at 0: the commits, the evaluates and the verifies
    for r in rows:
        r["launches"] = sum(rec[r["kernel"]] for rec in (
            slice_rec["launches"], rt_rec["evaluate_launches"],
            rt_rec["verify_launches"]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = {"kernels": [{k: r[k] for k in keys} for r in rows]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=rows, slice=slice_rec,
                       roundtrip=rt_rec, batch=batch_rec,
                       seconds=time.perf_counter() - t_start), f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
