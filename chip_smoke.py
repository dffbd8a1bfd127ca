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
2'. MAC phase: the Ajtai MAC kernel (csrc/mac.cu) against its plain
   version (the float64 product of ``fold_key`` planes) and
   ``bench.mac_plain`` (int64, one k at a time), exact, at every MAC shape
   of the commits (t = 1, 2, 4), evaluate and verify at N = 2^19, and of
   the batch of 2, each in its call site's layout (``bench_mac.mac_shapes``:
   contiguous, transposed views, slices, unit columns), with q - 1 in a key
   row and an input lane, and at K = KERNEL_MAX_K with q - 1 throughout;
   each shape timed (the wrapper back to back, the C entry back to back and
   cold: ``bench_mac.timings``) beside its bound and the float64 route
   (``library_ms``, which it must beat); ptxas's registers and stack of
   every instantiation (fails on local memory).  The Buckler kernel checks
   hold their MAC shapes the same way (timed at PublicKey (13, ZP220)), and
   every path below that holds its NTT shapes fails on a MAC launch at a
   shape not held;
2a. AES phase: the AES-256-CTR keystream kernel of the samplers
   (csrc/aes256_ctr.cu) against the numpy keystream, exact bytes, at one
   8 KiB refill, a read-ahead window, a commit's and a CRS expansion's
   keystream, an unaligned start block, a carry out of the counter's low
   64 bits and the 2^128 wrap, and on the SP 800-38A F.5.5 vector; kernel,
   kernel plus copy to the host and numpy timed beside the bound;
2a'. AES fold phase: the kernel's fold entry (the samplers' refills folded
   on the card, ``fold_cuda``) against ``fold_plain`` over the numpy
   keystream and against a sampler's numpy ``_take_bytes``, exact, at one
   refill, a commit's 8.36 MB, two launches, an unaligned start, the
   counter's low-64 carry and the 2^128 wrap; timed beside its bound;
2a''. Gaussian phase: the loop kernel (csrc/gaussian.cu, one cooperative
   launch a ``sample_device`` call, fed by the fold) at the N = 2^19
   commit's 147,712 COSAC lanes, its 10,752 mask-noise lanes, the PublicKey
   commit's 35,328 and bfv's sigmas, each at the default margin, at 2^-3
   (flagged lanes settled by the host rule) and with 64 KiB read-aheads
   ("window exhausted" resumes): output and both streams' states equal to
   ``gauss_loop_plain`` on the card and to the numpy sampler, the same
   launches, exits, phases and bytes as the plain version; every step
   of the plain runs held against the step kernel, exact; the loop kernel
   timed per call at 147,712 and 35,328 lanes beside its plain version and
   its bound (the call's centres, sigmas, output and committed stream
   bytes, each moved once, or its phases' float64 operations), each op's
   step kernel at its largest step.  The commits, evaluates and Buckler proves below fail unless they
   launched it, the commit also unless it launched it once per
   ``sample_device`` call and exit with at most 3 host syncs, or if a COSAC
   or noise-mask sampler copied keystream to the host;
2a'''. field-sample phase: the uniform draw kernel (csrc/field_sample.cu,
   one launch a ``draw_segments`` call, fed by the fold) at the N = 2^19
   commit's segments (last row, mask column, two ChaCha20 keys), a
   PublicKey (13, ZP220) commitment's and a three-commit batch's, 40
   one-lane segments (Buckler's blinds), ZP880 (w = 55) and 16 KiB
   read-aheads (resumes): digits, bytes and the sampler's state equal to
   ``field_sample_plain`` on the card and to the numpy host loop, the same
   launches, exits, rounds, chunks and bytes as the plain version, one
   sync a launch; timed beside its plain version, its bound and per round.
   The commits fail unless each made exactly one launch and one sync of
   it (a ``commit_many`` of two one call), and the commits and Buckler
   proves if their uniform samplers copied keystream to the host;
2b. big-field phase: the big-field kernel (csrc/bigfield.cu: mul_mod,
   reduce_cols, the one-launch tree_sum, horner, powers, limb
   add/sub/neg/geq) against the plain versions on the card, exactly, at
   all seven field widths with the corner values 0, 1, p - 1 and the
   all-0xFFFF plane, broadcast and sliced operands, reduce_cols at m = 8,
   2w - 1, 2w, 2w + 1 and 4w + 3 columns of up to 2^23 (all 2^23 - 1 in
   one lane); each width's registers, stack frame and spills of the
   mul_mod and reduce_cols kernels from ptxas (it fails on local memory
   at w <= 28); horner and powers at
   x = 0, 1, p - 1 and a random point, n = 1, n = 700 (t = 3), a sliced
   vs, n = 2^15 (several blocks) and t = 43 at ZP240; then at the cells'
   shapes (the evaluate's horner and the verifier's tree sum at [16, 1,
   2^19], the PublicKey ring's horner, powers and tree sum at [14, 4,
   2^15], reduce_cols at BigLinMap's 2w + 1 columns, a commit's CRT cutoff
   geq), timed beside the bound, mul_mod at [16, 2^19] and horner at [16,
   1, 2^19] beside the plain version too.  The commits, evaluates,
   verifies and Buckler proves and verifies below fail unless they
   launched it, the evaluate also unless it made exactly one big-field
   call;
3. commit phase: builds the N = 2^19 prover on the card (CRS expansion
   timed, its launches counted from 0: it fails unless the AES kernel ran),
   commits once to warm up, then with every launch count at 0 drives
   ``commit`` three times (timed) and ``commit_many`` once, reads each
   one's peak device memory, and fails unless every kernel was launched;
4. round-trip phase on the same prover and key: with the counts at 0,
   ``evaluate`` at a fixed point (median of 3, peak memory, NTT launches;
   the evaluation held against Horner's rule in Python ints over all 2^19
   coefficients), then with the counts at 0 again ``Verifier.verify``
   (must accept; median of 3), then five tampered inputs (evaluation,
   wrong CRS, encode, in_commit, partial_mask: each must be rejected);
5. batch phase: ``new_parameters(ZP255, 2^19, 2)``, ``commit_many`` of two,
   ``evaluate``, ``verify`` (must accept, and reject a swapped pair), with
   peak memory;
5a. parallel phase (ringo_tpu_torch/parallel over NCCL at world size 1, a
   dp x tp x sp mesh of one card; every collective runs): the sharded
   commit core on the batch parameters for t = 2 host-made inputs equal
   to ``raw_stages()["commit_core"]`` per item; a mesh-attached prover
   and verifier with the batch phase's seed and key, whose commitments
   and proof bytes equal the batch phase's (accepted, a swapped pair
   rejected); the four-step big-field NTT at rank 2^15 on ZP220 equal to
   the unsharded ring's ``ntt`` (in its engine order) and inverted by
   ``inv``; after the PublicKey Buckler phase, a mesh-attached Buckler
   prover of the same seed (embedding NTTs on the four-step) whose proof
   bytes equal that phase's first proof, accepted by a mesh-attached
   verifier.  One warm call of each, timed; its kernel launches join the
   kernel table's;
6. the card against the port's CPU plain path at N = 2^13 (commitments,
   evaluations and proof bytes equal for t = 1 and a batch of 2; each
   device's verifier accepts the other's proof) and against the golden
   JAX-package fixtures at N = 2^10 (commitment and proof bytes equal; the
   card's verifier accepts the JAX proof);
7. Buckler phases, each after the three kernels were held against their
   plain versions at the shapes and tables of its Jindo parameters
   (``buckler_kernel_checks``; every prove and verify fails on an NTT
   launch at a shape not held): the PublicKey circuit at (N = 2^13, ZP220)
   (``compile_circuit`` with its NTT plans and Jindo key timed apart;
   prove and verify medians of 3 with the launch counts at 0 first, peak
   memory; a tampered evaluation and a verifier of another CRS rejected;
   the big-field encode and embedding NTT on the card equal to the CPU),
   then first calls of mult at (13, ZP128) and PublicKey at (15, ZP880);
   then the bfv example (ringo_tpu_torch/examples/bfv.py: a BFV
   ciphertext of the port's BGV switched into ZP240) at (13, ZP240) through
   the example's ``setup``, timed as PublicKey, and the mult example's
   ``main`` at (13, ZP128), one call that must verify; before them the BGV
   phase: keygen, encrypt and decrypt at log_n = 13 on the card from a
   fixed seed, key, (c0, c1) and error equal to the CPU path's, decryption
   equal to the message, encrypt and decrypt timed;
8. the five circuits of ringo_tpu_torch/circuits.py at their test sizes:
   proof bytes on the card equal the CPU's and the JAX-package fixture
   (buckler_n8.npz), each device's verifier accepts the other's proof.

Any failure raises.  The line before the last is the kernel table as JSON
(launches: the main paths' runs, the CRS expansion and the timed Buckler
ones included: PublicKey
and bfv, and the parallel phase's sharded runs); the
last line is {"ok": true, "device": {...}}.  It needs the repository
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

# ringo_tpu_torch/bench.py, imported by main() once the port is found: the
# bounds and work counts of the kernels (the bench prints the same bound for
# a kernel), the CUDA-event timer, Horner's rule in Python ints and the
# commit batches of a Buckler prove
bench = None

LOG_N = 19
CRS = b"Jindo!"
SEED = b"chip-smoke"
X_POINT = int.from_bytes(b"chip-smoke evaluation point 0123", "big")


def log(*args):
    print(*args, flush=True)


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
    return bench.time_ms(run, reps=3)


# ------------------------------------------------------------- kernel phase

def ntt_key(m, q32, n: int):
    """What tells the work of one NTT launch from another's: the primes,
    the map (by its first bytes: forward and inverse differ) and the rows."""
    return (tuple(q32.tolist()),
            m.planes_k.flatten()[:256].cpu().numpy().tobytes(), n)


@contextlib.contextmanager
def shapes_held(checked: set, what: str):
    """Every launch of the NTT kernel and of the MAC kernel within the block
    must be at a shape in ``checked``, the set that the kernel and MAC
    phases (and ``buckler_kernel_checks``) held against the plain versions:
    a (ring, direction, rows) of the NTT, a (primes, J, K, n, branch of x's
    layout) of the MAC (``bench_mac.mac_key``).  A block that launches no
    NTT or no MAC fails too.  A shape the paths gain later fails here until
    ``roundtrip_ntt_shapes`` or ``bench_mac.mac_shapes`` lists it.  The
    launches themselves are the wrappers', untouched."""
    from ringo_tpu_torch import bench_mac
    from ringo_tpu_torch.ops import mac_matmul, ntt_matmul

    real_ntt, real_mac, seen, macs = (ntt_matmul.ntt_mform_cuda,
                                      mac_matmul.mod_mac_cuda, [], [])

    def noting(v, m, q32):
        seen.append(ntt_key(m, q32, v.shape[1]))
        return real_ntt(v, m, q32)

    def noting_mac(ring, key, x):
        macs.append(bench_mac.mac_key(ring.primes, key.shape[1], x))
        return real_mac(ring, key, x)

    ntt_matmul.ntt_mform_cuda = noting
    mac_matmul.mod_mac_cuda = noting_mac
    try:
        yield
    finally:
        ntt_matmul.ntt_mform_cuda = real_ntt
        mac_matmul.mod_mac_cuda = real_mac
    missing = sorted({(len(k[0]), k[2]) for k in seen if k not in checked})
    if missing or not seen:
        raise AssertionError(f"{what}: NTT launches at (L, rows) {missing} of "
                             f"{len(seen)} were not held against the plain "
                             "version in the kernel phase")
    if not macs:
        raise AssertionError(f"{what}: no launch of the MAC kernel")
    missing = sorted({k[2:] for k in macs if k not in checked})
    if missing:
        raise AssertionError(f"{what}: MAC launches at (J, K, n, kn_order) "
                             f"{missing} of {len(macs)} were not held "
                             "against the plain version in the MAC phase")
    log(f"{what}: {len(seen)} NTT launches at {len(set(seen))} shapes and "
        f"{len(macs)} MAC launches at {len(set(macs))} shapes, each held "
        "against the plain version")


def ntt_bound(L: int, n: int, d: int):
    """Least time of one NTT launch [L, n, d]: the function's bytes and
    butterflies (``bench.ntt_work``), not the matmul form's MACs."""
    return bench.bound_ms(*bench.ntt_work(L, n, d))


def random_residues(rg, n: int, gen):
    """Residues [L, n, d] below each prime, on the card; the first row
    starts with q - 1 (the largest residue)."""
    import torch

    q = torch.tensor(rg.primes, dtype=torch.int64).reshape(-1, 1, 1)
    v = (torch.randint(0, 1 << 62, (rg.L, n, rg.d), generator=gen) % q
         ).to(torch.int32).to("cuda")
    v[:, 0, :4] = (rg.q - 1).to(torch.int32)[:, None]
    return v


def hold_ntt(rg, tab, v, checked: set, errs: dict, what: str):
    """The NTT kernel against its plain version on v (exact); notes the
    (primes, map, rows) as held.  Returns the plain result."""
    import torch

    from ringo_tpu_torch.ops import ntt_matmul

    mm = rg._matmul_ntt()
    got = ntt_matmul.ntt_mform_cuda(v, tab, mm.q32)
    want = ntt_matmul.ntt_mform_plain(v, tab, rg.q)
    torch.cuda.synchronize()
    errs["ntt"] = max(errs["ntt"], max_abs_err(got, want, what))
    checked.add(ntt_key(tab, mm.q32, v.shape[1]))
    return want


def hold_chacha(keys, nb: int, errs: dict, what: str) -> None:
    import torch

    from ringo_tpu_torch.csprng import chacha

    got = chacha.keystream_u32_cuda(keys, nb)
    want = chacha.keystream_u32_plain(keys, nb)
    torch.cuda.synchronize()
    errs["chacha"] = max(errs["chacha"], max_abs_err(got, want, what))


def twin_inputs(sigma: float, n: int, zero: bool, gen, rng):
    """A sigma's tables on the card and n search inputs (c0, c1, u) with
    the boundary draws first (tests/test_twin_pallas.py:22-25): exact
    table hits, their neighbours and 24-bit-prefix ties."""
    import torch

    from ringo_tpu_torch.csprng import gaussian

    tw = gaussian.TwinCDTDevice(sigma, "cuda")
    host_t = tw.tables
    if zero:
        c0 = torch.zeros(n, dtype=torch.int32)
        c1 = c0.clone()
    else:
        c0 = torch.randint(0, 128, (n,), generator=gen, dtype=torch.int32)
        c1 = (c0 + torch.randint(0, 2, (n,), generator=gen,
                                 dtype=torch.int32)) % 128
    u = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    u[:8] = [0, 1, (1 << 64) - 1, host_t[5][10], host_t[7][3] + 1,
             host_t[7][3] - 1, (host_t[9][2] >> np.uint64(40)) << np.uint64(40),
             host_t[0][host_t.shape[1] // 2]]
    u = torch.from_numpy(u.view(np.int64))
    return tw, c0.to("cuda"), c1.to("cuda"), u.to("cuda")


def hold_twin(tw, c0, c1, u, errs: dict, what: str) -> None:
    import torch

    from ringo_tpu_torch.csprng import gaussian

    got = gaussian.twin_search_cuda(tw.tables_raw, c0, c1, u)
    want = gaussian.twin_search_plain(tw.tables_flipped, c0, c1, u)
    torch.cuda.synchronize()
    for i in range(2):
        errs["twin"] = max(errs["twin"], max_abs_err(got[i], want[i],
                                                     f"{what} v{i}"))


def roundtrip_ntt_shapes(p):
    """(label, ring attribute, direction, rows) of the NTT launches of
    ``evaluate`` and ``verify`` that a commit at t = 1 does not make, read
    off jindo/prover.py, jindo/verifier.py and jindo/challenge.py;
    ``shapes_held`` holds the paths to it."""
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

    checked = set()

    ntt_row, ntt_passes = None, []
    for label, rg, way, n in shapes:
        mm = rg._matmul_ntt()
        tab = getattr(mm, way)
        v = random_residues(rg, n, gen)
        want = hold_ntt(rg, tab, v, checked, errs, f"ntt {label}")
        ms = bench.time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, tab, mm.q32))
        b, by = ntt_bound(rg.L, n, d)
        ntt_passes.append(dict(label=label, L=rg.L, rows=n, ms=ms, bound_ms=b,
                               bound_by=by))
        log(f"ntt {label}: L={rg.L} rows={n} kernel {ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}), equal to plain")
        if label == "encode ntt":
            plain_ms = bench.time_ms(lambda: ntt_matmul.ntt_mform_plain(v, tab, rg.q),
                               reps=3)
            xa = mac_matmul.byte_planes(v, dim=2)
            pf = tab.planes_f64
            corr = tab.corr[:, None, :].to(torch.int64)
            lib_ms = bench.time_ms(lambda: mac_matmul.recombine_mod_q(
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
        v = random_residues(ring, n, gen)
        hold_ntt(ring, mm.fwd, v, checked, errs, f"ntt rows={n}")
        if n == 4 * B * R:
            ms = bench.time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, mm.fwd, mm.q32))
            b, by = ntt_bound(ring.L, n, d)
            ntt_row["t4"] = dict(L=ring.L, rows=n, ms=ms, bound_ms=b, bound_by=by)
            log(f"ntt commit_many t=4 encode: L={ring.L} rows={n} kernel "
                f"{ms:.4f} ms, bound {b:.4f} ms ({by}), equal to plain")
    log("ntt ragged rows 1, 6, 63, 64, 65, 127, 129: equal to plain")
    # both branches of the kernel's reduction: primes above and below 2^24
    for bits in (30, 20):
        rb = rns.RnsRing(d, rns.ntt_friendly_primes(bits, 2 * d, 2), dev)
        mb = rb._matmul_ntt()
        for tab in (mb.fwd, mb.inv):
            hold_ntt(rb, tab, random_residues(rb, 129, gen), checked, errs,
                     f"ntt {bits}-bit primes")
    log("ntt 30-bit and 20-bit primes, both directions: equal to plain")
    # the further shapes of evaluate and verify, t = 1 and a batch of 2
    ntt_row["roundtrip"] = []
    for pp in (params, params_batch):
        rings = {"ring_q": pp.ring_q.on(dev), "ring_q_out": pp.ring_q_out.on(dev)}
        # the commits of the batch parameters, single and as a batch (the
        # parallel phase's sharded commit core and its reference)
        extra = (commit_ntt_shapes(pp, 1) + commit_ntt_shapes(pp, pp.batch)
                 if pp.batch > 1 else [])
        for label, which, way, n in roundtrip_ntt_shapes(pp) + extra:
            rg = rings[which]
            mm = rg._matmul_ntt()
            tab = getattr(mm, way)
            v = random_residues(rg, n, gen)
            hold_ntt(rg, tab, v, checked, errs, f"ntt t={pp.batch} {label}")
            ms = bench.time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, tab, mm.q32))
            b, by = ntt_bound(rg.L, n, d)
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
        hold_chacha(keys, nb, errs, f"chacha20 n_blocks={nb}")
        log(f"chacha20 n_blocks={nb}: equal to plain")
    ms = bench.time_ms(lambda: chacha.keystream_u32_cuda(keys, nb_enc))
    plain_ms = bench.time_ms(lambda: chacha.keystream_u32_plain(keys, nb_enc), reps=2)
    b, by = bench.bound_ms(*bench.chacha_work(1, nb_enc))
    rows.append(dict(
        name="chacha20", route="cuda", source="ringo_tpu_torch/csrc/chacha20.cu",
        replaces="ringo_tpu/ops/chacha_pallas.py:47", ms=ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None,
        shape=f"1 key x {nb_enc} blocks", kernel="chacha"))

    # -- twin search: encode lanes (sigma_ecd) and MLWE lanes (sigma_mlwe)
    twin_row = None
    for label, sigma, n, zero in (("ecd", p.ecd_std_dev, B * R * d, False),
                                  ("mlwe", p.mlwe_std_dev, p.cols * K * d, True)):
        tw, c0, c1, u = twin_inputs(sigma, n, zero, gen, rng)
        host_t = tw.tables
        hold_twin(tw, c0, c1, u, errs, f"twin {label}")
        ms = bench.time_ms(lambda: gaussian.twin_search_cuda(tw.tables_raw, c0, c1, u))
        log(f"twin {label}: lanes={n} T={host_t.shape[1]} kernel {ms:.4f} ms, "
            "equal to plain")
        if label == "ecd":
            plain_ms = bench.time_ms(lambda: gaussian.twin_search_plain(
                tw.tables_flipped, c0, c1, u), reps=1)
            b, by = bench.bound_ms(*bench.twin_work(
                n, host_t.shape[1], int((c1 != c0).sum())))
            twin_row = dict(
                name="twin_search", route="cuda",
                source="ringo_tpu_torch/csrc/twin_search.cu",
                replaces="ringo_tpu/ops/twin_pallas.py:57", ms=ms,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None,
                shape=f"{n} lanes, T={host_t.shape[1]}", kernel="twin")
    rows.append(twin_row)
    return rows, checked, errs


# ---------------------------------------------------------------- MAC phase

def hold_mac(rg, label, J: int, K: int, n: int, layout: str, checked: set,
             errs: dict, gen, time_it: bool = False, extreme: bool = False):
    """The MAC kernel against its plain version and ``bench.mac_plain`` at
    one shape, in its call site's layout (exact); notes the shape as held.
    With ``time_it`` the row carries its times (``bench_mac.timings``)."""
    from ringo_tpu_torch import bench_mac

    key, x = bench_mac.inputs(rg, J, K, n, layout, gen, extreme=extreme)
    err, kres = bench_mac.hold(rg, key, x)
    errs["mac"] = max(errs["mac"], err)
    checked.add(bench_mac.mac_key(rg.primes, J, x))
    row = dict(label=label, L=rg.L, J=J, K=K, n=n, layout=layout)
    if time_it:
        row.update(bench_mac.timings(rg, key, x, kres))
        if row["ms"] >= row["library_ms"]:
            raise AssertionError(f"mac {label}: kernel {row['ms']:.4f} ms is "
                                 "not faster than the float64 route "
                                 f"{row['library_ms']:.4f} ms")
        log(f"mac {label}: [{rg.L}, {J}, {K}] x [{rg.L}, {K}, {n}] "
            f"({layout}) wrapper {row['ms']:.4f} ms, C entry "
            f"{row['device_ms']:.4f} ms, cold {row['cold_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), share "
            f"{row['cold_share']:.3f} cold; float64 route "
            f"{row['library_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; "
            "equal to plain")
    del key, x, kres
    return row


def mac_phase(params, params_batch, checked: set, errs: dict):
    """The Ajtai MAC kernel (csrc/mac.cu) against its plain version and
    ``bench.mac_plain`` (exact) at every MAC shape of the commits (t = 1,
    the commit phase's ``commit_many`` of two, t = 4), the evaluate and the
    verify on ``params``, and of the batch of 2's commits (t = 1, 2),
    evaluate and verify, each in its call site's layout
    (``bench_mac.mac_shapes``; every shape noted in ``checked``), and at
    K = KERNEL_MAX_K with q - 1 throughout; each timed beside its bound and
    the float64 route (which it must beat); ptxas's registers and stack of
    every instantiation (fails on local memory).  Returns the kernel row:
    the commit's inner MAC."""
    import torch

    from ringo_tpu_torch import bench_mac
    from ringo_tpu_torch.ops import mac_matmul
    from ringo_tpu_torch.rings import rns

    errs["mac"] = 0
    usage = bench_mac.kernel_usage()
    for k, v in usage.items():
        log(f"mac ptxas {k}: {v['registers']} registers, stack {v['stack']}, "
            f"spills {v['spill_stores']} / {v['spill_loads']}")
    gen = torch.Generator(device="cpu").manual_seed(21)
    shapes = []
    for pp, ts in ((params, (1, 2, 4)), (params_batch, (1, 2))):
        rings = {"ring_q": pp.ring_q.on("cuda"),
                 "ring_q_out": pp.ring_q_out.on("cuda")}
        for label, which, J, K, n, layout in bench_mac.mac_shapes(pp, ts):
            shapes.append(hold_mac(rings[which], f"batch {pp.batch} {label}",
                                   J, K, n, layout, checked, errs, gen,
                                   time_it=True))
            torch.cuda.empty_cache()
    top = rns.RnsRing(256, bench_mac.TOP_PRIMES, "cuda")
    K = mac_matmul.KERNEL_MAX_K
    for n in (1, 8):
        hold_mac(top, f"K = {K}, q - 1 throughout, n = {n}", 1, K, n, "cat",
                 checked, errs, gen, extreme=True)
    log(f"mac K = {K} with q - 1 throughout (primes just below 2^31), n = 1 "
        "and 8: equal to plain")
    torch.cuda.empty_cache()
    inner = shapes[0]
    return dict(name="mod_mac", route="cuda",
                source="ringo_tpu_torch/csrc/mac.cu",
                replaces="ringo_tpu/ops/mac_matmul.py:179",
                ms=inner["ms"], device_ms=inner["device_ms"],
                cold_ms=inner["cold_ms"],
                plain_ms=inner["plain_ms"], bound_ms=inner["bound_ms"],
                bound_by=inner["bound_by"], library_ms=inner["library_ms"],
                shape=f"[{inner['L']}, {inner['J']}, {inner['K']}] x "
                      f"[{inner['L']}, {inner['K']}, {inner['n']}] int32, d = 256",
                kernel="mac", shapes=shapes, ptxas=usage)


# ---------------------------------------------------------------- AES phase

# 32-bit operations of one AES-256 block: 13 full rounds and the last one,
# 4 columns each, 12 operations a column (4 table reads, 4 byte selects,
# 4 XORs), and the 4 XORs of the first round key
AES_OPS_PER_BLOCK = 14 * 4 * 12 + 4
COMMIT_KEYSTREAM_BYTES = 9_003_008   # the most one commit of the Jindo cell draws


def aes_bound(n_blocks: int):
    """Least time of the keystream of n counter blocks: 16 bytes written a
    block, the 256 bytes of round keys and counter read once, and
    ``AES_OPS_PER_BLOCK`` operations a block."""
    return bench.bound_ms(16 * n_blocks + 256, AES_OPS_PER_BLOCK * n_blocks)


def crs_keystream_blocks(params) -> int:
    """Counter blocks of a commit key's CRS expansion (jindo/entities.py:
    one u64 per coefficient and prime of In, MLWE and Out, drawn in 8 KiB
    refills)."""
    p = params
    draws = p.degree * (p.ring_q.L * p.in_msis_rank * (p.rows + p.mlwe_rank)
                        + p.ring_q_out.L * p.out_msis_rank * p.in_com_dcmp_len)
    return -(-8 * draws // 8192) * 8192 // 16


def host_ms(fn, reps: int):
    """Median host-clock ms of ``reps`` calls, each ending in a
    synchronise."""
    return statistics.median(timed(fn, reps)[1]) * 1e3


def aes_phase(params, errs: dict):
    """The AES-256-CTR kernel (``ctr_keystream_cuda``) against the numpy
    keystream ``ctr_keystream``, exact bytes: one 8 KiB refill, a
    sampler's read-ahead window, a commit's keystream, a CRS expansion's,
    an unaligned start block, a counter that carries from its low 64 bits
    into the high ones, the 2^128 wrap and the SP 800-38A F.5.5 vector.
    Times the kernel alone (CUDA events), the kernel plus its copy to the
    host and the numpy version (host clock), each beside its bound."""
    import torch

    from ringo_tpu_torch.csprng import uniform

    rng = np.random.default_rng(21)
    rk = uniform.expand_key_256(rng.bytes(32))
    iv = int.from_bytes(rng.bytes(16), "big")
    commit_nb = COMMIT_KEYSTREAM_BYTES // 16
    crs_nb = crs_keystream_blocks(params)
    cases = [("8 KiB refill", rk, iv, 0, 512),
             ("read-ahead window", rk, iv, 512, uniform.WINDOW_BLOCKS),
             ("commit keystream", rk, iv, 0, commit_nb),
             ("CRS expansion", rk, iv, 0, crs_nb),
             ("unaligned start block", rk, iv, 12345, 1000),
             ("low-64 carry", rk, (7 << 64) | ((1 << 64) - 300), 0, 1000),
             ("2^128 wrap", rk, (1 << 128) - 300, 0, 1000)]
    errs["aes"] = 0
    for label, k, v, b0, nb in cases:
        got = uniform.ctr_keystream_cuda(k, v, b0, nb, "cuda")
        want = uniform.ctr_keystream(k, v, b0, nb)
        errs["aes"] = max(errs["aes"], max_abs_err(
            torch.from_numpy(got), torch.from_numpy(want), f"aes {label}"))
        log(f"aes {label}: {nb} blocks from block {b0}, equal to plain")
    key = bytes.fromhex("603deb1015ca71be2b73aef0857d7781"
                        "1f352c073b6108d72d9810a30914dff4")
    ctr = int.from_bytes(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), "big")
    pt = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
    ct = bytes.fromhex(
        "601ec313775789a5b7a7f504bbf3d228f443e3ca4d62b59aca84e990cacaf5c5"
        "2b0930daa23de94ce87017ba2d84988ddfc9c58db67aada613c2dd08457941a6")
    ks = uniform.ctr_keystream_cuda(uniform.expand_key_256(key), ctr, 0, 4, "cuda")
    if (np.frombuffer(pt, np.uint8) ^ ks).tobytes() != ct:
        raise AssertionError("aes: the SP 800-38A F.5.5 vector failed")
    log("aes SP 800-38A F.5.5 (AES-256-CTR): equal to the standard's ciphertext")

    passes = []
    for label, nb in (("read-ahead window", uniform.WINDOW_BLOCKS),
                      ("commit keystream", commit_nb), ("CRS expansion", crs_nb)):
        buf = torch.empty(16 * nb, dtype=torch.uint8, device="cuda")
        ms = bench.time_ms(lambda: uniform.ctr_blocks_cuda(rk, iv, 0, buf))
        copy_ms = host_ms(lambda: uniform.ctr_keystream_cuda(rk, iv, 0, nb, "cuda"), 10)
        plain_ms = host_ms(lambda: uniform.ctr_keystream(rk, iv, 0, nb), 1)
        b, by = aes_bound(nb)
        passes.append(dict(label=label, blocks=nb, ms=ms, copy_ms=copy_ms,
                           plain_ms=plain_ms, bound_ms=b, bound_by=by))
        log(f"aes {label}: {nb} blocks ({16 * nb} bytes): kernel {ms:.4f} ms, "
            f"bound {b:.4f} ms ({by}), share {b / ms:.3f}; kernel + copy to "
            f"the host {copy_ms:.3f} ms; numpy {plain_ms:.1f} ms")
        del buf
    w = passes[0]
    return dict(name="aes256_ctr", route="cuda",
                source="ringo_tpu_torch/csrc/aes256_ctr.cu",
                replaces="ringo_tpu/csprng/uniform.py:34",
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None, passes=passes,
                shape=f"{w['blocks']} counter blocks", kernel="aes")


FOLD_CHUNKS_COMMIT = 1020    # 8 KiB chunks of a commit's 8.36 MB of COSAC keystream
FOLD_CHUNKS_DRAW = 145       # the largest single draw of that commit (147,712 u64)


def fold_bound(m: int, shift: int):
    """Least time of m folded refills: the carry read, m chunks written,
    the AES of the counter blocks they cover and 4 XORs a 16-byte column."""
    blocks = 512 * m + (1 if shift else 0)
    return bench.bound_ms(8192 * (m + 1) + 256,
                          AES_OPS_PER_BLOCK * blocks + 4 * 512 * m)


def fold_phase(row: dict, errs: dict) -> None:
    """The AES kernel's fold entry (``fold_cuda``) against ``fold_plain``
    on the card over the numpy keystream and against a sampler's numpy
    ``_take_bytes``, exact bytes: one refill, a commit's 8.36 MB in one
    draw, more than one launch's 8 MiB, an unaligned start, a counter that
    carries out of its low 64 bits and the 2^128 wrap.  Times the fold
    kernel (CUDA events) at one refill, the commit's largest draw and its
    8.36 MB beside the bound, the plain version on the card, and the host
    path it replaces (keystream copied back, folded by numpy)."""
    import torch

    from ringo_tpu_torch.csprng import uniform

    rng = np.random.default_rng(22)
    rk = uniform.expand_key_256(rng.bytes(32))
    iv = int.from_bytes(rng.bytes(16), "big")
    carry_np = rng.integers(0, 256, uniform.BUF_SIZE, dtype=np.uint8)
    carry = torch.from_numpy(carry_np).to("cuda")
    cases = [("one refill", iv, 0, 1),
             ("commit 8.36 MB", iv, 0, FOLD_CHUNKS_COMMIT),
             ("two launches", iv, 16 * 999, 1500),
             ("unaligned start", iv, 16 * 12345 + 7, 37),
             ("low-64 carry", (7 << 64) | ((1 << 64) - 300), 9, 3),
             ("2^128 wrap", (1 << 128) - 300, 0, 3)]
    for label, v, pos, m in cases:
        out = torch.empty(m * uniform.BUF_SIZE, dtype=torch.uint8, device="cuda")
        uniform.fold_cuda(rk, v, pos, carry, out)
        nb = -(-(pos % 16 + m * uniform.BUF_SIZE) // 16)
        ks = uniform.ctr_keystream(rk, v, pos // 16, nb)[pos % 16:][:m * uniform.BUF_SIZE]
        want = uniform.fold_plain(carry, torch.from_numpy(ks).to("cuda"))
        errs["aes"] = max(errs["aes"], max_abs_err(out, want, f"fold {label}"))
        # a sampler's device draw against its numpy refills
        host = uniform.UniformSampler(b"fold " + label.encode(), device="cuda")
        dev = uniform.UniformSampler(b"fold " + label.encode(), device="cuda")
        for smp in (host, dev):
            smp._iv = v
            smp.read(bytes(pos))
            smp._take_bytes(5)
        n = m * uniform.BUF_SIZE - 3
        got = dev._take_bytes_device(n)
        errs["aes"] = max(errs["aes"], max_abs_err(
            got, torch.from_numpy(host._take_bytes(n)).to("cuda"),
            f"fold sampler {label}"))
        if dev._ptr != host._ptr or dev._consumed != host._consumed or \
                not np.array_equal(dev._host_buf(), host._host_buf()):
            raise AssertionError(f"fold {label}: sampler state differs")
        log(f"aes fold {label}: {m} chunks from byte {pos}, equal to "
            f"fold_plain and to numpy _take_bytes")
    for label, m in (("one refill", 1), ("commit's largest draw", FOLD_CHUNKS_DRAW),
                     ("commit 8.36 MB", FOLD_CHUNKS_COMMIT)):
        out = torch.empty(m * uniform.BUF_SIZE, dtype=torch.uint8, device="cuda")
        ms = bench.time_ms(lambda: uniform.fold_cuda(rk, iv, 0, carry, out))
        ks = torch.from_numpy(uniform.ctr_keystream(rk, iv, 0, 512 * m)).to("cuda")
        plain_ms = bench.time_ms(lambda: uniform.fold_plain(carry, ks))
        smp = uniform.UniformSampler(b"fold timing", device="cuda")
        host_path_ms = host_ms(lambda: smp._take_bytes(m * uniform.BUF_SIZE), 5)
        b, by = fold_bound(m, 0)
        row["passes"].append(dict(label=f"fold {label}", chunks=m, ms=ms,
                                  plain_ms=plain_ms, host_path_ms=host_path_ms,
                                  bound_ms=b, bound_by=by))
        log(f"aes fold {label}: {m} chunks ({8192 * m} bytes): kernel "
            f"{ms:.4f} ms, bound {b:.4f} ms ({by}), share {b / ms:.3f}; "
            f"fold_plain on the card {plain_ms:.4f} ms (keystream given); "
            f"the host path (kernel keystream, copy back, numpy fold) "
            f"{host_path_ms:.3f} ms")
        del out, ks


# Gaussian loop: bytes of each step's lane (inputs read once, outputs
# written once) and its float64 operations, an exp or a log counted as
# EXP_LOG_OPS (a range reduction and a polynomial); the operations over the
# H100's float64 rate outside the tensor cores (NVIDIA's data sheet, SXM)
EXP_LOG_OPS = 20
FP64_OPS_PER_S = 33.5e12
GAUSS_WORK = {"zig": (17, 4), "wedge": (33, 6 + EXP_LOG_OPS),
              "tail": (25, 6 + 2 * EXP_LOG_OPS), "direct": (25, 8 + EXP_LOG_OPS),
              "cosac": (65, 14 + EXP_LOG_OPS), "round": (41, 4)}
GAUSS_OPS = ("zig", "wedge", "tail", "direct", "cosac", "round")


def gauss_bound(op: str, n: int):
    per_byte, per_op = GAUSS_WORK[op]
    return bench.bound_ms(per_byte * n + 3 * 1024, per_op * n,
                          ops_rate=FP64_OPS_PER_S)


def loop_bound(lanes: int, used: int, steps):
    """Least time of one COSAC loop call: the bytes the call must move
    (centre and sigma read once, 8 bytes each a lane, the int64 output
    written once, the ``used`` stream bytes it commits read once) over
    the memory rate, or the float64 operations its phases did on this
    call's data (each step's GAUSS_WORK operations a lane) over the
    float64 rate, whichever is larger."""
    ops = sum(GAUSS_WORK[GAUSS_OPS[op]][1] * n for op, n in steps)
    return bench.bound_ms(24 * lanes + used, ops, ops_rate=FP64_OPS_PER_S)


def cosac_lanes(params, label: str):
    """Centres and sigmas of one commitment's COSAC cells: cols blind
    cells, rows - 1 mask cells and the mask-blind cell, 256 lanes each."""
    p = params
    d = p.degree
    sig = np.concatenate([np.full(p.cols * d, p.ecd_blind_std_dev),
                          np.full((p.rows - 1) * d, p.mask_std_dev),
                          np.full(d, p.mask_blind_std_dev)])
    rng = np.random.default_rng(len(label))
    return rng.uniform(-2.5, 2.5, len(sig)), sig


# the loop kernel's modes: (margin, read-ahead bytes of a stream); the wide
# margin sends thousands of lanes to the host rule, the small read-ahead
# ends launches with "window exhausted"
GAUSS_MODES = {"default": (None, None), "margin 2^-3": (2.0 ** -3, None),
               "read-ahead 64 KiB": (None, 1 << 16)}
LAST_KEYS = ("launches", "exits", "phases", "rounds", "used", "read_ahead")


def gauss_call(gaussian, kind: str, seed: bytes, c, s, n: int, device: str):
    """One ``sample_device`` call of a new sampler on ``device``: (int64
    [n], the samplers whose streams it drew)."""
    import torch

    if kind == "cosac":
        smp = gaussian.COSACSampler(seed, device=device)
        out = smp.sample_device(torch.from_numpy(c).to(device),
                                torch.from_numpy(s).to(device))
        return out, (smp.base, smp.rounded.base)
    smp = gaussian.RoundedGaussianSampler(seed, device=device)
    return smp.sample_device(c, s, n), (smp.base,)


def numpy_call(gaussian, kind: str, seed: bytes, c, s, n: int):
    """The numpy sampler's draw of the same seed on the host."""
    if kind == "cosac":
        smp = gaussian.COSACSampler(seed, device="cpu")
        return smp.sample(c, s), (smp.base, smp.rounded.base)
    smp = gaussian.RoundedGaussianSampler(seed, device="cpu")
    return smp.sample(c, s, n), (smp.base,)


def same_streams(a, b, what: str) -> None:
    for x, y in zip(a, b):
        if (x._consumed, x._ptr) != (y._consumed, y._ptr) or not np.array_equal(
                x._host_buf(), y._host_buf()):
            raise AssertionError(f"{what}: the samplers' states differ")


def gauss_phase(params, params_pk, errs: dict):
    """The Gaussian kernel (csrc/gaussian.cu).  The loop entry: each
    ``sample_device`` call of the main path's shapes (the N = 2^19 commit's
    147,712 COSAC lanes in its three sigma classes, its mask-noise draw of
    10,752 rounded lanes, a PublicKey commitment's 35,328 COSAC lanes, bfv's
    sigmas 4.79 and 6.77), in each of GAUSS_MODES, gives on the card the
    same integers and leaves both streams' samplers (``_consumed``,
    ``_ptr``, ``_buf``) as ``gauss_loop_plain`` on the card and as the
    numpy sampler of the same seed, with the same launches, exits, phases
    and bytes as the plain version; at least one flagged and
    one "window exhausted" resume are driven.  The step entry: every step
    of those plain runs (``gauss_step`` routed to ``gauss_plain``) is held
    against ``gauss_cuda`` on the same tensors, exact.  Times the loop
    kernel per call (CUDA events, relaunched from the call's first state)
    at 147,712 and 35,328 lanes beside its plain version and its bound
    (``loop_bound`` of the timed call),
    and each op's step kernel at its largest step."""
    import torch

    from ringo_tpu_torch.csprng import gaussian

    errs["gauss"] = 0
    pk_c, pk_s = cosac_lanes(params_pk, "publickey")
    cm_c, cm_s = cosac_lanes(params, "commit")
    n_mask = (params.mlwe_rank + params.in_msis_rank) * params.degree
    cases = [("commit", "cosac", cm_c, cm_s, len(cm_c)),
             ("noise mask", "rounded", 0.0, params.mask_mlwe_std_dev, n_mask),
             ("PublicKey commit", "cosac", pk_c, pk_s, len(pk_c)),
             ("bfv sigmas", "cosac", pk_c,
              np.repeat([4.79, 6.77], len(pk_c) // 2), len(pk_c))]
    held, largest = [0], {}

    def hold_step(op, n, **ins):
        """The step kernel against the plain version on the same tensors
        (COSAC writes ``out`` in place: the kernel gets a copy)."""
        mine = {k: v.clone() if k == "out" else v for k, v in ins.items()}
        got = gaussian.gauss_cuda(op, n, **mine)
        want = gaussian.gauss_plain(op, n, **ins)
        for k, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None):
                raise AssertionError(f"gauss {gaussian.OPS[op]}: output {k}")
            if g is not None:   # floats compared as their bits
                bits = lambda t: t.view(torch.int64) if t.is_floating_point() else t
                errs["gauss"] = max(errs["gauss"], max_abs_err(
                    bits(g), bits(w), f"gauss {gaussian.OPS[op]} step of {n} lanes"))
        held[0] += 1
        if n > largest.get(op, (0,))[0] and gaussian.MARGIN == margin0:
            largest[op] = (n, {k: v.clone() for k, v in ins.items()})
        return want

    loop, step, margin0 = gaussian.gauss_loop, gaussian.gauss_step, gaussian.MARGIN
    lane_bytes, slack = gaussian.LANE_BYTES, gaussian.WINDOW_SLACK
    draws, flagged, exhausted = [], 0, 0
    try:
        for label, kind, c, s, n in cases:
            for mode, (margin, window) in GAUSS_MODES.items():
                gaussian.MARGIN = margin0 if margin is None else margin
                if window is None:
                    gaussian.LANE_BYTES, gaussian.WINDOW_SLACK = lane_bytes, slack
                else:   # every read-ahead of that size
                    gaussian.LANE_BYTES = {k: (0, 0) for k in lane_bytes}
                    gaussian.WINDOW_SLACK = window
                seed = b"gauss " + label.encode() + b" " + mode.encode()
                la0, sy0 = gauss_launches(), gaussian.SYNCS
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got, k_smp = gauss_call(gaussian, kind, seed, c, s, n, "cuda")
                torch.cuda.synchronize()
                card_ms = (time.perf_counter() - t0) * 1e3
                k_last = dict(gaussian.LAST)
                launches, syncs = gauss_launches() - la0, gaussian.SYNCS - sy0
                gaussian.gauss_loop = gaussian.gauss_loop_plain
                gaussian.gauss_step = hold_step
                try:
                    plain, p_smp = gauss_call(gaussian, kind, seed, c, s, n, "cuda")
                finally:
                    gaussian.gauss_loop, gaussian.gauss_step = loop, step
                p_last = dict(gaussian.LAST)
                want, h_smp = numpy_call(gaussian, kind, seed, c, s, n)
                what = f"gauss loop {label}, {mode}"
                errs["gauss"] = max(errs["gauss"], max_abs_err(got, plain, what))
                errs["gauss"] = max(errs["gauss"], max_abs_err(
                    got, torch.from_numpy(want).to("cuda"), what + " (numpy)"))
                same_streams(k_smp, p_smp, what)
                same_streams(k_smp, h_smp, what + " (numpy)")
                for key in LAST_KEYS:
                    if k_last[key] != p_last[key]:
                        raise AssertionError(f"{what}: {key} {k_last[key]} != "
                                             f"{p_last[key]} of the plain version")
                if launches != k_last["launches"] or syncs != launches + \
                        k_last["exits"].count("flagged"):
                    raise AssertionError(f"{what}: {launches} launches, {syncs} syncs")
                flagged += k_last["exits"].count("flagged")
                exhausted += k_last["exits"].count("window exhausted")
                draws.append(dict(label=label, mode=mode, lanes=n, card_ms=card_ms,
                                  syncs=syncs, grid=k_last["grid"],
                                  barriers=k_last["barriers"],
                                  **{k: k_last[k] for k in LAST_KEYS}))
                log(f"gauss loop {label} ({n} lanes, {mode}): equal to "
                    f"gauss_loop_plain on the card and to numpy, streams too; "
                    f"call {card_ms:.2f} ms on the host clock, {launches} "
                    f"launches (exits {k_last['exits'] or 'none'}), {syncs} "
                    f"syncs, {k_last['phases']} phases, {k_last['barriers']} "
                    f"grid barriers (the kernel's), {k_last['rounds']} COSAC "
                    f"rounds, grid "
                    f"{k_last['grid']} blocks, bytes used / read ahead "
                    f"{k_last['used']} / {k_last['read_ahead']}")
    finally:
        gaussian.MARGIN = margin0
        gaussian.LANE_BYTES, gaussian.WINDOW_SLACK = lane_bytes, slack
    if not flagged or not exhausted:
        raise AssertionError(f"gauss loop: {flagged} flagged and {exhausted} "
                             "window-exhausted resumes (both must be driven)")
    log(f"gauss: {held[0]} steps of the plain loop equal to the step kernel "
        f"on the card; {flagged} flagged and {exhausted} window-exhausted "
        f"resumes driven")
    loops = []
    for label, kind, c, s, n in cases:
        if kind != "cosac" or label == "bfv sigmas":
            continue
        ms, plain_ms, used, (b, by) = time_loop(gaussian, label, c, s, n)
        loops.append(dict(label=label, lanes=n, ms=ms, plain_ms=plain_ms,
                          used=used, bound_ms=b, bound_by=by))
        log(f"gauss loop kernel, {label} ({n} lanes): {ms:.4f} ms a call, "
            f"bound {b:.4f} ms ({by}: {24 * n} bytes of centres, sigmas and "
            f"output, {used} stream bytes), share {b / ms:.3f}; "
            f"gauss_loop_plain on the card {plain_ms:.3f} ms")
    passes = []
    for op, (n, ins) in sorted(largest.items()):
        name = gaussian.OPS[op]
        ms = bench.time_ms(lambda: gaussian.gauss_cuda(op, n, **ins))
        plain_ms = bench.time_ms(lambda: gaussian.gauss_plain(op, n, **ins))
        b, by = gauss_bound(name, n)
        passes.append(dict(op=name, lanes=n, ms=ms, plain_ms=plain_ms,
                           bound_ms=b, bound_by=by))
        log(f"gauss {name} step at {n} lanes: kernel {ms:.4f} ms, bound "
            f"{b:.4f} ms ({by}), share {b / ms:.3f}; plain {plain_ms:.4f} ms")
    w = loops[0]
    return dict(name="gaussian", route="cuda",
                source="ringo_tpu_torch/csrc/gaussian.cu",
                replaces="ringo_tpu/csprng/gaussian.py:440",
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], library_ms=None, loops=loops,
                passes=passes, draws=draws,
                shape=f"loop call, {w['lanes']} COSAC lanes", kernel="gauss")


def time_loop(gaussian, label: str, c, s, n: int):
    """(loop kernel ms, plain version ms, stream bytes used, its
    ``loop_bound``) of one COSAC call, each relaunched from the call's
    first state on the same read-aheads (CUDA events; the plain version's
    steps routed to ``gauss_plain``, the last run's steps counted)."""
    import torch

    smp = gaussian.COSACSampler(b"gauss timing " + label.encode(), device="cuda")
    cc = torch.from_numpy(c).to("cuda")
    c_int = torch.round(cc)
    L = gaussian._Loop(gaussian.COSAC_CALL, n, "cuda", c=c_int, cf=c_int - cc,
                       s=torch.from_numpy(s).to("cuda"), base=smp.base,
                       rounded=smp.rounded.base)
    st0, steps = L.st.copy(), []

    def run(fn):
        L.st[:] = st0
        del steps[:]
        fn(L)

    ms = bench.time_ms(lambda: run(gaussian.gauss_loop_cuda))
    torch.cuda.synchronize()
    if int(L.st_pin[gaussian.S_STATUS]) != gaussian.DONE:
        raise AssertionError(f"gauss loop {label}: the timed call exited")
    out = L.out.clone()
    step = gaussian.gauss_step
    def plain_step(op, k, **kw):
        steps.append((op, k))
        return gaussian.gauss_plain(op, k, **kw)

    gaussian.gauss_step = plain_step
    try:
        plain_ms = bench.time_ms(lambda: run(gaussian.gauss_loop_plain),
                                 reps=1)
    finally:
        gaussian.gauss_step = step
    if L.st[gaussian.S_STATUS] != gaussian.DONE:
        raise AssertionError(f"gauss loop {label}: the plain call exited")
    max_abs_err(out, L.out, f"gauss loop {label} (timed)")
    used = int(L.st[gaussian.S_OFF_B] + L.st[gaussian.S_OFF_R])
    return ms, plain_ms, used, loop_bound(n, used, steps)


def gauss_launches() -> int:
    from ringo_tpu_torch import backend

    return backend.LAUNCHES["gauss"]


# -------------------------------------------------------- field-sample phase

def host_segments(spec, u, segments):
    """The numpy host loop on the port's sampler ``u`` (the JAX package's
    sample_field_digits, ringo_tpu/jindo/prover.py:28-45, then
    ``_take_bytes`` for raw bytes): per segment int64 planes [w, n] or
    uint8 bytes."""
    w = spec.w
    top = (1 << (spec.bits - 16 * (w - 1))) - 1
    pd = spec.p_digits.astype(np.int64)
    out = []
    for kind, n in segments:
        if kind == "bytes":
            out.append(u._take_bytes(n).copy())
            continue
        res = np.zeros((w, n), dtype=np.int64)
        need = np.arange(n)
        while len(need):
            cand = u._take_bytes(2 * w * len(need)).view("<u2").reshape(
                len(need), w).T.astype(np.int64)
            cand[-1] &= top
            lt = np.zeros(len(need), dtype=bool)
            decided = np.zeros(len(need), dtype=bool)
            for i in range(w - 1, -1, -1):   # cand < p, from the top digit
                lt |= ~decided & (cand[i] < pd[i])
                decided |= cand[i] != pd[i]
            res[:, need[lt]] = cand[:, lt]
            need = need[~lt]
        out.append(res)
    return out


FIELD_LAST_KEYS = ("launches", "exits", "mid_segment_exits", "rounds",
                   "chunks", "used", "read_ahead")


def field_bound(spec, segments, used: int):
    """Least time of one draw: the stream bytes it commits read once and
    its outputs (8 bytes a digit, the raw bytes) written once, or one
    integer operation a digit of every candidate, whichever is larger."""
    out = sum(8 * spec.w * n if kind == "field" else n for kind, n in segments)
    return bench.bound_ms(used + out, used // 2)


def field_phase(jindo, params, params_pk, errs: dict):
    """The field-sampling kernel (csrc/field_sample.cu, one launch a
    ``draw_segments`` call): at the N = 2^19 commit's segments (last row,
    mask column, two keys), a PublicKey (13, ZP220) commitment's and a
    three-commit batch's, 40 one-lane segments (Buckler's blinds), ZP880
    (w = 55), the commit's segments through 16 KiB read-aheads (resumes), a
    segment of more candidates than the kernel's shared tile holds (its
    flags in the scratch area), RAW segments that leave the next field
    segment at odd alignments (ZP220), a 2,080-lane ZP220 segment through
    8 KiB read-aheads (the kernel stops inside the segment and resumes from
    its pending need list) and 20 31-lane ZP880 segments through
    read-aheads of the 8 KiB buffer (the warp-only path stops inside
    segments), each drawn on the card by the kernel, by its plain version
    on the card (``field_sample_plain``) and by the numpy host loop on the
    CPU from the same seed: every digit and byte equal, the three samplers'
    states equal, the same launches, exits, rounds, chunks and bytes in
    kernel and plain version, and one sync a launch.  Times the kernel (``time_field``)
    at the commit's, a PublicKey commitment's, the batch's, the blinds',
    ZP880's and the large segment's draws beside its plain version and its
    bound."""
    import torch

    from ringo_tpu_torch import backend
    from ringo_tpu_torch.csprng import field_sample
    from ringo_tpu_torch.csprng.uniform import UniformSampler
    from ringo_tpu_torch.fields import ZP220, ZP880

    errs["field"] = 0
    pk_rank = params_pk.rank
    cases = [
        (f"Jindo commit N=2^{LOG_N}", params.spec,
         bench.commit_segments(params, [params.rank]), None),
        ("PublicKey (13, ZP220) commitment", ZP220,
         bench.commit_segments(params_pk, [pk_rank]), None),
        ("PublicKey three-commit batch", ZP220,
         bench.commit_segments(params_pk, [pk_rank, pk_rank // 2, 1000]),
         None),
        ("blinds (40 one-lane segments)", ZP220, [("field", 1)] * 40, None),
        ("ZP880", ZP880, [("field", 1), ("field", 2080), ("bytes", 32),
                          ("field", 127)], None),
        ("Jindo commit, 16 KiB read-aheads", params.spec,
         bench.commit_segments(params, [params.rank]), 1 << 14),
        ("ZP255 segment past the shared tile", params.spec,
         [("field", 20000), ("bytes", 64), ("field", 3000)], None),
        ("ZP220 RAW segments at odd alignments", ZP220,
         [("bytes", 3), ("field", 5000), ("bytes", 37), ("field", 3001),
          ("bytes", 64), ("field", 1), ("field", 40)], None),
        ("ZP220 2,080 lanes, 8 KiB read-aheads", ZP220,
         [("field", 5), ("bytes", 64), ("field", 2080)], 1 << 13),
        ("ZP880 20 31-lane segments, 8 KiB read-aheads", ZP880,
         [("field", 31)] * 20, 100),
    ]
    timed = (0, 1, 2, 3, 4, 6)
    slack, window = field_sample.SLACK, field_sample.WINDOW_SLACK
    run, draws, resumes = field_sample.field_sample, [], 0
    try:
        for label, spec, segs, ahead in cases:
            if ahead is None:
                field_sample.SLACK, field_sample.WINDOW_SLACK = slack, window
            else:   # every read-ahead of that size
                field_sample.SLACK, field_sample.WINDOW_SLACK = 0.0, ahead
            seed = b"field " + label.encode()
            la0, sy0 = backend.LAUNCHES["field"], field_sample.SYNCS
            k_smp = UniformSampler(seed, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = field_sample.draw_segments(spec, k_smp, segs)
            torch.cuda.synchronize()
            card_ms = (time.perf_counter() - t0) * 1e3
            k_last = dict(field_sample.LAST)
            launches = backend.LAUNCHES["field"] - la0
            syncs = field_sample.SYNCS - sy0
            p_smp = UniformSampler(seed, device="cuda")
            field_sample.field_sample = field_sample.field_sample_plain
            try:
                plain = field_sample.draw_segments(spec, p_smp, segs)
            finally:
                field_sample.field_sample = run
            p_last = dict(field_sample.LAST)
            h_smp = UniformSampler(seed, device="cpu")
            want = host_segments(spec, h_smp, segs)
            what = f"field sample {label}"
            for k, (g, pl, h) in enumerate(zip(got, plain, want)):
                errs["field"] = max(errs["field"], max_abs_err(
                    g, pl, f"{what}, segment {k}"))
                errs["field"] = max(errs["field"], max_abs_err(
                    g, torch.from_numpy(h).to("cuda"), f"{what}, segment {k} "
                    "(numpy)"))
            same_streams([k_smp], [p_smp], what)
            same_streams([k_smp], [h_smp], what + " (numpy)")
            for key in FIELD_LAST_KEYS:
                if k_last[key] != p_last[key]:
                    raise AssertionError(f"{what}: {key} {k_last[key]} != "
                                         f"{p_last[key]} of the plain version")
            if launches != k_last["launches"] or syncs != launches:
                raise AssertionError(f"{what}: {launches} launches, {syncs} syncs")
            if ahead is None and launches != 1:
                raise AssertionError(f"{what}: {launches} launches, not one")
            if ahead in (1 << 13, 100) and not k_last["mid_segment_exits"]:
                raise AssertionError(f"{what}: no stop inside a segment")
            resumes += k_last["exits"]
            lanes = sum(n for kind, n in segs if kind == "field")
            draws.append(dict(label=label, w=spec.w, segments=len(segs),
                              lanes=lanes, card_ms=card_ms, syncs=syncs,
                              **{k: k_last[k] for k in FIELD_LAST_KEYS}))
            log(f"{what} ({len(segs)} segments, {lanes} lanes, w={spec.w}): "
                f"equal to field_sample_plain on the card and to the numpy "
                f"host loop, samplers too; call {card_ms:.2f} ms on the host "
                f"clock, {launches} launches ({k_last['exits']} exits), "
                f"{syncs} syncs, {k_last['rounds']} rounds, "
                f"{k_last['chunks']} chunks, {k_last['mid_segment_exits']} "
                f"stops inside a segment, bytes used / read ahead "
                f"{k_last['used']} / {k_last['read_ahead']}")
    finally:
        field_sample.SLACK, field_sample.WINDOW_SLACK = slack, window
    if not resumes:
        raise AssertionError("field sample: no read-ahead-short resume driven")
    timings = []
    for k in timed:
        label, spec, segs, _ = cases[k]
        t = time_field(field_sample, label, spec, segs)
        b, by = field_bound(spec, segs, t["used"])
        timings.append(dict(label=label, **t, bound_ms=b, bound_by=by))
        log(f"field sample kernel, {label}: through the wrapper "
            f"{t['ms']:.4f} ms a call; C entry {t['device_ms']:.4f} ms back "
            f"to back, {t['cold_ms']:.4f} ms cold; {t['rounds']} rounds, "
            f"bound {1e3 * b:.3f} us ({by}: {t['used']} stream bytes and the "
            f"outputs), share of the cold time {b / t['cold_ms']:.5f}; "
            f"field_sample_plain on the card {t['plain_ms']:.3f} ms")
    t = timings[0]
    return dict(name="field_sample", route="cuda",
                source="ringo_tpu_torch/csrc/field_sample.cu",
                replaces="ringo_tpu/jindo/prover.py:28",
                ms=t["ms"], device_ms=t["device_ms"], cold_ms=t["cold_ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None, timings=timings,
                draws=draws, shape=f"a commit's draws, {cases[0][0]}",
                kernel="field")


def time_field(field_sample, label: str, spec, segs) -> dict:
    """One draw's times, each relaunched from the call's first state on
    the same read-ahead: the wrapper ``field_sample_cuda`` by CUDA events
    over back-to-back calls (``ms``, as every kernel row is timed; it packs
    its numpy arguments, makes the ctypes call and copies the state to
    pinned memory a call); the C entry ``ringo_field_sample`` with its
    arguments prepared once (``field_sample.launch_args``), back to back
    (``device_ms``) and one call at a time after a 128 MB read that leaves
    none of its bytes in L2 (``cold_ms``); the plain version
    (``plain_ms``).  With the bytes used and the rounds."""
    import torch

    from ringo_tpu_torch import backend
    from ringo_tpu_torch.csprng.uniform import UniformSampler

    D = field_sample._Draw(spec, UniformSampler(
        b"field timing " + label.encode(), device="cuda"), segs)
    D.open(D.budget())
    st0 = D.st.copy()

    def run(fn):
        D.st[:] = st0
        fn(D)

    ms = bench.time_ms(lambda: run(field_sample.field_sample_cuda))
    torch.cuda.synchronize()
    st = D.st_pin.numpy().copy()
    if st[field_sample.S_STATUS] != field_sample.DONE:
        raise AssertionError(f"field sample {label}: the timed call exited")
    out, raw = D.out.clone(), D.raw.clone()
    D.st[:] = st0
    args = field_sample.launch_args(D)
    entry, stream = backend.lib().ringo_field_sample, backend.stream_ptr(D.out)

    def call():
        backend.check(entry(args.ctypes.data, stream), "field_sample")

    device_ms = bench.time_ms(call, reps=50, windows=5)
    cold = bench.cold_ms(call)
    torch.cuda.synchronize()
    if not np.array_equal(D.st_dev.cpu().numpy(), st):
        raise AssertionError(f"field sample {label}: the C entry's state differs")
    max_abs_err(out, D.out, f"field sample {label} (C entry)")
    max_abs_err(raw, D.raw, f"field sample {label} (C entry bytes)")
    plain_ms = bench.time_ms(lambda: run(field_sample.field_sample_plain),
                             reps=1)
    if not np.array_equal(D.st, st):
        raise AssertionError(f"field sample {label}: timed states differ")
    max_abs_err(out, D.out, f"field sample {label} (timed)")
    max_abs_err(raw, D.raw, f"field sample {label} (timed bytes)")
    return dict(ms=ms, device_ms=device_ms, cold_ms=cold, plain_ms=plain_ms,
                used=int(st[field_sample.S_OFF]),
                rounds=int(st[field_sample.S_ROUNDS]))


# ----------------------------------------------------------- big-field phase

BIGFIELD_FIELDS = ("ZP110", "ZP128", "ZP220", "ZP240", "ZP255", "ZP440", "ZP880")


def barrett_word_products(w: int) -> int:
    """32 x 32-bit word products of Barrett on ceil(w / 2)-word values:
    the words 0 .. w of floor(z / B^(w-1)) * mu (q_hat is digits w + 1 ..
    2w + 1) and the low ceil((w + 2) / 2) words of q_hat * p."""
    h, hq, hz = (w + 1) // 2, (w + 2) // 2, (w + 3) // 2
    q = sum(1 for i in range(hz) for j in range(hz) if i + j <= w)
    qp = sum(1 for i in range(hq) for j in range(h) if i + j < hz)
    return q + qp


def mul_mod_ops(w: int) -> int:
    """32-bit operations of one ``mul_mod`` lane: the word products of x *
    y and of Barrett, four each (the low and the high half of a 32 x
    32-bit product, a multiply-add each).  A count of 16 x 16-bit digit
    products, two operations each, is about twice this and not the least
    work: the word-level kernel does fewer."""
    h = (w + 1) // 2
    return 4 * (h * h + barrett_word_products(w))


def reduce_cols_ops(w: int, m: int) -> int:
    """32-bit operations of one ``reduce_cols`` lane of m columns: the fold
    products of the words of floor(z / B^(2w-1)) that m columns reach
    times B^(2w-1) mod p (below B^(2w+1)), and Barrett; four a word
    product."""
    h, s = (w + 1) // 2, 2 * w - 1
    hw = (min(m + 1, 4 * w) - s + 1) // 2 if m + 1 > s else 0
    fold = sum(1 for i in range(hw) for j in range(h) if i + j <= w)
    return 4 * (fold + barrett_word_products(w))


def bigfield_bound(ins, out, lanes: int, ops_per_lane: int):
    """Least time of one big-field call: each input read once as stored
    (a broadcast operand once), the output written once, ``ops_per_lane``
    32-bit operations a lane (a multiply-add counts two, a word step of a
    carry or borrow chain one)."""
    n_bytes = sum(t.numel() * t.element_size() for t in ins) + \
        out.numel() * out.element_size()
    return bench.bound_ms(n_bytes, lanes * ops_per_lane)


def horner_ops(w: int) -> int:
    """32-bit operations of one coefficient of Horner's rule: one multiply
    and add mod p (``mul_mod_ops`` and the ceil(w / 2) word adds of the
    addend).  The rule needs one such step a coefficient (no power
    plane), so this, not a product for the power and another for the
    coefficient, is the function's work."""
    return mul_mod_ops(w) + (w + 1) // 2


def kernel_usage(kind: str, w: int) -> dict:
    """ptxas's registers, stack frame (local memory), spills of the
    bigfield.cu kernel ``kind`` at width w (the build's ``-Xptxas -v``
    log)."""
    import re

    from ringo_tpu_torch import backend

    hits = [v for k, v in backend.kernel_resources().items()
            if re.search(rf"{kind}ILi{w}E", k)]
    if len(hits) != 1:
        raise AssertionError(f"bigfield: {len(hits)} ptxas records of "
                             f"{kind}<{w}>")
    return hits[0]


def digit_planes(spec, shape, gen, corners: bool, wide: bool):
    """Digit planes [w, *shape] on the card, uniform below p; with
    ``corners`` the first lanes of the flattened value axes are 0, 1 and
    p - 1, and with ``wide`` one more is the all-0xFFFF plane (>= p)."""
    import torch

    from ringo_tpu_torch.fields import limb

    w = spec.w
    top = spec.p >> (16 * (w - 1))
    d = torch.randint(0, 1 << 16, (w,) + tuple(shape), generator=gen,
                      dtype=torch.int64)
    d[w - 1] = torch.randint(0, top, tuple(shape), generator=gen,
                             dtype=torch.int64)
    flat = d.reshape(w, -1)
    vals = ([0, 1, spec.p - 1] if corners else []) + \
        ([(1 << (16 * w)) - 1] if wide else [])
    if vals and flat.shape[1] >= len(vals):
        flat[:, :len(vals)] = limb.ints_to_digits(vals, w)
    return d.to("cuda")


def bigfield_phase(errs: dict):
    """The big-field kernel (csrc/bigfield.cu) against its plain versions
    on the card, exactly: every entry point at each of the seven field
    widths, with the corner values 0, 1, p - 1 (and the all-0xFFFF plane
    where the plain version takes values >= p: all but the tree sum),
    broadcast and sliced operands, and ``reduce_cols`` at every column
    count that changes its path (the mul_mod, reduce_cols, horner and
    powers kernels' ptxas registers, stack frame and spills logged a
    width, none in local memory at w <= 28); horner and powers at every
    kind of point, n = 1, a sliced vs, several blocks and t = 43; then at the
    cells' shapes: the Jindo evaluate's horner and the verifier's tree sum
    at [16, 1, 2^19], the PublicKey ring's horner, powers and tree sum at
    [14, t, 2^15], ``reduce_cols`` at ``BigLinMap``'s column counts and
    the CRT cutoff's ``geq`` of a commit.  Times ``mul_mod`` at [16, 2^19]
    and horner at [16, 1, 2^19] (kernel, plain version, bound) and each
    other entry point at a cell's shape beside its bound."""
    import torch

    from ringo_tpu_torch import fields
    from ringo_tpu_torch.fields import bigfield, limb
    from ringo_tpu_torch.ops import horner
    from ringo_tpu_torch.ops.bigmul import BigMul

    gen = torch.Generator(device="cpu").manual_seed(23)
    errs["bigfield"] = 0

    def hold(got, want, what):
        torch.cuda.synchronize()
        errs["bigfield"] = max(errs["bigfield"], max_abs_err(got, want, what))

    def hold_all(spec, big, x, y, what, canonical: bool):
        """Every entry point on x, y (broadcasting against each other)."""
        q = torch.tensor(big.p_digits, device="cuda").reshape(
            (spec.w,) + (1,) * (x.dim() - 1))
        hold(big.mul_mod(x, y), big.mul_mod_plain(x, y), f"mul_mod {what}")
        hold(limb.add(x, y, q), limb.add_plain(x, y, q), f"add {what}")
        hold(limb.sub(x, y, q), limb.sub_plain(x, y, q), f"sub {what}")
        hold(limb.neg(x, q), limb.neg_plain(x, q), f"neg {what}")
        hold(limb.geq(x, y), limb.geq_plain(x, y), f"geq {what}")
        if canonical and x.dim() > 1:
            hold(horner.tree_sum(big, x), horner.tree_sum_plain(big, x),
                 f"tree_sum {what}")

    def hold_horner(plan, vs, pt, what):
        """HORNER and POWERS against eval_stacked_plain and powers_plain."""
        n = vs.shape[2]
        steps = plan.steps_for(pt, n).to("cuda")
        hold(plan.eval_stacked(vs, steps), plan.eval_stacked_plain(vs, steps),
             f"horner {what}")
        hold(plan.powers(pt, n, "cuda"), plan.powers_plain(steps, n),
             f"powers {what}")

    for name in BIGFIELD_FIELDS:
        spec = getattr(fields, name)
        big, w = BigMul(spec), spec.w
        x = digit_planes(spec, (3, 700), gen, True, True)
        y = digit_planes(spec, (3, 700), gen, True, True).flip(-1)
        hold_all(spec, big, x, y, f"{name} [w, 3, 700] with 0xFFFF", False)
        x = digit_planes(spec, (3, 700), gen, True, False)
        y = digit_planes(spec, (3, 700), gen, True, False).flip(-1)
        hold_all(spec, big, x, y, f"{name} [w, 3, 700]", True)
        # broadcast and sliced operands, as the callers pass them
        P = digit_planes(spec, (900,), gen, True, False)
        hold_all(spec, big, x, P[:, None, :700], f"{name} [w, t, n] x [w, 1, n]", True)
        hold_all(spec, big, P[:, :50], P[:, 7][:, None], f"{name} [w, m] x [w, 1]", True)
        hold_all(spec, big, x[:, :, None, :40], P[:, None, :30, None],
                 f"{name} [w, a, 1, c] x [w, 1, b, 1]", True)
        hold_all(spec, big, x[..., :350], x[..., 350:], f"{name} halves", True)
        hold_all(spec, big, x.transpose(1, 2), y.transpose(1, 2),
                 f"{name} transposed", True)
        hold(horner.tree_sum(big, x[:, :, :1]), horner.tree_sum_plain(big, x[:, :, :1]),
             f"tree_sum {name} m = 1")
        hold(horner.tree_sum(big, P), horner.tree_sum_plain(big, P),
             f"tree_sum {name} [w, m] -> [w]")
        hold(horner.tree_sum(big, x[..., 1:]), horner.tree_sum_plain(big, x[..., 1:]),
             f"tree_sum {name} at an odd offset (no pair loads)")
        # Horner's evaluation and the powers at every point kind; the
        # digit planes carry 0, 1, p - 1 and the all-0xFFFF plane
        plan = horner.HornerPlan(spec)
        vs = digit_planes(spec, (3, 700), gen, True, True)
        for label, pt in (("0", 0), ("1", 1), ("p-1", spec.p - 1),
                          ("random", int(torch.randint(1, 1 << 62, (1,),
                                                       generator=gen)))):
            hold_horner(plan, vs, pt, f"{name} [w, 3, 700] x = {label}")
        hold_horner(plan, vs[:, :, :1], 5, f"{name} n = 1")
        hold_horner(plan, vs[:, 1:, 5:600], 7, f"{name} sliced [w, 2, 595]")
        hold_horner(plan, digit_planes(spec, (1, 1 << 15), gen, True, False),
                    11, f"{name} [w, 1, 2^15] (several blocks)")
        # reduce_cols: BigLinMap's 2w + 1 columns (< 2^18), a verifier
        # magnitude's 8 digits, the first fold (2w - 1, 2w), more columns
        # than reach the kept digits, columns up to 2^23, all 0xFFFF and
        # all 2^23 - 1
        for m, hi in ((2 * w + 1, 1 << 18), (8, 1 << 16), (2 * w - 1, 1 << 23),
                      (2 * w, 1 << 23), (4 * w + 3, 1 << 23)):
            cols = torch.randint(0, hi, (m, 5, 300), generator=gen,
                                 dtype=torch.int64)
            cols[:, 0, 0] = 0xFFFF
            cols[:, 0, 1] = 0
            cols[:, 0, 2] = (1 << 23) - 1
            cols = cols.to("cuda")
            hold(big.reduce_cols(cols), big.reduce_cols_plain(cols),
                 f"reduce_cols {name} m = {m}")
            hold(big.reduce_cols(cols[:, :, ::2]), big.reduce_cols_plain(cols[:, :, ::2]),
                 f"reduce_cols {name} m = {m} strided")
        log(f"bigfield {name} (w = {w}): mul_mod, reduce_cols, tree_sum, add, "
            "sub, neg, geq, horner, powers equal to plain (corner values, "
            "broadcast, sliced)")
        for kind in ("mul_mod_kernel", "reduce_cols_kernel", "horner_kernel",
                     "powers_kernel"):
            u = kernel_usage(kind, w)
            log(f"bigfield {kind}<{w}>: {u['registers']} registers, "
                f"{u['stack']} bytes stack frame (local memory), "
                f"{u['spill_stores']} / {u['spill_loads']} bytes spill "
                f"stores / loads, {u['lmem']} bytes lmem")
            if w <= 28 and (u["stack"] or u["spill_stores"] or u["lmem"]):
                raise AssertionError(f"bigfield: {kind}<{w}> uses local "
                                     "memory")
    spec = fields.ZP240
    hold_horner(horner.HornerPlan(spec), digit_planes(spec, (43, 300), gen, True, True),
                13, "ZP240 t = 43 [15, 43, 300]")

    # the cells' shapes
    passes = []

    def timed_pass(label, fn, plain, ins, lanes, ops):
        got = fn()
        hold(got, plain(), label)
        ms = bench.time_ms(fn)
        b, by = bigfield_bound(ins, got, lanes, ops)
        passes.append(dict(label=label, ms=ms, bound_ms=b, bound_by=by))
        log(f"bigfield {label}: kernel {ms:.4f} ms, bound {b:.4f} ms ({by}), "
            f"share {b / ms:.3f}, equal to plain")
        return got

    n = 1 << LOG_N                   # the evaluate's Horner lanes
    spec = fields.ZP255
    big, w = BigMul(spec), spec.w
    x = digit_planes(spec, (n,), gen, True, False)
    y = digit_planes(spec, (n,), gen, True, False).flip(-1)
    mm = timed_pass(f"mul_mod ZP255 [16, 2^{LOG_N}]",
                    lambda: big.mul_mod(x, y), lambda: big.mul_mod_plain(x, y),
                    (x, y), n, mul_mod_ops(w))
    plain_ms = bench.time_ms(lambda: big.mul_mod_plain(x, y), reps=3)
    row = dict(name="bigfield", route="cuda",
               source="ringo_tpu_torch/csrc/bigfield.cu",
               replaces="ringo_tpu/ops/bigmul.py:136",
               ms=passes[0]["ms"], plain_ms=plain_ms,
               bound_ms=passes[0]["bound_ms"], bound_by=passes[0]["bound_by"],
               library_ms=None, shape=f"mul_mod [16, 2^{LOG_N}] int64",
               kernel="bigfield", passes=passes)
    log(f"bigfield mul_mod [16, 2^{LOG_N}]: plain version {plain_ms:.3f} ms")
    # the Jindo evaluate's Horner call: [16, 1, 2^19] at the round trip's
    # point, and the verifier's tree sum at the same shape
    plan = horner.HornerPlan(spec)
    vs = x[:, None, :]
    steps = plan.steps_for(X_POINT % spec.p, n).to("cuda")
    timed_pass(f"horner ZP255 [16, 1, 2^{LOG_N}]",
               lambda: plan.eval_stacked(vs, steps),
               lambda: plan.eval_stacked_plain(vs, steps), (vs, steps), n,
               horner_ops(w))
    row["horner_plain_ms"] = bench.time_ms(
        lambda: plan.eval_stacked_plain(vs, steps), reps=3)
    timed_pass(f"tree_sum [16, 1, 2^{LOG_N}]",
               lambda: horner.tree_sum(big, vs),
               lambda: horner.tree_sum_plain(big, vs), (vs,), n, 2 * w)
    q = torch.tensor(big.p_digits, device="cuda").reshape(w, 1)
    for label, fn, plain in (
            ("add", lambda: limb.add(x, y, q), lambda: limb.add_plain(x, y, q)),
            ("sub", lambda: limb.sub(x, y, q), lambda: limb.sub_plain(x, y, q)),
            ("geq", lambda: limb.geq(x, y), lambda: limb.geq_plain(x, y))):
        timed_pass(f"{label} ZP255 [16, 2^{LOG_N}]", fn, plain, (x, y, q)
                   if label != "geq" else (x, y), n, 2 * w)
    timed_pass(f"neg ZP255 [16, 2^{LOG_N}]", lambda: limb.neg(x, q),
               lambda: limb.neg_plain(x, q), (x, q), n, 2 * w)
    del x, y, mm, vs
    # the PublicKey ring (ZP220, rank 2^15): Horner over t polynomials,
    # the embedding NTT's reduce_cols at BigLinMap's 2w + 1 columns
    spec = fields.ZP220
    big, w = BigMul(spec), spec.w
    t, nr = 4, 1 << 15
    v = digit_planes(spec, (t, nr), gen, True, False)
    P = digit_planes(spec, (nr,), gen, True, False)
    timed_pass(f"mul_mod ZP220 [14, {t}, 2^15] x [14, 1, 2^15]",
               lambda: big.mul_mod(v, P[:, None, :]),
               lambda: big.mul_mod_plain(v, P[:, None, :]),
               (v, P), t * nr, mul_mod_ops(w))
    plan = horner.HornerPlan(spec)
    pt = X_POINT % spec.p
    steps = plan.steps_for(pt, nr).to("cuda")
    timed_pass(f"horner ZP220 [14, {t}, 2^15]",
               lambda: plan.eval_stacked(v, steps),
               lambda: plan.eval_stacked_plain(v, steps), (v, steps), t * nr,
               horner_ops(w))
    timed_pass("powers ZP220 [14, 2^15]",
               lambda: bigfield.powers_cuda(big, steps, nr),
               lambda: plan.powers_plain(steps, nr), (steps,), nr,
               mul_mod_ops(w))
    timed_pass(f"tree_sum ZP220 [14, {t}, 2^15]",
               lambda: horner.tree_sum(big, v),
               lambda: horner.tree_sum_plain(big, v), (v,), t * nr, 2 * w)
    cols = torch.randint(0, 1 << 18, (2 * w + 1, 32, 2048), generator=gen,
                         dtype=torch.int64).to("cuda")
    timed_pass(f"reduce_cols ZP220 [{2 * w + 1}, 32, 2048]",
               lambda: big.reduce_cols(cols), lambda: big.reduce_cols_plain(cols),
               (cols,), 32 * 2048, reduce_cols_ops(w, cols.shape[0]))
    # the CRT cutoff of a commit: geq of 8-digit magnitudes [8, 28, 256]
    # against [8, 1, 1] (a digit count that is no field's)
    a = torch.randint(0, 1 << 16, (8, 28, 256), generator=gen,
                      dtype=torch.int64).to("cuda")
    half = torch.randint(0, 1 << 16, (8, 1, 1), generator=gen,
                         dtype=torch.int64).to("cuda")
    timed_pass("geq CRT cutoff [8, 28, 256] x [8, 1, 1]",
               lambda: limb.geq(a, half), lambda: limb.geq_plain(a, half),
               (a, half), 28 * 256, 8)
    del v, P, cols, a
    torch.cuda.empty_cache()
    if bigfield.WIDTHS != tuple(getattr(fields, f).w for f in BIGFIELD_FIELDS):
        raise AssertionError("bigfield: the phase does not cover every width")
    return row


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

    backend.reset_launches()
    t0 = time.perf_counter()
    ck = jindo.CommitKey(params, CRS, device="cuda")
    crs_s = time.perf_counter() - t0
    crs_launches = dict(backend.LAUNCHES)
    if crs_launches["aes"] <= 0:
        raise AssertionError("the CRS expansion did not launch the AES kernel")
    log(f"CRS expansion (AES-256-CTR keystream on the card) N=2^{LOG_N}: "
        f"{crs_s:.3f} s, launches {crs_launches}")
    prv = jindo.Prover(params, CRS, seed=SEED, device="cuda", ck=ck)
    v = random_values(params.spec, 1 << LOG_N, 1)
    v2 = random_values(params.spec, (1 << LOG_N) - 12345, 2)
    t0 = time.perf_counter()
    with shapes_held(checked, "warm-up commit"):
        com, op = prv.commit(v)
    torch.cuda.synchronize()
    log(f"warm-up commit: {time.perf_counter() - t0:.3f} s")
    check_commitment(params, com, op)

    # the peaks below are the commits' own, not the kernel phase's
    held_before = torch.cuda.memory_allocated() / 2 ** 30
    from ringo_tpu_torch.csprng import gaussian

    from ringo_tpu_torch.csprng import field_sample

    backend.reset_launches()
    syncs0, calls0, exits0 = gaussian.SYNCS, gaussian.CALLS, gaussian.EXITS
    f_syncs0 = field_sample.SYNCS
    (com, op), times, peak = timed(lambda: prv.commit(v))
    syncs = (gaussian.SYNCS - syncs0) / 3
    calls = (gaussian.CALLS - calls0) / 3
    exits = (gaussian.EXITS - exits0) / 3
    gauss_per_commit = backend.LAUNCHES["gauss"] / 3
    if gauss_per_commit != calls + exits or (not exits and syncs > 3):
        raise AssertionError(
            f"the Gaussian loop: {gauss_per_commit:g} launches and {syncs:g} "
            f"syncs a commit for {calls:g} calls and {exits:g} exits")
    field_per_commit = backend.LAUNCHES["field"] / 3
    field_syncs = (field_sample.SYNCS - f_syncs0) / 3
    if field_per_commit != 1 or field_syncs != 1:
        raise AssertionError(
            f"the uniform draws: {field_per_commit:g} field_sample launches "
            f"and {field_syncs:g} syncs a commit, not 1 and 1")
    f_calls0 = field_sample.CALLS
    many, _, peak_many = timed(lambda: prv.commit_many([v, v2]), reps=1)
    launches = dict(backend.LAUNCHES)
    if field_sample.CALLS - f_calls0 != 1:
        raise AssertionError("commit_many of two: its uniform draws took "
                             f"{field_sample.CALLS - f_calls0} calls, not one")
    # the uniform, COSAC and noise-mask samplers drew everything on the
    # card: none of them ever filled its host read-ahead window
    for name, smp in (("uniform", prv.uniform), ("cosac", prv.ecd.cosac.base),
                      ("cosac rounded", prv.ecd.cosac.rounded.base),
                      ("noise mask", prv.rounded.base)):
        if smp._w1 != 0:
            raise AssertionError(f"the {name} sampler copied keystream to the host")
    log(f"uniform and COSAC paths: no keystream copied to the host; per "
        f"commit {field_per_commit:g} field_sample launches and "
        f"{field_syncs:g} host syncs of the uniform draws, "
        f"{gauss_per_commit:g} gauss launches ({calls:g} sample_device calls, "
        f"{exits:g} exits) and {syncs:g} host syncs of the Gaussian loop; "
        f"commit_many of two: one field_sample call")
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
               crs_launches=crs_launches, launches=launches, peak_mem_gib=peak,
               gauss_syncs_per_commit=syncs,
               gauss_launches_per_commit=gauss_per_commit,
               gauss_calls_per_commit=calls, gauss_exits_per_commit=exits,
               field_launches_per_commit=field_per_commit,
               field_syncs_per_commit=field_syncs,
               peak_mem_many_gib=peak_many, held_before_gib=held_before)
    return rec, (prv, v, com, op)


def tampered(jindo, params, pf, field: str):
    """A copy of the proof with the lowest bit of ``field``'s first digit
    flipped (tests/test_jindo_device.py of the JAX package)."""
    bad = jindo.Proof.from_bytes(params, pf.to_bytes(params))
    planes = getattr(bad, field).clone()
    planes[(0,) * planes.dim()] ^= 1
    setattr(bad, field, planes)
    return bad


def bigfield_calls(calls: dict, reps: int) -> str:
    """Big-field launches by entry, per call of ``reps``."""
    return ", ".join(f"{k} {n / reps:g}" for k, n in calls.items() if n)


def roundtrip_phase(backend, jindo, params, checked, prv, v, com, op):
    """evaluate -> verify at N = 2^19, t = 1, on the commit phase's prover
    and key; the five tampers."""
    import torch

    from ringo_tpu_torch.fields import bigfield

    spec = params.spec
    x = X_POINT % spec.p
    held = torch.cuda.memory_allocated() / 2 ** 30
    with shapes_held(checked, "warm-up evaluate"):
        ys, pf = prv.evaluate(x, [v], [com], [op])
    backend.reset_launches()
    (ys, pf), ev_times, ev_peak = timed(
        lambda: prv.evaluate(x, [v], [com], [op]))
    ev_launches = dict(backend.LAUNCHES)
    t0 = time.perf_counter()
    want = bench.horner_ints(spec, v, x)
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
    with shapes_held(checked, "warm-up verify"):
        if vrf.verify(x, [com], ys, pf) is not True:
            raise AssertionError("verify rejected an honest proof")
    backend.reset_launches()
    calls0 = dict(bigfield.CALLS)
    ok, vf_times, vf_peak = timed(lambda: vrf.verify(x, [com], ys, pf))
    vf_launches = dict(backend.LAUNCHES)
    vf_calls = {k: n - calls0[k] for k, n in bigfield.CALLS.items()}
    if ok is not True:
        raise AssertionError("verify rejected an honest proof")
    for name, launched in (("evaluate", ev_launches), ("verify", vf_launches)):
        for k in ("ntt", "bigfield", "mac"):
            if launched[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched in {name}")
    if ev_launches["bigfield"] != len(ev_times):
        raise AssertionError(f"evaluate: {ev_launches['bigfield']} big-field "
                             f"calls in {len(ev_times)} evaluates; Horner's "
                             "evaluation is one call")
    log(f"big-field calls per evaluate {ev_launches['bigfield'] / len(ev_times):g}, "
        f"per verify {vf_launches['bigfield'] / len(vf_times):g} "
        f"({bigfield_calls(vf_calls, len(vf_times))})")
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
    with shapes_held(checked, "batch evaluate"):
        (ys, pf), ev_s, peak_ev = timed(
            lambda: prv.evaluate(x, vs, coms, opens), reps=1)
    if ys != [bench.horner_ints(spec, v, x) for v in vs]:
        raise AssertionError("batch evaluate: y != v(x)")
    vrf = jindo.Verifier(params, CRS, device="cuda", ck=prv.ck)
    with shapes_held(checked, "batch verify"):
        ok, vf_s, peak_vf = timed(lambda: vrf.verify(x, coms, ys, pf), reps=1)
    if ok is not True:
        raise AssertionError("batch verify rejected an honest proof")
    if vrf.verify(x, coms[::-1], ys, pf) is not False:
        raise AssertionError("batch verify accepted swapped commitments")
    launches = dict(backend.LAUNCHES)
    for k in ("ntt", "bigfield", "mac"):
        if launches[k] <= 0:
            raise AssertionError(f"batch of 2: kernel {k} was not launched")
    log(f"batch of 2 at N=2^{LOG_N}: commit_many, evaluate ({ev_s[0]:.3f} s, "
        f"first call), verify ({vf_s[0]:.3f} s, first call): accepted, "
        f"swapped commitments rejected; peak device memory commit_many "
        f"{peak_commit:.3f} GiB, evaluate {peak_ev:.3f} GiB, verify "
        f"{peak_vf:.3f} GiB; launches {launches}")
    rec = dict(peak_commit_gib=peak_commit, peak_evaluate_gib=peak_ev,
               peak_verify_gib=peak_vf, first_evaluate_s=ev_s[0],
               first_verify_s=vf_s[0], launches=launches)
    # what the parallel phase holds its sharded round trip to
    held = dict(ck=prv.ck, vs=vs, x=x, ys=ys, coms=[c.to_bytes() for c in coms],
                proof=pf.to_bytes(params))
    return rec, held


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
    if ys_c != ys_h or ys_c != [bench.horner_ints(spec, v, x) for v in vs[:batch]]:
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


# ----------------------------------------------------------- Buckler phases

# (label, circuit of ringo_tpu_torch/circuits.py, field, log2 rank): the
# timed full-size point, the two first-call points, and the bfv example's
# point (timed; compiled through ringo_tpu_torch/examples/bfv.py)
BUCKLER_POINTS = [("PublicKey (13, ZP220)", "public_key", "ZP220", 13),
                  ("mult (13, ZP128)", "mult", "ZP128", 13),
                  ("PublicKey (15, ZP880)", "public_key", "ZP880", 15),
                  ("bfv (13, ZP240)", "bfv", "ZP240", 13)]
TIMED_POINTS = ("public_key", "bfv")
EXAMPLE_SEED = 20261017


def commit_ntt_shapes(p, t: int):
    """(label, ring attribute, direction, rows) of the six NTT launches of
    one ``commit_many`` chunk of t commitments (jindo/stages.py
    ``encode_mac``, ``outer_mac``, ``finalize``)."""
    B, R = p.cols + 1, p.rows
    K, J = p.mlwe_rank + p.in_msis_rank, p.in_msis_rank
    return [(f"commit t={t} encode ntt", "ring_q", "fwd", t * B * R),
            (f"commit t={t} mlwe ntt", "ring_q", "fwd", t * B * K),
            (f"commit t={t} inner intt", "ring_q", "inv", J * t * B),
            (f"commit t={t} outer ntt", "ring_q_out", "fwd",
             t * p.in_com_dcmp_len),
            (f"commit t={t} outer intt", "ring_q_out", "inv",
             p.out_msis_rank * t),
            (f"commit t={t} final ntt", "ring_q_out", "fwd",
             p.out_msis_rank * t)]


def buckler_ntt_shapes(params, ts):
    """Every NTT launch of a Buckler prove and verify on these Jindo
    parameters: the commit chunks of each batch size, then evaluate and
    verify at t = params.batch."""
    shapes = []
    for t in sorted(set(ts)):
        shapes += commit_ntt_shapes(params, t)
    return shapes + roundtrip_ntt_shapes(params)


def buckler_kernel_checks(tag: str, params, ts, checked: set, errs: dict,
                          gen, rng, time_them: bool = False,
                          time_macs: bool = False):
    """The kernels against their plain versions at the shapes and tables
    of a Buckler path on ``params``: the NTT and the MAC at every launch
    shape (each noted in ``checked``), ChaCha20 for the largest commit
    batch's keys at the u_enc and u_ml block counts, the twin search with
    both sigmas' tables and the boundary draws.  Returns the NTT rows,
    timed where ``time_them``, and the MAC rows, timed where
    ``time_macs``."""
    import torch

    from ringo_tpu_torch import bench_mac
    from ringo_tpu_torch.ops import ntt_matmul

    p = params
    rings = {"ring_q": p.ring_q.on("cuda"), "ring_q_out": p.ring_q_out.on("cuda")}
    timed_rows = []
    for label, which, way, n in buckler_ntt_shapes(p, ts):
        rg = rings[which]
        mm = rg._matmul_ntt()
        tab = getattr(mm, way)
        v = random_residues(rg, n, gen)
        hold_ntt(rg, tab, v, checked, errs, f"ntt {tag} {label}")
        if time_them:
            ms = bench.time_ms(lambda: ntt_matmul.ntt_mform_cuda(v, tab, mm.q32))
            b, by = ntt_bound(rg.L, n, rg.d)
            timed_rows.append(dict(label=label, ring=which, way=way, L=rg.L,
                                   rows=n, ms=ms, bound_ms=b, bound_by=by))
    mac_rows = []
    for label, which, J, K, n, layout in bench_mac.mac_shapes(p, sorted(set(ts))):
        mac_rows.append(hold_mac(rings[which], f"{tag} {label}", J, K, n,
                                 layout, checked, errs, gen, time_it=time_macs))
    t = max(ts)
    B, R, d = p.cols + 1, p.rows, p.degree
    K = p.mlwe_rank + p.in_msis_rank
    keys = torch.randint(-(1 << 31), 1 << 31, (t, 8), generator=gen,
                         dtype=torch.int64).to(torch.int32).to("cuda")
    for nb in (-(-B * R * d // 8), -(-p.cols * K * d // 8)):
        hold_chacha(keys, nb, errs, f"chacha20 {tag} {t} keys x {nb} blocks")
    tables = []
    for sigma, n, zero in ((p.ecd_std_dev, t * B * R * d, False),
                           (p.mlwe_std_dev, t * p.cols * K * d, True)):
        tw, c0, c1, u = twin_inputs(sigma, n, zero, gen, rng)
        hold_twin(tw, c0, c1, u, errs, f"twin {tag} sigma={sigma:.4f}")
        tables.append(tw.tables.shape[1])
    del rings
    torch.cuda.empty_cache()
    log(f"{tag}: L={p.ring_q.L} LO={p.ring_q_out.L} rows={p.rows} "
        f"cols={p.cols} batch={p.batch}, commit batches {ts}: NTT at "
        f"{len(buckler_ntt_shapes(p, ts))} shapes, MAC at {len(mac_rows)}, "
        f"ChaCha20 ({t} keys), twin search (T = {tables[0]} and {tables[1]}) "
        "equal to the plain versions")
    return timed_rows, mac_rows


def buckler_compile(name: str, field: str, log_n: int, device: str,
                    crs: bytes | None = None):
    """Inputs and compiled circuit of one case on ``device``, timed:
    circuits.build (the inputs and the NTT checker's plan) and
    compile_circuit (its plans and Jindo key in prv.timings)."""
    import torch

    from ringo_tpu_torch import buckler, circuits, fields
    from ringo_tpu_torch.rings.bigring import CyclotomicRing

    spec, n = getattr(fields, field), 1 << log_n
    t0 = time.perf_counter()
    ring = CyclotomicRing(spec, n, device=device)
    c, a, pub = circuits.build(name, buckler, ring,
                               checker_kw={"device": device})
    t1 = time.perf_counter()
    prv, vrf = buckler.compile_circuit(
        spec, n, c, circuits.CRS if crs is None else crs,
        seed=circuits.seed_of(name), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(prv=prv, vrf=vrf, assignment=a, public=pub, spec=spec,
                inputs_s=t1 - t0, compile_s=t2 - t1, **prv.timings)


def wrong_crs_verifier(b, device: str):
    """The same compiled circuit with a Jindo verifier of another CRS."""
    from ringo_tpu_torch import buckler, jindo

    v = b["vrf"]
    return buckler.Verifier(v.params, v.poly_ring, v.ecd, v.ctx,
                            jindo.Verifier(v.params, b"wrong", device=device),
                            v.pw_paths, v.w_paths)


def buckler_phase(backend, point, checked: set, errs: dict, gen, rng,
                  timed_reps: int):
    """compile_circuit -> prove -> verify for one point on the card; the
    first prove and verify fail on an NTT launch at a shape the kernel
    checks did not hold.  With ``timed_reps`` > 0: that many warm calls of
    each, launches counted from 0 over them; else the launches of the first
    calls.  Then a tampered evaluation and a verifier of another CRS must
    be rejected."""
    import torch

    from ringo_tpu_torch import buckler
    from ringo_tpu_torch.fields import bigfield

    label, name, field, log_n = point
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if name == "bfv":
        from ringo_tpu_torch.examples import bfv

        b = bfv.setup(log_n, seed=EXAMPLE_SEED, device="cuda")
        log(f"{label}: BGV keygen and encrypt {b['encrypt_s']:.3f} s, "
            f"decrypt {b['decrypt_s']:.3f} s (the message came back), "
            f"switch to p and the witness NTTs {b['inputs_s']:.3f} s")
    else:
        b = buckler_compile(name, field, log_n, "cuda")
    prv, vrf, a, pub = b["prv"], b["vrf"], b["assignment"], b["public"]
    p = prv.params
    compile_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{label}: inputs and checker plan {b['inputs_s']:.3f} s, "
        f"compile_circuit {b['compile_s']:.3f} s (NTT plans "
        f"{b['plans_s']:.3f} s, Jindo key {b['jindo_key_s']:.3f} s); Jindo "
        f"rank {p.rank}, embedding rank {prv.poly_ring.rank}, w={b['spec'].w}, "
        f"engine {type(prv.poly_ring.dev_plan).__name__}")
    ts = bench.commit_batches(prv.ctx)
    ntt_rows, mac_rows = buckler_kernel_checks(
        label, p, ts, checked, errs, gen, rng, time_them=timed_reps > 0,
        time_macs=point == BUCKLER_POINTS[0])
    held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    with shapes_held(checked, f"{label} first prove"):
        t0 = time.perf_counter()
        pf = prv.prove(a)
        torch.cuda.synchronize()
        first_prove_s = time.perf_counter() - t0
    first_prove_launches = dict(backend.LAUNCHES)
    first_prove_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the blinds, masks and commitments' rows and keys were drawn on the card
    for name, smp in (("Buckler uniform", prv.uniform),
                      ("Jindo uniform", prv.jindo.uniform)):
        if smp._w1 != 0:
            raise AssertionError(f"{label}: the {name} sampler copied "
                                 "keystream to the host")
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    with shapes_held(checked, f"{label} first verify"):
        t0 = time.perf_counter()
        ok = vrf.verify(pub, pf)
        torch.cuda.synchronize()
        first_verify_s = time.perf_counter() - t0
    first_verify_launches = dict(backend.LAUNCHES)
    first_verify_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if ok is not True:
        raise AssertionError(f"{label}: verify rejected an honest proof")
    b["first_proof"] = pf.to_bytes(p)     # a fresh prover's, from the seed
    rec = dict(label=label, circuit=name, field=field, log_n=log_n,
               jindo_rank=p.rank, jindo_rows=p.rows, jindo_cols=p.cols,
               jindo_L=p.ring_q.L, jindo_LO=p.ring_q_out.L,
               jindo_primes=list(p.ring_q.primes),
               jindo_out_primes=list(p.ring_q_out.primes),
               jindo_batch=p.batch, commit_batches=ts,
               embedding_rank=prv.poly_ring.rank, w=b["spec"].w,
               inputs_s=b["inputs_s"], compile_s=b["compile_s"],
               plans_s=b["plans_s"], jindo_key_s=b["jindo_key_s"],
               compile_peak_gib=compile_peak, held_gib=held,
               first_prove_s=first_prove_s, first_verify_s=first_verify_s,
               first_prove_peak_gib=first_prove_peak,
               first_verify_peak_gib=first_verify_peak,
               first_prove_launches=first_prove_launches,
               first_verify_launches=first_verify_launches,
               ntt_at_buckler_shapes=ntt_rows,
               mac_at_buckler_shapes=[r for r in mac_rows if "ms" in r])
    if timed_reps:
        backend.reset_launches()
        calls0 = dict(bigfield.CALLS)
        pf, pt, ppeak = timed(lambda: prv.prove(a), reps=timed_reps)
        rec["prove_launches_total"] = dict(backend.LAUNCHES)
        prove_calls = {k: n - calls0[k] for k, n in bigfield.CALLS.items()}
        prove_launches = {k: n / timed_reps for k, n in backend.LAUNCHES.items()}
        backend.reset_launches()
        calls0 = dict(bigfield.CALLS)
        ok, vt, vpeak = timed(lambda: vrf.verify(pub, pf), reps=timed_reps)
        verify_calls = {k: n - calls0[k] for k, n in bigfield.CALLS.items()}
        rec["verify_launches_total"] = dict(backend.LAUNCHES)
        rec.update(prove_bigfield_calls=prove_calls,
                   verify_bigfield_calls=verify_calls)
        verify_launches = {k: n / timed_reps for k, n in backend.LAUNCHES.items()}
        if ok is not True:
            raise AssertionError(f"{label}: verify rejected an honest proof")
        rec.update(prove_s=pt, prove_median_s=statistics.median(pt),
                   verify_s=vt, verify_median_s=statistics.median(vt),
                   prove_peak_gib=ppeak, verify_peak_gib=vpeak,
                   prove_launches=prove_launches,
                   verify_launches=verify_launches)
        log(f"{label}: big-field calls per prove {prove_launches['bigfield']:g} "
            f"({bigfield_calls(prove_calls, timed_reps)}), per verify "
            f"{verify_launches['bigfield']:g} "
            f"({bigfield_calls(verify_calls, timed_reps)})")
        log(f"{label}: prove {pt} s, median {rec['prove_median_s']:.4f} s, "
            f"peak {ppeak:.3f} GiB; verify {vt} s, median "
            f"{rec['verify_median_s']:.4f} s, peak {vpeak:.3f} GiB (held "
            f"before: {held:.3f} GiB); launches per prove {prove_launches}, "
            f"per verify {verify_launches}")
    else:
        prove_launches, verify_launches = first_prove_launches, first_verify_launches
    for k in backend.KERNELS:
        if prove_launches[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} not launched in prove")
    for k in ("ntt", "bigfield", "mac"):
        if verify_launches[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} not launched in verify")
    log(f"{label}: first prove {first_prove_s:.3f} s (peak "
        f"{first_prove_peak:.3f} GiB, launches {first_prove_launches}), first "
        f"verify {first_verify_s:.3f} s (peak {first_verify_peak:.3f} GiB, "
        f"launches {first_verify_launches}): accepted")

    bad = buckler.Proof.from_bytes(p, pf.to_bytes(p))
    bad.evals[0] = (bad.evals[0] + 1) % b["spec"].p
    if vrf.verify(pub, bad) is not False:
        raise AssertionError(f"{label}: a tampered evaluation was accepted")
    # the Jindo challenges are 0 where challenge_bound is 1 (k = 64: ZP880),
    # in the JAX package and its reference as here: a batched Jindo proof is
    # then all zeros and a verifier of any CRS accepts it (ROADMAP §3)
    t0 = time.perf_counter()
    wrong_ok = wrong_crs_verifier(b, "cuda").verify(pub, pf)
    if wrong_ok is not (p.challenge_bound == 1):
        raise AssertionError(f"{label}: a verifier of another CRS said "
                             f"{wrong_ok} at challenge_bound "
                             f"{p.challenge_bound}")
    rec["wrong_crs_accepted"] = wrong_ok
    log(f"{label}: tampered evaluation rejected; wrong-CRS verifier "
        f"{'ACCEPTED: every Jindo challenge is 0 at challenge_bound 1' if wrong_ok else 'rejected'} "
        f"(its key {time.perf_counter() - t0:.3f} s)")
    return rec, b


def bgv_phase(log_n: int = 13, reps: int = 3):
    """BGV at the bfv example's parameters on the card: key, the first
    encryption (c0, c1, e) and its decryption from a fixed seed equal the
    CPU path's; the decryption is the message; then ``reps`` further
    encryptions and decryptions timed on the host clock, each ending in a
    synchronise, every decryption held to the message."""
    import torch

    from ringo_tpu_torch import circuits
    from ringo_tpu_torch.schemes import BGV, BGVParams

    n, t = 1 << log_n, circuits.BFV_T
    m = np.random.default_rng(13).integers(0, t, n)
    out = {}
    for devname in ("cuda", "cpu"):
        bgv = BGV(BGVParams(log_n, circuits.BFV_Q_BITS, t, device=devname),
                  seed=b"chip-smoke bgv")
        sk = bgv.gen_secret_key()
        out[devname] = (bgv, sk, bgv.encrypt(sk, m))
    (bgv, sk, ct), (bgv_h, sk_h, ct_h) = out["cuda"], out["cpu"]
    if not torch.equal(sk.coeffs.cpu(), sk_h.coeffs):
        raise AssertionError("BGV: the card's key differs from the CPU's")
    for x, y, what in zip(ct, ct_h, ("c0", "c1", "e")):
        if x.device.type != "cuda" or not torch.equal(x.cpu(), y):
            raise AssertionError(f"BGV: the card's {what} differs from the CPU's")
    for b, k, (c0, c1, _) in ((bgv, sk, ct), (bgv_h, sk_h, ct_h)):
        if not np.array_equal(b.decrypt(k, c0, c1).numpy(), m):
            raise AssertionError("BGV: decryption did not return the message")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    enc_s, dec_s = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        c0, c1, _ = bgv.encrypt(sk, m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = bgv.decrypt(sk, c0, c1)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t1)
        enc_s.append(t1 - t0)
        if not np.array_equal(got.numpy(), m):
            raise AssertionError("BGV: decryption did not return the message")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = dict(log_n=log_n, primes=list(bgv.params.primes),
               encrypt_s=enc_s, encrypt_median_s=statistics.median(enc_s),
               decrypt_s=dec_s, decrypt_median_s=statistics.median(dec_s),
               peak_gib=peak)
    log(f"BGV (log_n {log_n}, {len(bgv.params.primes)} primes "
        f"{bgv.params.primes[0]}..{bgv.params.primes[-1]}): key, c0, c1, e "
        f"on the card equal the CPU path; decryptions return m; encrypt "
        f"{enc_s} s, median {rec['encrypt_median_s']:.4f} s; decrypt "
        f"{dec_s} s, median {rec['decrypt_median_s']:.4f} s; peak "
        f"{peak:.3f} GiB")
    return rec


def mult_example_phase(backend, checked: set):
    """The mult example's ``main`` at (13, ZP128) on the card, one call;
    every NTT launch at a shape the mult point's checks held."""
    from ringo_tpu_torch.examples import mult

    backend.reset_launches()
    with shapes_held(checked, "mult example"):
        r = mult.main(13, seed=EXAMPLE_SEED, device="cuda")
    launches = dict(backend.LAUNCHES)
    if r["ok"] is not True:
        raise AssertionError("mult example: the proof did not verify")
    for k in backend.KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"mult example: kernel {k} not launched")
    log(f"mult example (13, ZP128): compile {r['compile_s']:.3f} s, prove "
        f"{r['prove_s']:.3f} s, verify {r['verify_s']:.3f} s, verified; "
        f"launches {launches}")
    return dict(compile_s=r["compile_s"], prove_s=r["prove_s"],
                verify_s=r["verify_s"], size_mb=r["size_mb"],
                launches=launches)


def bigfield_card_vs_cpu(b):
    """At the timed point: one randomised witness encode and one
    embedding-ring NTT -> INTT round trip on the card equal the CPU path."""
    import torch

    from ringo_tpu_torch.buckler.encoder import Encoder
    from ringo_tpu_torch.jindo.prover import sample_field_digits
    from ringo_tpu_torch.csprng import UniformSampler
    from ringo_tpu_torch.rings.bigring import CyclicRing, FPoly

    prv, spec = b["prv"], b["spec"]
    rank, emb = prv.ctx.rank, prv.poly_ring.rank
    t0 = time.perf_counter()
    ecd_h = Encoder(spec, rank, emb, device="cpu")
    ring_h = CyclicRing(spec, emb, device="cpu")
    plans_s = time.perf_counter() - t0
    v = b["assignment"].sk_ntt
    blind = sample_field_digits(spec, 1, UniformSampler(b"blind", device="cuda"))[:, 0]
    e_c = FPoly(prv.ecd.rand_encode_planes(v, blind))
    f_c = prv.poly_ring.ntt(e_c)
    back = prv.poly_ring.intt(f_c)
    t0 = time.perf_counter()
    e_h = FPoly(ecd_h.rand_encode_planes(v.cpu(), blind.cpu()))
    f_h = ring_h.ntt(e_h)
    cpu_s = time.perf_counter() - t0
    for x, y, what in ((e_c.coeffs, e_h.coeffs, "encode"),
                       (f_c.coeffs, f_h.coeffs, "embedding ntt"),
                       (back.coeffs, e_c.coeffs, "ntt -> intt")):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"big-field {what}: card != CPU plain path")
    log(f"big-field layer: witness encode and embedding ntt -> intt of rank "
        f"{emb} on the card equal the CPU plain path (CPU plans {plans_s:.3f} "
        f"s, CPU encode + ntt {cpu_s:.3f} s)")


def buckler_card_vs_cpu_and_fixture(checked: set, errs: dict, gen, rng):
    """The five test circuits at their test sizes: proof bytes on the card
    equal the port's on the CPU and the JAX-package fixture (digest,
    length, evaluations); each device's verifier accepts the other's
    proof."""
    import hashlib

    import torch

    from ringo_tpu_torch import buckler, circuits

    fx = np.load(os.path.join(ROOT, "ringo_tpu_torch", "testdata",
                              "buckler_n8.npz"))
    for name, (field, log_n) in circuits.CASES.items():
        out = {}
        for devname in ("cuda", "cpu"):
            b = buckler_compile(name, field, log_n, devname)
            if devname == "cuda":
                buckler_kernel_checks(f"{name} (N=2^{log_n})", b["prv"].params,
                                      bench.commit_batches(b["prv"].ctx), checked,
                                      errs, gen, rng)
                with shapes_held(checked, f"{name} card prove"):
                    pf = b["prv"].prove(b["assignment"])
                torch.cuda.synchronize()
            else:
                pf = b["prv"].prove(b["assignment"])
            out[devname] = (b, pf, pf.to_bytes(b["prv"].params))
        (bc, pfc, data), (bh, pfh, data_h) = out["cuda"], out["cpu"]
        if data != data_h:
            raise AssertionError(f"{name}: proof bytes differ, card vs CPU")
        spec = bc["spec"]
        evals = b"".join(spec.marshal(e) for e in pfc.evals)
        if hashlib.sha256(data).digest() != bytes(fx[f"sha256_{name}"]) or \
                len(data) != int(fx[f"length_{name}"]) or \
                evals != bytes(fx[f"evals_{name}"]):
            raise AssertionError(f"{name}: the card's proof differs from the "
                                 "JAX-package fixture")
        for vb, pb in ((bc, data_h), (bh, data)):
            back = buckler.Proof.from_bytes(vb["prv"].params, pb)
            if vb["vrf"].verify(vb["public"], back) is not True:
                raise AssertionError(f"{name}: cross verification failed")
        log(f"{name} (N=2^{log_n}, {field}): card = CPU = JAX fixture "
            f"({len(data)} proof bytes); each verifier accepts the other's")


# ------------------------------------------------------------ parallel phase

def warm_s(fn):
    """(result, host-clock seconds of one call ending in a synchronise)."""
    out, (s,), _ = timed(fn, reps=1)
    return out, s


def parallel_start():
    """An NCCL process group of world size 1 (a FileStore under
    chiprun_out/) and a dp x tp x sp mesh of one card."""
    from ringo_tpu_torch import parallel

    os.makedirs(OUT_DIR, exist_ok=True)
    store = os.path.join(OUT_DIR, "nccl_store")
    if os.path.exists(store):
        os.remove(store)
    parallel.init_multihost(f"file://{store}", 1, 0, device="cuda")
    mesh = parallel.make_mesh(1, device="cuda")
    log(f"NCCL world of 1, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return mesh


def parallel_phase(backend, jindo, params, checked, held, mesh):
    """The multi-device layer over NCCL at world size 1, on the batch
    phase's parameters and key (ZP255, N = 2^19, batch 2): the sharded
    commit core on t = 2 host-made inputs equal to ``commit_core`` per
    item; a mesh-attached prover and verifier (the batch phase's seed)
    whose commitments and proof bytes equal the batch phase's, accepted,
    a swapped pair rejected; the four-step big-field NTT at rank 2^15 on
    ZP220 equal to the unsharded ring's ``ntt`` and inverted by ``inv``.
    One warm call each, timed; the launches of the sharded runs."""
    import torch

    from ringo_tpu_torch import parallel
    from ringo_tpu_torch.entry import example_inputs
    from ringo_tpu_torch.fields import ZP220
    from ringo_tpu_torch.rings.bigring import CyclicRing

    rec, launches = {}, {k: 0 for k in backend.KERNELS}

    def count(fn):
        backend.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k, n in backend.LAUNCHES.items():
            launches[k] += n
        return out

    prv = jindo.Prover(params, CRS, seed=SEED, device="cuda", ck=held["ck"])
    e, noise = (torch.from_numpy(a).to("cuda")
                for a in example_inputs(params, lead=(2,)))
    step = parallel.build_sharded_commit(prv, mesh)
    with shapes_held(checked, "sharded commit core"):
        # the first collective of each axis's group starts its NCCL
        # communicator: that call is timed apart
        _, rec["sharded_commit_first_s"] = warm_s(
            lambda: step(e, noise, *prv.ck_device()))
        got, rec["sharded_commit_s"] = count(lambda: warm_s(
            lambda: step(e, noise, *prv.ck_device())))
        raw = prv.raw_stages()["commit_core"]
        for i in range(2):
            for g, w in zip(got, raw(e[i], noise[i], *prv.ck_device())):
                if not torch.equal(g[i], w):
                    raise AssertionError("sharded commit core != commit_core")
    del got, e, noise
    log(f"sharded commit core, t=2 at N=2^{LOG_N}: equal to commit_core per "
        f"item; first call {rec['sharded_commit_first_s']:.3f} s (NCCL "
        f"communicators start), one warm call {rec['sharded_commit_s']:.3f} s")

    parallel.shard_jindo_prover(prv, mesh)
    vs, x = held["vs"], held["x"]
    with shapes_held(checked, "sharded round trip"):
        out, rec["sharded_commit_many_s"] = count(
            lambda: warm_s(lambda: prv.commit_many(vs)))
        coms, opens = [c for c, _ in out], [o for _, o in out]
        if [c.to_bytes() for c in coms] != held["coms"]:
            raise AssertionError("sharded commit_many != the batch phase's")
        (ys, pf), rec["sharded_evaluate_s"] = count(
            lambda: warm_s(lambda: prv.evaluate(x, vs, coms, opens)))
        if ys != held["ys"] or pf.to_bytes(params) != held["proof"]:
            raise AssertionError("sharded evaluate != the batch phase's proof")
        vrf = parallel.shard_jindo_verifier(
            jindo.Verifier(params, CRS, device="cuda", ck=held["ck"]), mesh)
        ok, rec["sharded_verify_s"] = count(
            lambda: warm_s(lambda: vrf.verify(x, coms, ys, pf)))
    if ok is not True:
        raise AssertionError("the sharded verifier rejected an honest proof")
    if vrf.verify(x, coms[::-1], ys, pf) is not False:
        raise AssertionError("the sharded verifier accepted a swapped pair")
    log(f"sharded Jindo round trip, batch of 2 at N=2^{LOG_N}: commitments "
        f"and proof bytes equal the batch phase's; accepted, swapped pair "
        f"rejected; commit_many {rec['sharded_commit_many_s']:.3f} s, "
        f"evaluate {rec['sharded_evaluate_s']:.3f} s, verify "
        f"{rec['sharded_verify_s']:.3f} s (one warm call each)")
    del prv, vrf, out, coms, opens, pf
    torch.cuda.empty_cache()

    n = 1 << 15
    t0 = time.perf_counter()
    ring = CyclicRing(ZP220, n, device="cuda")
    sh = parallel.ShardedBigNTT(ZP220, n, mesh, device="cuda")
    rec["four_step_plans_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.integers(0, 1 << 16, (ZP220.w, n))).to("cuda")
    x[-1] %= int(ZP220.p_digits[-1])
    f, rec["four_step_fwd_s"] = warm_s(lambda: sh.fwd(x))
    back, rec["four_step_inv_s"] = warm_s(lambda: sh.inv(f))
    want, rec["unsharded_ntt_s"] = warm_s(lambda: ring.dev_plan.fwd(x))
    # the unsharded engine returns its own order of the same DFT values
    if not torch.equal(f[:, ring.dev_plan.perm_f], want):
        raise AssertionError("four-step fwd != BigRing.ntt (engine order)")
    if not torch.equal(back, x):
        raise AssertionError("four-step inv(fwd(x)) != x")
    log(f"four-step NTT at rank 2^15 on ZP220 (n1 = {sh.n1}, n2 = {sh.n2}, "
        f"{type(sh._pipes['fwd'][0]).__name__} sub-transforms): fwd equals "
        f"BigRing.ntt in its engine order, inv(fwd(x)) = x; fwd "
        f"{rec['four_step_fwd_s']:.3f} s, inv {rec['four_step_inv_s']:.3f} s, "
        f"unsharded ntt {rec['unsharded_ntt_s']:.3f} s (one warm call each; "
        f"plans {rec['four_step_plans_s']:.3f} s)")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} not launched in the sharded runs")
    rec["launches"] = launches
    return rec


def parallel_buckler(backend, b, checked, mesh):
    """The PublicKey (13, ZP220) proof on a mesh-attached Buckler prover
    from the Buckler phase's seed (its key, a fresh prover of the same
    seed, the embedding NTT pair on the four-step): the proof bytes equal
    the phase's first proof, and a mesh-attached verifier accepts it."""
    import copy

    import torch

    from ringo_tpu_torch import buckler, circuits, jindo, parallel

    seed = circuits.seed_of("public_key")
    prv0, vrf0 = b["prv"], b["vrf"]
    ring = copy.copy(prv0.poly_ring)       # sharded below; the phase's stays
    prv = buckler.Prover(prv0.params, ring, prv0.ecd, prv0.ctx,
                         prv0.jindo.safe_copy(seed), prv0.pw_paths,
                         prv0.w_paths, seed=seed)
    parallel.shard_buckler_prover(prv, mesh)
    if not isinstance(ring.dev_plan, parallel.ShardedBigNTT):
        raise AssertionError("the embedding NTT was not sharded")
    jv = parallel.shard_jindo_verifier(
        jindo.Verifier(prv0.params, circuits.CRS, device="cuda",
                       ck=prv0.jindo.ck), mesh)
    vrf = buckler.Verifier(vrf0.params, ring, vrf0.ecd, vrf0.ctx, jv,
                           vrf0.pw_paths, vrf0.w_paths)
    backend.reset_launches()
    with shapes_held(checked, "sharded PublicKey prove and verify"):
        pf, prove_s = warm_s(lambda: prv.prove(b["assignment"]))
        ok, verify_s = warm_s(lambda: vrf.verify(b["public"], pf))
    launches = dict(backend.LAUNCHES)
    if pf.to_bytes(prv.params) != b["first_proof"]:
        raise AssertionError("sharded PublicKey proof != the Buckler phase's")
    if ok is not True:
        raise AssertionError("the sharded Buckler verifier rejected the proof")
    log(f"sharded PublicKey (13, ZP220): proof bytes equal the Buckler "
        f"phase's, accepted; prove {prove_s:.3f} s, verify {verify_s:.3f} s "
        f"(one call each; four-step n1 = {ring.dev_plan.n1}); launches "
        f"{launches}")
    return dict(prove_s=prove_s, verify_s=verify_s, launches=launches)


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    global bench
    try:
        from ringo_tpu_torch import backend, bench, jindo
        from ringo_tpu_torch.fields import ZP220, ZP255
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
    rows, checked, errs = kernel_phase(params, params_batch)
    phase = lambda what: log(f"-- {what} (at {time.perf_counter() - t_start:.1f} s)")
    phase("MAC phase")
    rows.append(mac_phase(params, params_batch, checked, errs))
    phase("AES phase")
    rows.append(aes_phase(params, errs))
    phase("AES fold phase")
    fold_phase(rows[-1], errs)
    params_pk = jindo.new_parameters(ZP220, 16512, 9)
    phase("Gaussian phase")
    rows.append(gauss_phase(params, params_pk, errs))
    phase("field-sample phase")
    rows.append(field_phase(jindo, params, params_pk, errs))
    phase("big-field phase")
    rows.append(bigfield_phase(errs))
    phase("commit phase")
    slice_rec, held = commit_phase(backend, jindo, params, checked)
    phase("round-trip phase")
    rt_rec = roundtrip_phase(backend, jindo, params, checked, *held)
    del held
    torch.cuda.empty_cache()
    phase("batch phase")
    batch_rec, batch_held = batch_phase(backend, jindo, params_batch, checked)
    torch.cuda.empty_cache()
    phase("parallel phase")
    mesh = parallel_start()
    par_rec = parallel_phase(backend, jindo, params_batch, checked,
                             batch_held, mesh)
    del batch_held
    torch.cuda.empty_cache()
    phase("card vs CPU, card vs fixtures")
    for batch in (1, 2):
        card_vs_cpu(jindo, ZP255, batch)
    card_vs_fixtures(jindo, ZP255)

    phase("BGV")
    bgv_rec = bgv_phase()
    gen = torch.Generator(device="cpu").manual_seed(20)
    rng = np.random.default_rng(20)
    buckler_recs = []
    for i, point in enumerate(BUCKLER_POINTS):
        phase(f"Buckler {point[0]}")
        t0 = time.perf_counter()
        rec, b = buckler_phase(backend, point, checked, errs, gen, rng,
                               timed_reps=3 if point[1] in TIMED_POINTS else 0)
        if i == 0:
            bigfield_card_vs_cpu(b)
            phase("parallel phase: sharded PublicKey (13, ZP220)")
            par_rec["buckler"] = parallel_buckler(backend, b, checked, mesh)
        del b
        torch.cuda.empty_cache()
        rec["phase_s"] = time.perf_counter() - t0
        buckler_recs.append(rec)
    phase("mult example")
    mult_rec = mult_example_phase(backend, checked)
    phase("Buckler card vs CPU vs fixture")
    buckler_card_vs_cpu_and_fixture(checked, errs, gen, rng)

    # launches of the main paths, each read after a run that began with the
    # counts at 0: the CRS expansion, the commits, the evaluates and the
    # verifies at N = 2^19,
    # and the timed Buckler proves and verifies (PublicKey and bfv at 2^13)
    timed_recs = [rec for rec in buckler_recs if "prove_launches_total" in rec]
    for r in rows:
        r["max_abs_err"] = errs[r["kernel"]]
        r["launches"] = sum(rec[r["kernel"]] for rec in (
            slice_rec["crs_launches"], slice_rec["launches"],
            rt_rec["evaluate_launches"],
            rt_rec["verify_launches"],
            *[rec["prove_launches_total"] for rec in timed_recs],
            *[rec["verify_launches_total"] for rec in timed_recs],
            par_rec["launches"], par_rec["buckler"]["launches"]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the C entry's device times beside the wrapper reading, where timed
    extra = ("device_ms", "cold_ms")
    table = {"kernels": [{k: r[k] for k in keys + extra if k in r}
                         for r in rows]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, kernels=rows, slice=slice_rec,
                       roundtrip=rt_rec, batch=batch_rec, parallel=par_rec,
                       buckler=buckler_recs,
                       bgv=bgv_rec, mult_example=mult_rec,
                       seconds=time.perf_counter() - t_start), f, indent=1)
    dist.destroy_process_group()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
