"""The uniform field draw (ringo_tpu_torch/csprng/field_sample.py): its
plain version through ``draw_segments`` (the protocol the card runs: read
ahead, run, read the state, resume, commit) on CPU samplers, against the
JAX package's host loop ``ringo_tpu.jindo.prover.sample_field_digits`` and
``_take_bytes`` on its sampler of the same seed.  Exact: the digits, the
bytes, and the sampler's next 64 bytes afterwards.

* ZP110, ZP220, ZP255 and ZP880 (w = 7 ... 55) at n = 0, 1, 127, 1,023
  and 2,080;
* a segment list [1,023 lanes, 2,080 lanes, 64 bytes] against three host
  draws in a row, and one-lane segments against Buckler's ``_rand_field(1)``
  calls;
* read-aheads of 8 KiB, so the loop exits "read-ahead short" and resumes
  several times a call, with the same digits, bytes used and state;
* a Jindo ``commit_many`` draws its batch's rows and keys in one call;
* the kernel's state and argument slots are those of csrc/field_sample.cu,
  and the kernel's wrapper refuses CPU tensors;
* a model of the kernel's steps in Python (``_KernelModel``: reject flags
  from each segment's first byte, their prefix counts, the rounds'
  boundaries walked from them, lanes found by walking back, the warp path
  of small segments, the pending need list of a stopped segment) run
  through ``draw_segments`` in place of the plain version: segment lists
  with RAW segments at every alignment, empty and one-lane segments,
  ZP110/ZP220/ZP255/ZP880, read-aheads that stop mid-segment, the round
  cap, flag passes shorter than the rounds left, Buckler's blinds and a
  commit's segments; equal to the JAX host loop and to the plain version
  in digits, bytes, sampler, launches, exits, rounds, chunks and bytes
  used.
"""

import os
import re

import numpy as np
import pytest
import torch

import ringo_tpu.fields as ref_fields
from ringo_tpu.csprng import UniformSampler as RefUniform
from ringo_tpu.jindo.prover import sample_field_digits as ref_sample
import ringo_tpu_torch.fields as fields
import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch import backend
from ringo_tpu_torch.csprng import field_sample, uniform

FIELDS = ("ZP110", "ZP220", "ZP255", "ZP880")
SIZES = (0, 1, 127, 1023, 2080)
CU = os.path.join(os.path.dirname(backend.__file__), "csrc", "field_sample.cu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_read_ahead(monkeypatch):
    """Every read-ahead of 8 KiB (plus what a resume needs)."""
    monkeypatch.setattr(field_sample, "SLACK", 0.0)
    monkeypatch.setattr(field_sample, "WINDOW_SLACK", 8192)


def _pair(seed: bytes):
    return (uniform.UniformSampler(seed, device="cpu"), RefUniform(seed))


def _host_draws(name: str, ref, segments):
    """The JAX package's host draws of ``segments``, one after another."""
    out = []
    for kind, count in segments:
        if kind == "field":
            out.append(np.asarray(ref_sample(getattr(ref_fields, name), count,
                                             ref)))
        else:
            out.append(np.asarray(ref._take_bytes(count)))
    return out


def _same(got, want, mine, ref):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
    np.testing.assert_array_equal(mine._take_bytes(64), ref._take_bytes(64))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", FIELDS)
def test_field_digits_equal_the_jax_host_loop(name, n):
    spec = getattr(fields, name)
    mine, ref = _pair(f"field {name} {n}".encode())
    calls = field_sample.CALLS
    got = tj.sample_field_digits(spec, n, mine)
    assert got.shape == (spec.w, n) and got.dtype == torch.int64
    _same([got], _host_draws(name, ref, [("field", n)]), mine, ref)
    if n:
        last = field_sample.LAST
        assert (last["launches"], last["exits"]) == (1, 0)
        assert last["used"] <= last["read_ahead"]
        assert last["rounds"] >= 1
        assert field_sample.CALLS == calls + 1
    else:   # nothing drawn: no read-ahead, no call
        assert field_sample.CALLS == calls


SEGMENTS = [("field", 1023), ("field", 2080), ("bytes", 64)]


@pytest.mark.parametrize("name", ("ZP220", "ZP255"))
def test_segments_equal_sequential_host_draws(name):
    mine, ref = _pair(b"segments " + name.encode())
    got = field_sample.draw_segments(getattr(fields, name), mine, SEGMENTS)
    _same(got, _host_draws(name, ref, SEGMENTS), mine, ref)
    assert field_sample.LAST["launches"] == 1
    assert field_sample.LAST["segments"] == 3


def test_one_lane_segments_equal_rand_field_calls():
    """Buckler's blinds: one one-lane segment a witness, each drawn as the
    JAX package's ``_rand_field(1)`` draws it."""
    mine, ref = _pair(b"blinds")
    segs = [("field", 1)] * 37
    got = field_sample.draw_segments(fields.ZP220, mine, segs)
    _same(got, _host_draws("ZP220", ref, segs), mine, ref)
    assert field_sample.LAST["rounds"] >= 37


@pytest.mark.parametrize("name,segments", [
    ("ZP255", SEGMENTS),
    ("ZP880", [("bytes", 5), ("field", 127), ("bytes", 32), ("field", 300)]),
])
def test_short_read_ahead_resumes(name, segments, short_read_ahead):
    spec = getattr(fields, name)
    seed = b"short " + name.encode()
    full = field_sample.draw_segments(
        spec, uniform.UniformSampler(seed, device="cpu"), segments)
    used = field_sample.LAST["used"]
    mine, ref = _pair(seed)
    got = field_sample.draw_segments(spec, mine, segments)
    last = field_sample.LAST
    assert last["exits"] >= 2 and last["launches"] == last["exits"] + 1
    assert last["used"] == used
    for g, f in zip(got, full):
        assert torch.equal(g, f)
    _same(got, _host_draws(name, ref, segments), mine, ref)


def test_odd_start_and_empty_segments():
    """A read-ahead from an odd byte of the buffer, zero-lane and
    zero-byte segments between others."""
    mine, ref = _pair(b"odd")
    mine._take_bytes(3)
    ref._take_bytes(3)
    segs = [("field", 0), ("bytes", 0), ("field", 5), ("bytes", 7),
            ("field", 0)]
    got = field_sample.draw_segments(fields.ZP110, mine, segs)
    _same(got, _host_draws("ZP110", ref, segs), mine, ref)
    with pytest.raises(ValueError):
        field_sample.draw_segments(fields.ZP110, mine, [("keys", 32)])
    with pytest.raises(ValueError):
        field_sample.draw_segments(fields.ZP110, mine, [("field", -1)])


def test_commit_draws_its_batch_in_one_call():
    params = tj.new_parameters(fields.ZP255, 1 << 10, 1)
    prv = tj.Prover(params, b"Jindo!", seed=b"one call", device="cpu")
    rng = np.random.default_rng(3)
    vs = []
    for n in (1 << 10, 700):
        v = rng.integers(0, 1 << 16, (fields.ZP255.w, n))
        v[-1] %= int(fields.ZP255.p_digits[-1])
        vs.append(v)
    calls = field_sample.CALLS
    prv.commit_many(vs)
    assert field_sample.CALLS == calls + 1
    assert field_sample.LAST["segments"] == 8   # 2 rows + 2 keys a commit
    # the commitments' keys came from the uniform stream, nothing after them
    mine = uniform.UniformSampler(b"one callu", device="cpu")
    segs = []
    for v in vs:
        rows = len(prv._mask_rows(v.shape[1]))
        segs += [("field", params.cols * params.slots - 1),
                 ("field", rows * params.slots), ("bytes", 32), ("bytes", 32)]
    field_sample.draw_segments(params.spec, mine, segs)
    np.testing.assert_array_equal(mine._take_bytes(64),
                                  prv.uniform._take_bytes(64))


def _enum(src: str, first: str) -> list[str]:
    m = re.search(r"enum\s*\{\s*(" + first + r"\b[^}]*)\}", src)
    return [re.sub(r"\s*=.*", "", x).strip() for x in m.group(1).split(",")
            if x.strip()]


def test_kernel_slots_match_the_source():
    with open(CU) as f:
        src = f.read()
    fs = field_sample
    assert _enum(src, "FIELD") == ["FIELD", "RAW"] and (fs.FIELD, fs.RAW) == (0, 1)
    assert _enum(src, "DONE") == ["DONE", "WANT"] and (fs.DONE, fs.WANT) == (0, 1)
    assert [getattr(fs, s) for s in _enum(src, "S_STATUS")] == list(
        range(fs.S_LEN + 1))
    args = _enum(src, "A_OUT")
    assert [getattr(fs, a) for a in args[:-2]] == list(range(len(args) - 2))
    assert args[-2:] == ["A_ST", "A_LEN"]
    assert f"kMaxW = {fs.MAX_W};" in src and f"kThreads = {fs.THREADS};" in src
    assert f"kCluster = {fs.CLUSTER};" in src
    assert "ringo_field_sample" in backend._SIGNATURES
    assert "field" in backend.KERNELS


def test_cuda_wrapper_refuses_cpu_tensors():
    D = field_sample._Draw(fields.ZP220, uniform.UniformSampler(
        b"cpu", device="cpu"), [("field", 4)])
    D.open(D.budget())
    before = backend.LAUNCHES["field"]
    with pytest.raises(ValueError):
        field_sample.field_sample_cuda(D)
    assert backend.LAUNCHES["field"] == before


# ---------------------- the kernel's steps in Python (csrc/field_sample.cu)

class _KernelModel:
    """``ringo_field_sample`` step for step on one ``_Draw``, as the CUDA
    source runs it: per field segment the reject flags of the candidates
    from the segment's first byte (32-bit words compared from the top),
    their prefix counts R and the rejects' candidates ``rej``, flagged in
    passes up to the expected end of the rounds left; the rounds'
    boundaries walked from R; each accepted candidate's lane by walking
    back through ``rej``; a stopped segment's pending need list by the same
    walk into half pp ^ (rounds & 1); segments of at most 32 lanes by the
    warp path's rounds.  Advances ``D.st`` like the kernel; counts its flag
    passes and block-path segments.  ``max_rounds``, ``slack`` and
    ``extra`` are the kernel's kMaxRounds and its pass size B + m / accept
    x slack + extra."""

    def __init__(self, max_rounds=256, slack=1.0625, extra=64):
        self.max_rounds, self.slack, self.extra = max_rounds, slack, extra
        self.passes = self.block_segments = self.tiny_rounds = 0

    def __call__(self, D):
        fs = field_sample
        st = D.st
        ext, start, avail = D.win
        buf = ext.numpy()
        hi = start + avail
        w = D.spec.w
        nb, hw = 2 * w, (w + 1) // 2
        pd = [int(x) for x in D.spec.p_digits] + [0] * (2 * hw - w)
        pw = [pd[2 * k] | pd[2 * k + 1] << 16 for k in range(hw)]
        top_word = D.top_mask if w % 2 else D.top_mask << 16 | 0xFFFF
        accept = np.float32(pw[-1] + 1) / np.float32(top_word + 1)

        def word(pos):      # stage + slab_word: bytes past hi read as 0
            return sum(int(buf[pos + i]) << (8 * i) for i in range(4)
                       if pos + i < hi)

        def rejected(pos):
            for k in range(hw - 1, -1, -1):
                v = word(pos + 4 * k) & (top_word if k == hw - 1 else M32)
                if v != pw[k]:
                    return v > pw[k]
            return True

        def write(pos, col):
            for i in range(w):
                d = word(pos + 2 * i) & 0xFFFF
                D.out[i, col] = d & D.top_mask if i == w - 1 else d

        need = D.need
        seg, m, off = int(st[fs.S_SEG]), int(st[fs.S_M]), int(st[fs.S_OFF])
        fresh, pp = int(st[fs.S_FRESH]), int(st[fs.S_PP])
        rounds, chunks = int(st[fs.S_ROUNDS]), int(st[fs.S_CHUNKS])
        status, want = fs.DONE, 0
        while seg < len(D.tab):
            kind, cnt, base = (int(x) for x in D.tab[seg])
            src = start + off
            if kind == fs.RAW:
                if off + cnt > avail:
                    status, want = fs.WANT, cnt
                    break
                D.raw[base:base + cnt] = torch.from_numpy(buf[src:src + cnt].copy())
                off, seg = off + cnt, seg + 1
                continue
            if m < 0:
                m, fresh = cnt, 1
            if m == 0:
                seg, m = seg + 1, -1
                continue
            if m <= 32:           # the warp path: the host loop's rounds
                lanes = list(range(m)) if fresh else need[pp, :m].tolist()
                while m > 0:
                    if off + nb * m > avail:
                        status, want = fs.WANT, nb * m
                        if not fresh:
                            need[pp, :m] = torch.tensor(lanes, dtype=torch.int32)
                        break
                    rej = []
                    for j, ln in enumerate(lanes):
                        pos = start + off + nb * j
                        if rejected(pos):
                            rej.append(ln)
                        else:
                            write(pos, base + ln)
                    off += nb * m
                    lanes, m = rej, len(rej)
                    fresh, pp = 0, pp ^ 1
                    rounds, chunks = rounds + 1, chunks + 1
                    self.tiny_rounds += 1
                if status == fs.WANT:
                    break
                seg, m = seg + 1, -1
                continue
            # the block path
            self.block_segments += 1
            rd = (avail - off) // nb
            pre, rej = [], []        # R(c) per candidate; the rejects
            rB, rM, rR = [], [], []
            B, mm, F, pend = 0, m, 0, False

            def R(x):
                return len(rej) if x >= F else pre[x]

            while True:
                while mm > 0:
                    if len(rB) == self.max_rounds or B + mm > rd:
                        pend = True
                        break
                    if B + mm > F:
                        break
                    rB.append(B)
                    rM.append(mm)
                    rR.append(R(B))
                    B, mm = B + mm, R(B + mm) - rR[-1]
                if mm == 0 or pend:
                    break
                F1 = B + int(np.float32(mm) / accept * np.float32(self.slack)
                             ) + self.extra
                F1 = min((F1 + 31) & ~31, rd)
                assert F1 >= B + mm > F
                self.passes += 1
                for c in range(F, F1):
                    pre.append(len(rej))
                    if rejected(src + nb * c):
                        rej.append(c)
                F = F1
            nr = len(rB)
            lanes0 = None if fresh else need[pp].tolist()

            def lane_of(r, j):
                for r in range(r, 0, -1):
                    j = rej[rR[r - 1] + j] - rB[r - 1]
                return j if fresh else lanes0[j]

            rejects = set(rej)
            for c in range(B):
                if c in rejects:
                    continue
                r = max(k for k in range(nr) if rB[k] <= c)
                write(src + nb * c, base + lane_of(r, c - rB[r]))
            ppn = pp ^ (nr & 1)
            if pend and nr:
                pending = [lane_of(nr - 1, rej[rR[nr - 1] + j] - rB[nr - 1])
                           for j in range(mm)]
                need[ppn, :mm] = torch.tensor(pending, dtype=torch.int32)
            off += nb * B
            rounds += nr
            chunks += sum(-(-x // fs.THREADS) for x in rM)
            if nr:
                fresh, pp = 0, ppn
            if pend:
                m, status, want = mm, fs.WANT, nb * mm
                break
            seg, m = seg + 1, -1
        st[fs.S_STATUS], st[fs.S_SEG], st[fs.S_M] = status, seg, m
        st[fs.S_FRESH], st[fs.S_PP], st[fs.S_OFF] = fresh, pp, off
        st[fs.S_WANT], st[fs.S_ROUNDS], st[fs.S_CHUNKS] = want, rounds, chunks


M32 = 0xFFFFFFFF
# RAW segments that leave the next field segment at every alignment mod 4
# and mod 2w, empty and one-lane segments, a 33-lane one (the block path's
# smallest)
MODEL_SEGMENTS = [("bytes", 3), ("field", 0), ("field", 1), ("field", 700),
                  ("bytes", 64), ("field", 33), ("bytes", 5), ("field", 32),
                  ("bytes", 0), ("field", 2080), ("field", 1), ("bytes", 2)]


def _model_vs_plain(name, segments, seed, model):
    """The segments through the model and through field_sample_plain
    (``draw_segments``, the same protocol), against the JAX package's host
    draws: equal digits, bytes, samplers, launches, exits, rounds, chunks,
    bytes used."""
    spec = getattr(fields, name)
    plain = field_sample.draw_segments(
        spec, uniform.UniformSampler(seed, device="cpu"), segments)
    plain_last = dict(field_sample.LAST)
    mine, ref = _pair(seed)
    run = field_sample.field_sample
    field_sample.field_sample = model
    try:
        got = field_sample.draw_segments(spec, mine, segments)
    finally:
        field_sample.field_sample = run
    last = dict(field_sample.LAST)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    _same(got, _host_draws(name, ref, segments), mine, ref)
    return last, plain_last


@pytest.mark.parametrize("name", ("ZP110", "ZP220", "ZP255", "ZP880"))
def test_kernel_model_segments(name):
    model = _KernelModel()
    last, plain = _model_vs_plain(name, MODEL_SEGMENTS, b"model " + name.encode(),
                                  model)
    assert last == plain
    assert model.block_segments == 3 and model.tiny_rounds >= 4


@pytest.mark.parametrize("name", ("ZP220", "ZP880"))
def test_kernel_model_resumes_mid_segment(name, short_read_ahead):
    """8 KiB read-aheads: the block path stops before a round mid-segment
    (WANT), writes the pending need list, and resumes from it."""
    model = _KernelModel()
    segs = [("field", 5), ("bytes", 64), ("field", 2080), ("field", 3)]
    last, plain = _model_vs_plain(name, segs, b"model short " + name.encode(),
                                  model)
    assert last == plain
    assert last["exits"] >= 2


@pytest.mark.parametrize("case", ("round cap", "short passes"))
def test_kernel_model_round_cap_and_passes(case):
    """A launch that stops a segment after its round cap (WANT with the
    bytes readable) resumes from the pending list: the same draw, with more
    launches and the same rounds, chunks and bytes.  Flag passes shorter
    than the rounds left (a segment flagged in many passes) give the same
    draw."""
    model = (_KernelModel(max_rounds=2) if case == "round cap"
             else _KernelModel(slack=0.6, extra=0))
    segs = [("field", 1500), ("bytes", 32), ("field", 40)]
    last, plain = _model_vs_plain("ZP255", segs, b"model " + case.encode(), model)
    if case == "round cap":
        for key in ("rounds", "chunks", "used"):
            assert last[key] == plain[key]
        assert last["exits"] > plain["exits"] and plain["exits"] == 0
    else:
        assert last == plain
        assert model.passes >= 4 * model.block_segments


def test_kernel_model_blinds_and_commit():
    """Buckler's 40 one-lane blinds (the warp path alone) and a Jindo
    commit's segments (last row, mask column, two keys) at ZP255."""
    model = _KernelModel()
    last, plain = _model_vs_plain("ZP220", [("field", 1)] * 40, b"model blinds",
                                  model)
    assert last == plain and model.block_segments == 0
    assert model.tiny_rounds == last["rounds"]
    model = _KernelModel()
    params = tj.new_parameters(fields.ZP255, 1 << 10, 1)
    cs = params.cols * params.slots
    segs = [("field", cs - 1), ("field", 3 * params.slots), ("bytes", 32),
            ("bytes", 32)]
    last, plain = _model_vs_plain("ZP255", segs, b"model commit", model)
    assert last == plain and model.passes >= model.block_segments >= 1
