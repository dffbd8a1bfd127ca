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
  and the kernel's wrapper refuses CPU tensors.
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
