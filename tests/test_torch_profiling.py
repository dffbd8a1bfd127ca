"""The port's span registry (ringo_tpu_torch/utils/profiling.py): the
span names and counts of one commit at N = 2^10 and one Buckler prove at
N = 2^8 on the CPU, with ``reset()`` between them; ``RINGO_TRACE=1``
enables the registry at import; a disabled registry records nothing; and
the spans reach a ``torch.profiler`` trace either way."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch import buckler as bk, circuits, fields
from ringo_tpu_torch.rings.bigring import CyclotomicRing
from ringo_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMIT = ("meta", "host_side", "assemble", "sample", "encode_mac", "outer",
          "pull")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def registry():
    was = profiling.enabled()
    profiling.enable()
    profiling.reset()
    yield
    profiling.enable(was)
    profiling.reset()


@pytest.fixture(scope="module")
def commit_case():
    params = tj.new_parameters(fields.ZP255, 1 << 10, 1)
    prv = tj.Prover(params, b"Jindo!", seed=b"spans", device="cpu")
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 16, (fields.ZP255.w, 1 << 10))
    v[-1] %= int(fields.ZP255.p_digits[-1])
    return prv, torch.from_numpy(v)


def test_env_enables_the_registry():
    code = ("from ringo_tpu_torch.utils import profiling; "
            "print(profiling.enabled())")
    for val, want in (("1", "True"), ("", "False")):
        env = dict(os.environ, PYTHONPATH=ROOT, RINGO_TRACE=val)
        res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert res.stdout.strip() == want, res.stderr


def test_commit_spans(registry, commit_case):
    prv, v = commit_case
    prv.commit(v)
    rep = profiling.report()
    assert {k: n for k, (n, _) in rep.items()} == {
        f"jindo.commit.{s}": 1 for s in COMMIT}
    assert all(s > 0 for _, s in rep.values())
    profiling.reset()
    assert profiling.report() == {}


def test_disabled_registry_records_nothing_but_the_trace_has_the_spans(
        commit_case):
    prv, v = commit_case
    profiling.enable(False)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        prv.commit(v)
    assert profiling.report() == {}
    names = {e.key for e in prof.key_averages()}
    assert {f"jindo.commit.{s}" for s in COMMIT} <= names


def test_device_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "trace.json"
    with profiling.device_trace(str(path)):
        with profiling.span("jindo.test.span"):
            torch.ones(8).cumsum(0)
    assert "jindo.test.span" in path.read_text()


def test_buckler_prove_spans(registry):
    field, log_n = circuits.CASES["public_key"]
    spec, n = getattr(fields, field), 1 << log_n
    ring = CyclotomicRing(spec, n, device="cpu")
    c, a, _ = circuits.build("public_key", bk, ring,
                             checker_kw={"device": "cpu"})
    prv, _ = bk.compile_circuit(spec, n, c, circuits.CRS,
                                seed=circuits.seed_of("public_key"),
                                device="cpu")
    profiling.reset()
    prv.prove(a)
    counts = {k: n for k, (n, _) in profiling.report().items()}
    ctx = prv.ctx
    # one commit_many per round: first-round witnesses, the linear-check
    # mask, the round-3 quotient and remainders
    ts = [ctx.w_cnt, 1, 1 + 3]
    want = {"buckler.prove.decompose": 1, "buckler.prove.encode_public": 1,
            "buckler.prove.encode_witness": 1,
            "buckler.prove.commit_batch": 3, "buckler.prove.round3": 1,
            "buckler.prove.arith_check": 1, "buckler.prove.lin_check": 1,
            "buckler.prove.evaluate": 1}
    for s in COMMIT:
        want[f"jindo.commit.{s}"] = sum(ts) if s in (
            "meta", "host_side", "assemble") else len(ts)
    for s in ("combine", "partial", "oracle", "response", "horner"):
        want[f"jindo.evaluate.{s}"] = 1
    assert counts == want
