"""What tests/test_torch_buckler*.py share: the four circuits of
ringo_tpu_torch/circuits.py proved by the port on the CPU, by the JAX
package under its numpy backend (Montgomery host path: no JAX compile),
and by the JAX package under its jax backend (only to write the golden
fixture and in the slow test: its Buckler prover compiles for minutes).

The fixture ``ringo_tpu_torch/testdata/buckler_n8.npz`` holds, per
circuit, the SHA-256 digest and the length of the JAX package's proof
bytes and its evaluations (the proofs themselves are 1.9-4.3 MB each).
"""

import functools
import hashlib
import os

import numpy as np
import pytest
import torch

from ringo_tpu import backend
from ringo_tpu import buckler as ref_bk
from ringo_tpu import fields as ref_fields
from ringo_tpu.rings.bigring import CyclotomicRing as RefCyclotomicRing
from ringo_tpu_torch import buckler as bk, circuits, fields
from ringo_tpu_torch.fields import limb
from ringo_tpu_torch.rings.bigring import CyclotomicRing

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ringo_tpu_torch", "testdata", "buckler_n8.npz")
NAMES = tuple(circuits.CASES)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test module that imports this fixture:
    under several test workers, torch's default thread pool per process
    made the small int64 ops of these tests many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


@functools.lru_cache(maxsize=None)
def port_compiled(name: str, crs: bytes = circuits.CRS, strict: bool = False):
    """The port on the CPU: the compiled circuit and its assignments."""
    field, log_n = circuits.CASES[name]
    spec, n = getattr(fields, field), 1 << log_n
    ring = CyclotomicRing(spec, n, device="cpu")
    c, a, pub = circuits.build(name, bk, ring, checker_kw={"device": "cpu"})
    prv, vrf = bk.compile_circuit(spec, n, c, crs, seed=circuits.seed_of(name),
                                  strict=strict, device="cpu")
    return dict(prv=prv, vrf=vrf, assignment=a, public=pub, params=prv.params)


@functools.lru_cache(maxsize=None)
def port_case(name: str, strict: bool = False):
    """port_compiled with the proof and its bytes."""
    r = dict(port_compiled(name, strict=strict))
    r["pf"] = r["prv"].prove(r["assignment"])
    r["data"] = r["pf"].to_bytes(r["params"])
    return r


@functools.lru_cache(maxsize=None)
def ref_numpy_case(name: str, crs: bytes = circuits.CRS, strict: bool = False):
    """The JAX package under its numpy backend (Montgomery planes of the
    same integers): compiled circuit, prover, verifier and assignments."""
    assert not backend.is_jax()
    field, log_n = circuits.CASES[name]
    spec, n = getattr(ref_fields, field), 1 << log_n
    c, a, pub = circuits.build(name, ref_bk, RefCyclotomicRing(spec, n))
    prv, vrf = ref_bk.compile_circuit(spec, n, c, crs,
                                      seed=circuits.seed_of(name),
                                      strict=strict)
    return dict(prv=prv, vrf=vrf, assignment=a, public=pub,
                params=prv.params)


@functools.lru_cache(maxsize=None)
def ref_numpy_proof(name: str) -> bytes:
    r = ref_numpy_case(name)
    return r["prv"].prove(r["assignment"]).to_bytes(r["params"])


# XLA:CPU contracts float64 multiply-adds into FMA where the CPU has it:
# the Jindo drift centres (ringo_tpu/jindo/encoder.py drift_centers) then
# differ by one ulp in about a quarter of the lanes, and at the bfv case's
# 43 commitments a Gaussian sample flips.  The port, the JAX package's
# numpy backend and the Go reference on amd64 round every product and sum
# apart, and so does XLA:CPU without FMA instructions: the fixture is
# written with this flag in XLA_FLAGS.
NO_FMA = "--xla_cpu_max_isa=SSE4_2"


def jax_proof(name: str) -> tuple[bytes, list[int]]:
    """The JAX package's proof bytes and evaluations under its jax backend
    (on the CPU: minutes of compile per circuit), from the reference's
    np.uint32 plain planes.  Needs ``NO_FMA`` in XLA_FLAGS.  Buckler's
    stage programs (its batched encodes and the fused round 3) run op by
    op: they are exact integer arithmetic, so the bytes are the jitted
    programs' (the four earlier records were written jitted and are
    reproduced), and XLA:CPU took hours to execute the fused round 3 of
    the bfv case's 35 arithmetic constraints."""
    if NO_FMA not in os.environ.get("XLA_FLAGS", ""):
        raise RuntimeError(f"set XLA_FLAGS={NO_FMA} before JAX starts")
    from ringo_tpu.buckler import prover as ref_prover

    field, log_n = circuits.CASES[name]
    spec, n = getattr(ref_fields, field), 1 << log_n
    backend.use("jax")
    stage_jit = ref_prover.Prover._stage_jit
    ref_prover.Prover._stage_jit = lambda self, fn: fn
    try:
        ring = RefCyclotomicRing(spec, n, plain=True)
        c, a, _ = circuits.build(name, ref_bk, ring)
        prv, _ = ref_bk.compile_circuit(spec, n, c, circuits.CRS,
                                        seed=circuits.seed_of(name))
        pf = prv.prove(a)
        return pf.to_bytes(prv.params), [int(e) for e in pf.evals]
    finally:
        ref_prover.Prover._stage_jit = stage_jit
        backend.use("numpy")


def public_ints(public, to_ints) -> list[list[int]]:
    """The integers of an assignment's public witnesses, in walk order."""
    out = []
    for v in vars(public).values():
        if v is not None:
            out += [to_ints(x) for x in (v if isinstance(v, list) else [v])]
    return out


def fixture_record(name: str, data: bytes, evals: list[int]) -> dict:
    spec = getattr(fields, circuits.CASES[name][0])
    return {f"sha256_{name}": np.frombuffer(sha256(data), np.uint8),
            f"length_{name}": np.int64(len(data)),
            f"log_n_{name}": np.int64(circuits.CASES[name][1]),
            f"evals_{name}": np.frombuffer(
                b"".join(spec.marshal(e) for e in evals), np.uint8)}


def write_fixture(path: str = FIXTURE, names=NAMES) -> None:
    """Write the records of ``names`` into the golden fixture from the JAX
    package (jax backend); the fixture's other records stay as they are."""
    rec = dict(np.load(path)) if os.path.exists(path) else {}
    rec["crs"] = np.frombuffer(circuits.CRS, np.uint8)
    for name in names:
        rec.update(fixture_record(name, *jax_proof(name)))
    np.savez_compressed(path, **rec)


def check_against_fixture(fx, name: str, data: bytes,
                          evals: list[int]) -> None:
    want = fixture_record(name, data, evals)
    assert bytes(fx["crs"]) == circuits.CRS
    for k, v in want.items():
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


def check_proof_matches_the_fixture(name):
    port = port_case(name)
    check_against_fixture(np.load(FIXTURE), name, port["data"],
                          port["pf"].evals)
    assert port["vrf"].verify(port["public"], port["pf"]) is True


def check_reference_verifier_accepts_the_port_proof(name):
    port, ref = port_case(name), ref_numpy_case(name)
    # the same integers on both sides, each in its package's representation
    assert public_ints(port["public"], limb.digits_to_ints) == \
        public_ints(ref["public"], ref["prv"].poly_ring.ops.to_ints)
    pf = ref_bk.Proof.from_bytes(ref["params"], port["data"])
    assert ref["vrf"].verify(ref["public"], pf) is True
    pf.evals[0] = (pf.evals[0] + 1) % ref["params"].spec.p
    assert ref["vrf"].verify(ref["public"], pf) is False
    wrong = ref_numpy_case(name, crs=b"wrong")["vrf"]
    assert wrong.verify(ref["public"], ref_bk.Proof.from_bytes(
        ref["params"], port["data"])) is False


def check_port_verifier_accepts_the_reference_proof(name):
    port = port_case(name)
    data = ref_numpy_proof(name)
    assert data != port["data"]           # the samplers differ
    assert port["vrf"].verify(port["public"], bk.Proof.from_bytes(
        port["params"], data)) is True
    bad = bk.Proof.from_bytes(port["params"], data)
    bad.evals[-1] = (bad.evals[-1] + 1) % port["params"].spec.p
    assert port["vrf"].verify(port["public"], bad) is False
    wrong = port_compiled(name, crs=b"wrong")["vrf"]
    assert wrong.verify(port["public"], bk.Proof.from_bytes(
        port["params"], data)) is False
