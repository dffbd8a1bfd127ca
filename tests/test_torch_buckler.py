"""The port's Buckler compile -> prove -> verify against the JAX package,
for the PublicKey circuit over ZP220 (matmul engine) at N = 2^8; the other
circuits of ringo_tpu_torch/circuits.py go through the same checks in
tests/test_torch_buckler_mult.py,
tests/test_torch_buckler_constraints.py and tests/test_torch_buckler_approx.py
(one file each, so that test workers run them side by side):

* the port's proof bytes equal the JAX package's (backend "jax") for the
  same inputs and seeds: SHA-256 digest, length and evaluations are held
  in the golden fixture ringo_tpu_torch/testdata/buckler_n8.npz;
* the JAX package's numpy-backend verifier accepts the port's proof, and
  the port's verifier accepts a proof of the JAX package's numpy-backend
  prover (whose bytes differ from the jax backend's only in sampling);
* both reject a tampered evaluation and a verifier of another CRS;
* ``strict=True`` on the mult circuit, whose five arithmetic constraints
  it scales apart.

No test here compiles the JAX package's Buckler prover or verifier but
the slow one, which re-derives the fixture.  Rewrite the fixture with

    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 JAX_PLATFORMS=cpu PYTHONPATH=. \
        python tests/test_torch_buckler.py --write-fixture [NAME ...]

(every circuit without a NAME; the records of the others stay).  The flag
keeps XLA:CPU from contracting float64 multiply-adds into FMA
(torch_buckler_cases.NO_FMA says why); the slow test needs it too.
"""

import os
import sys

import numpy as np
import pytest

from ringo_tpu import buckler as ref_bk
from ringo_tpu import jindo as ref_jindo
from ringo_tpu.fields import ZP255 as REF_ZP255
from ringo_tpu_torch import buckler as bk
from ringo_tpu_torch import jindo as tj
from ringo_tpu_torch.fields import ZP255

import torch_buckler_cases as cases
from torch_buckler_cases import one_torch_thread  # noqa: F401

NAMES = ("public_key",)


@pytest.mark.parametrize("name", NAMES)
def test_proof_bytes_match_the_jax_fixture(name):
    cases.check_proof_matches_the_fixture(name)


@pytest.mark.parametrize("name", NAMES)
def test_reference_verifier_accepts_the_port_proof(name):
    cases.check_reference_verifier_accepts_the_port_proof(name)


@pytest.mark.parametrize("name", NAMES)
def test_port_verifier_accepts_the_reference_proof(name):
    cases.check_port_verifier_accepts_the_reference_proof(name)


def test_strict_mode_proofs_cross_over():
    """strict=True scales the mult circuit's five arithmetic constraints
    by distinct powers: the JAX package's strict verifier accepts the
    port's strict proof, the port's strict verifier accepts it, and a
    verifier in the default mode rejects it."""
    name = "mult"
    port = cases.port_case(name, strict=True)
    assert port["prv"].ctx.strict and len(port["prv"].ctx.arith_constraints) == 5
    assert port["vrf"].verify(port["public"], port["pf"]) is True
    assert cases.port_compiled(name)["vrf"].verify(port["public"],
                                                   port["pf"]) is False
    ref = cases.ref_numpy_case(name, strict=True)
    assert ref["vrf"].verify(ref["public"], ref_bk.Proof.from_bytes(
        ref["params"], port["data"])) is True


def test_malformed_proof_bytes_raise():
    port = cases.port_case("public_key")
    with pytest.raises(ValueError):
        bk.Proof.from_bytes(port["params"], port["data"][:-8])
    with pytest.raises(ValueError):
        bk.Proof.from_bytes(port["params"], port["data"][:100])
    back = bk.Proof.from_bytes(port["params"], port["data"])
    assert back.to_bytes(port["params"]) == port["data"]


def _scalar_offsets(params, data: bytes) -> dict:
    """Byte offsets of lin_sum, sum_sum and evals[0] in a proof."""
    off = 4
    for _ in range(int.from_bytes(data[:4], "big")):
        off += 8 + int.from_bytes(data[off:off + 8], "big")
    nb = -(-params.spec.bits // 64) * 8
    return {"lin_sum": off, "sum_sum": off + nb, "evals0": off + 2 * nb + 4}


@pytest.mark.parametrize("which", ["lin_sum", "sum_sum", "evals0"])
def test_non_canonical_scalars_are_refused(which):
    """A field scalar of the proof spelled v + p (a second byte string of
    the same proof) makes the port's decoder raise ValueError.  The JAX
    package reduces it mod p, and its numpy-backend verifier accepts the
    proof: that verdict is held here beside the port's."""
    port, ref = cases.port_case("public_key"), cases.ref_numpy_case("public_key")
    params, data = port["params"], port["data"]
    off = _scalar_offsets(params, data)[which]
    nb = -(-params.spec.bits // 64) * 8
    v = int.from_bytes(data[off:off + nb], "big") + params.spec.p
    bad = data[:off] + v.to_bytes(nb, "big") + data[off + nb:]
    with pytest.raises(ValueError):
        bk.Proof.from_bytes(params, bad)
    assert ref["vrf"].verify(ref["public"], ref_bk.Proof.from_bytes(
        ref["params"], bad)) is True
    # the canonical bytes decode and verify as before
    back = bk.Proof.from_bytes(params, data)
    assert port["vrf"].verify(port["public"], back) is True


def _jindo_round_trip():
    """The Jindo round-trip fixture (ZP255, N = 2^10, the JAX package's
    bytes): parameters of both packages, point, evaluation, commitment and
    proof bytes."""
    fx = np.load(os.path.join(os.path.dirname(cases.FIXTURE),
                              "roundtrip_zp255_n10.npz"))
    n = 1 << int(fx["log_n"])
    return dict(crs=bytes(fx["crs"]),
                params=tj.new_parameters(ZP255, n, 1),
                ref_params=ref_jindo.new_parameters(REF_ZP255, n, 1),
                x=int.from_bytes(bytes(fx["x"]), "big"),
                y=int.from_bytes(bytes(fx["evaluation"]), "big"),
                com=bytes(fx["commit_bytes"]), pf=bytes(fx["proof_bytes"]))


def _flip(data: bytes, word: int, bit: int) -> bytes:
    b = bytearray(data)
    b[8 * word + bit // 8] ^= 1 << (bit % 8)
    return bytes(b)


@pytest.mark.parametrize("bit", [32, 47, 63])
@pytest.mark.parametrize("target", ["jindo_proof", "jindo_commitment",
                                    "buckler_witness"])
def test_high_word_bits_are_refused(target, bit):
    """A residue word of the wire format with a bit of 32-63 set (a second
    byte string of the same object) makes the port's decoder raise
    ValueError.  The JAX package drops those bits, and its numpy-backend
    verifier accepts the changed bytes: that verdict is held here beside
    the port's.  Jindo at ZP255, N = 2^10 (the round-trip fixture); Buckler
    PublicKey at ZP220, N = 2^8 (its first witness commitment)."""
    word = {32: 0, 47: 5, 63: 100}[bit]
    if target == "buckler_witness":
        port = cases.port_case("public_key")
        ref = cases.ref_numpy_case("public_key")
        head = 4 + 8                      # witness count, first blob's length
        data = port["data"]
        bad = data[:head] + _flip(data[head:], word, bit)
        with pytest.raises(ValueError):
            bk.Proof.from_bytes(port["params"], bad)
        assert ref["vrf"].verify(ref["public"], ref_bk.Proof.from_bytes(
            ref["params"], bad)) is True
        return
    rt = _jindo_round_trip()
    com, pf = rt["com"], rt["pf"]
    if target == "jindo_proof":
        pf = _flip(pf, word, bit)
        with pytest.raises(ValueError):
            tj.Proof.from_bytes(rt["params"], pf)
    else:
        com = _flip(com, word, bit)
        with pytest.raises(ValueError):
            tj.Commitment.from_bytes(rt["params"], com)
    vrf = ref_jindo.Verifier(rt["ref_params"], rt["crs"])
    assert vrf.verify(
        rt["x"], [ref_jindo.Commitment.from_bytes(rt["ref_params"], com)],
        [rt["y"]], ref_jindo.Proof.from_bytes(rt["ref_params"], pf)) is True


@pytest.mark.slow
def test_fixture_is_the_jax_package_output():
    """Re-derive every circuit's proof through the JAX package's jax
    backend (minutes of compile on the CPU; run with
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2) and hold the stored fixture to it,
    so the fixture cannot drift from the reference."""
    fx = np.load(cases.FIXTURE)
    for name in cases.NAMES:
        cases.check_against_fixture(fx, name, *cases.jax_proof(name))


if __name__ == "__main__":
    names = sys.argv[2:] or cases.NAMES
    if sys.argv[1:2] != ["--write-fixture"] or set(names) - set(cases.NAMES):
        sys.exit("usage: python tests/test_torch_buckler.py --write-fixture "
                 f"[NAME ...]  (NAME in {', '.join(cases.NAMES)}; default all)")
    cases.write_fixture(names=names)
    print("wrote", ", ".join(names), "into", cases.FIXTURE)
