"""The port's Jindo round trip, the slice as a whole, against the JAX
package at ZP255, N = 2^10, t = 1: for the same CRS, seed, vector and
point, ``commit`` -> ``evaluate`` on the CPU gives the same evaluations and
a byte-identical proof (ringo_tpu with backend "jax" on the CPU is the
reference), each package's verifier accepts the other's proof, and the
port rejects the reference's five tampers as the reference does (its
verifier runs under the numpy backend).  Every comparison is exact.  The
golden fixture that chip_smoke.py checks the card against is held equal to
ringo_tpu here, so it cannot go stale; rewrite it with

    python tests/test_torch_roundtrip.py --write-fixture
"""

import os
import sys

import numpy as np
import pytest
import torch

from ringo_tpu import backend, jindo
from ringo_tpu.fields import ZP255, limb
import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch.fields import ZP255 as PORT_ZP255

CRS = b"Jindo!"
SEED = b"torch-port"
LOG_N = 10
X = 1234567890123456789012345678901234567890
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ringo_tpu_torch", "testdata", "roundtrip_zp255_n10.npz")
TAMPERS = ["eval", "crs", "encode", "in_commit", "partial_mask"]


def _values(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % ZP255.p for _ in range(n)]
    return limb.ints_to_digits(vals, ZP255.w)


def _jax_reference():
    """JAX-package commit(v) and evaluate at X, on the inputs of the
    commit fixture (tests/test_torch_commit.py)."""
    backend.use("jax")
    try:
        params = jindo.new_parameters(ZP255, 1 << LOG_N, 1)
        prv = jindo.Prover(params, CRS, seed=SEED)
        v = _values(0, 1 << LOG_N)
        com, op = prv.commit(v)
        ys, pf = prv.evaluate(X, [v], [com], [op])
        return dict(params=params, v=v, com=com, ys=ys, pf=pf,
                    com_bytes=com.to_bytes(), pf_bytes=pf.to_bytes(params),
                    fields={f: np.asarray(getattr(pf, f))
                            for f in jindo.Proof.FIELDS})
    finally:
        backend.use("numpy")


@pytest.fixture(scope="module")
def ref():
    return _jax_reference()


@pytest.fixture(scope="module")
def port(ref):
    params = tj.new_parameters(PORT_ZP255, 1 << LOG_N, 1)
    prv = tj.Prover(params, CRS, seed=SEED, device="cpu")
    com, op = prv.commit(ref["v"])
    ys, pf = prv.evaluate(X, [ref["v"]], [com], [op])
    vrf = tj.Verifier(params, CRS, device="cpu", ck=prv.ck)
    return dict(params=params, prv=prv, com=com, op=op, ys=ys, pf=pf, vrf=vrf)


def test_evaluations_and_proof_bytes_match_jax(ref, port):
    assert port["com"].to_bytes() == ref["com_bytes"]
    assert port["ys"] == [int(y) for y in ref["ys"]]
    for f in tj.Proof.FIELDS:
        np.testing.assert_array_equal(getattr(port["pf"], f).numpy(),
                                      ref["fields"][f], err_msg=f)
    assert port["pf"].to_bytes(port["params"]) == ref["pf_bytes"]


def test_evaluation_is_the_polynomial_at_x(ref, port):
    acc = 0
    for c in reversed(limb.digits_to_ints(ref["v"])):
        acc = (acc * X + c) % ZP255.p
    assert port["ys"] == [acc]


def test_bytes_round_trip(port):
    params, pf = port["params"], port["pf"]
    data = pf.to_bytes(params)
    back = tj.Proof.from_bytes(params, data)
    for f in tj.Proof.FIELDS:
        assert torch.equal(getattr(back, f), getattr(pf, f)), f
    assert back.to_bytes(params) == data
    com = tj.Commitment.from_bytes(params, port["com"].to_bytes())
    assert torch.equal(com.value, port["com"].value)
    with pytest.raises(ValueError):
        tj.Proof.from_bytes(params, data + b"\0" * 8)
    with pytest.raises(ValueError):
        tj.Commitment.from_bytes(params, port["com"].to_bytes()[:-8])


def test_port_verifier_accepts_the_jax_proof(ref, port):
    params = port["params"]
    com = tj.Commitment.from_bytes(params, ref["com_bytes"])
    pf = tj.Proof.from_bytes(params, ref["pf_bytes"])
    assert port["vrf"].verify(X, [com], [int(y) for y in ref["ys"]], pf) is True
    assert port["vrf"].verify(X, [port["com"]], port["ys"], port["pf"]) is True


def test_jax_verifier_accepts_the_port_proof(ref, port):
    params = ref["params"]
    com = jindo.Commitment.from_bytes(params, port["com"].to_bytes())
    pf = jindo.Proof.from_bytes(params, port["pf"].to_bytes(port["params"]))
    assert not backend.is_jax()
    vrf = jindo.Verifier(params, CRS)
    assert vrf.verify(X, [com], port["ys"], pf) is True


@pytest.mark.parametrize("tamper", TAMPERS)
def test_tampers_rejected_as_by_the_reference(ref, port, tamper):
    """The reference's five tampers (tests/test_jindo_device.py) on the
    same proof bytes: both verifiers say False."""
    crs = b"wrong" if tamper == "crs" else CRS
    ys = list(port["ys"])
    data = port["pf"].to_bytes(port["params"])
    pf_ref = jindo.Proof.from_bytes(ref["params"], data)
    pf = tj.Proof.from_bytes(port["params"], data)
    if tamper == "eval":
        ys[0] ^= 1
    elif tamper in tj.Proof.FIELDS:
        for proof in (pf_ref, pf):
            arr = np.array(getattr(proof, tamper))
            arr[(0,) * arr.ndim] ^= 1
            setattr(proof, tamper, arr)
    vrf = port["vrf"] if tamper != "crs" else tj.Verifier(
        port["params"], crs, device="cpu")
    assert vrf.verify(X, [port["com"]], ys, pf) is False
    assert jindo.Verifier(ref["params"], crs).verify(
        X, [ref["com"]], ys, pf_ref) is False


# The fields whose bytes never enter the oracle: there the reference's
# digit arithmetic reduces a lane mod q on the way, so it takes q + r for r.
REDUCED_BY_THE_REFERENCE = ("in_commit", "encode", "mlwe")


@pytest.mark.parametrize("field", tj.Proof.FIELDS)
@pytest.mark.parametrize("how", ["plus_q", "high_bit", "wide_digit"])
def test_non_canonical_lanes_are_rejected_without_an_exception(
        ref, port, field, how):
    """Proof lanes from outside are the u32 their digits spell; the port
    rejects a lane outside [0, q) (False), never with an exception: the
    same residue plus q, a flipped top bit (negative as int32), and a digit
    wider than 16 bits.  The reference, on the same planes, agrees on every
    case but one: a lane q + r < 2^31 in a field that is not hashed it
    reduces to r and accepts, a second encoding of the same proof.  The
    port's rule is the stricter one on purpose (one proof, one byte
    string), and that divergence is held here."""
    params = port["params"]
    data = port["pf"].to_bytes(params)
    pf = tj.Proof.from_bytes(params, data)
    pf_ref = jindo.Proof.from_bytes(ref["params"], data)
    at = (0,) * (getattr(pf, field).dim() - 1)
    ring = params.ring_q_out if field == "in_commit" else params.ring_q
    for proof in (pf, pf_ref):
        planes = np.array(getattr(proof, field)).astype(np.int64)
        if how == "plus_q":
            v = int(planes[0][at]) + (int(planes[1][at]) << 16) + ring.primes[0]
            planes[0][at], planes[1][at] = v & 0xFFFF, v >> 16
        elif how == "high_bit":
            planes[1][at] |= 0x8000
        else:
            planes[0][at] += 1 << 16
        setattr(proof, field, torch.from_numpy(planes) if proof is pf
                else planes.astype(np.uint32))
    assert port["vrf"].verify(X, [port["com"]], port["ys"], pf) is False
    assert jindo.Verifier(ref["params"], CRS).verify(
        X, [ref["com"]], port["ys"], pf_ref) is (
            how == "plus_q" and field in REDUCED_BY_THE_REFERENCE)


def test_malformed_inputs_raise(port):
    params, vrf = port["params"], port["vrf"]
    pf = tj.Proof.from_bytes(params, port["pf"].to_bytes(params))
    pf.encode = pf.encode[:, :, :-1]
    with pytest.raises(ValueError):
        vrf.verify(X, [port["com"]], port["ys"], pf)
    with pytest.raises(ValueError):
        vrf.verify(X, [port["com"]] * 2, port["ys"], port["pf"])
    with pytest.raises(ValueError):
        port["prv"].evaluate(X, [], [], [])


def test_a_key_without_crs_bytes_cannot_bind_a_transcript(ref, port):
    prv = port["prv"]
    to_planes = lambda a: prv.ring_q.to_planes(a).numpy()
    ck = tj.commit_key_from_arrays(
        port["params"], to_planes(prv.ck.In), to_planes(prv.ck.MLWE),
        to_planes(prv.ck.Out), device="cpu")
    bare = tj.Prover(port["params"], CRS, seed=SEED, device="cpu", ck=ck)
    com, op = bare.commit(ref["v"])
    assert com.to_bytes() == ref["com_bytes"]
    with pytest.raises(ValueError, match="CRS"):
        bare.evaluate(X, [ref["v"]], [com], [op])
    ck2 = tj.commit_key_from_arrays(
        port["params"], to_planes(prv.ck.In), to_planes(prv.ck.MLWE),
        to_planes(prv.ck.Out), device="cpu", crs=CRS)
    ys, pf = tj.Prover(port["params"], CRS, seed=SEED, device="cpu",
                       ck=ck2).evaluate(X, [ref["v"]], [com], [op])
    assert pf.to_bytes(port["params"]) == ref["pf_bytes"]


def test_golden_fixture_matches_jax(ref):
    fx = np.load(FIXTURE)
    np.testing.assert_array_equal(fx["v"], ref["v"])
    assert int.from_bytes(bytes(fx["x"]), "big") == X
    assert [int.from_bytes(bytes(fx["evaluation"]), "big")] == \
        [int(y) for y in ref["ys"]]
    assert bytes(fx["proof_bytes"]) == ref["pf_bytes"]
    assert bytes(fx["commit_bytes"]) == ref["com_bytes"]
    assert bytes(fx["crs"]) == CRS and bytes(fx["seed"]) == SEED
    assert int(fx["log_n"]) == LOG_N


def write_fixture(path: str = FIXTURE) -> None:
    """Rewrite the golden fixture from the JAX package."""
    r = _jax_reference()
    u8 = lambda b: np.frombuffer(b, np.uint8)
    np.savez_compressed(
        path, v=r["v"], crs=u8(CRS), seed=u8(SEED), log_n=np.int64(LOG_N),
        x=u8(X.to_bytes(32, "big")),
        evaluation=u8(int(r["ys"][0]).to_bytes(32, "big")),
        commit_bytes=u8(r["com_bytes"]), proof_bytes=u8(r["pf_bytes"]))


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_roundtrip.py --write-fixture")
    write_fixture()
    print("wrote", FIXTURE)
