"""The port's Jindo commit, the slice as a whole, against the JAX
package: for the same CRS and seed, ``commit`` and ``commit_many`` on the
CPU give byte-identical commitments, inner commitments and opening seeds
(ringo_tpu with backend "jax" on the CPU is the reference).  The same
again with the JAX package's commit key carried over, which holds the
compute path apart from the AES/CRS path.  The golden fixture that
chip_smoke.py checks the card against is held equal to ringo_tpu here, so
it cannot go stale; rewrite it with

    python tests/test_torch_commit.py --write-fixture
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
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "ringo_tpu_torch", "testdata", "commit_zp255_n10.npz")


def _values(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % ZP255.p for _ in range(n)]
    return limb.ints_to_digits(vals, ZP255.w)


def _jax_reference():
    """JAX-package commit(v), then commit_many([v1, v2]), on one prover."""
    backend.use("jax")
    try:
        params = jindo.new_parameters(ZP255, 1 << LOG_N, 1)
        prv = jindo.Prover(params, CRS, seed=SEED)
        v, v1, v2 = (_values(0, 1 << LOG_N), _values(1, 1 << LOG_N),
                     _values(2, 700))
        out = [prv.commit(v)] + prv.commit_many([v1, v2])
        pull = lambda c, o: dict(
            value=np.asarray(c.value), bytes=c.to_bytes(),
            in_commit=np.asarray(o.in_commit),
            e_i64=np.asarray(o.seeds[0]), noise=np.asarray(o.seeds[1]))
        return dict(vs=[v, v1, v2], results=[pull(c, o) for c, o in out],
                    key=(prv.ck.In, prv.ck.MLWE, prv.ck.Out))
    finally:
        backend.use("numpy")


@pytest.fixture(scope="module")
def ref():
    return _jax_reference()


def _check(got, want):
    (com, op) = got
    np.testing.assert_array_equal(com.value.numpy(), want["value"])
    assert com.to_bytes() == want["bytes"]
    np.testing.assert_array_equal(op.in_commit.numpy(), want["in_commit"])
    np.testing.assert_array_equal(op.seeds[0].numpy(), want["e_i64"])
    np.testing.assert_array_equal(op.seeds[1].numpy(), want["noise"])


@pytest.mark.parametrize("key", ["crs", "carried"])
def test_commit_matches_jax(ref, key):
    params = tj.new_parameters(PORT_ZP255, 1 << LOG_N, 1)
    ck = None
    if key == "carried":
        ck = tj.commit_key_from_arrays(params, *ref["key"], device="cpu")
    prv = tj.Prover(params, CRS, seed=SEED, device="cpu", ck=ck)
    if key == "crs":
        for mine, theirs in zip((prv.ck.In, prv.ck.MLWE, prv.ck.Out),
                                ref["key"]):
            t = theirs.astype(np.int64)
            np.testing.assert_array_equal(mine.numpy(), t[0] | (t[1] << 16))
    v, v1, v2 = ref["vs"]
    got = [prv.commit(v)] + prv.commit_many(
        [torch.from_numpy(v1.astype(np.int64)), v2])
    assert len(got) == 3
    for g, w in zip(got, ref["results"]):
        _check(g, w)


def test_golden_fixture_matches_jax(ref):
    fx = np.load(FIXTURE)
    want = ref["results"][0]
    np.testing.assert_array_equal(fx["v"], ref["vs"][0])
    assert bytes(fx["commit_bytes"]) == want["bytes"]
    np.testing.assert_array_equal(fx["in_commit"], want["in_commit"])
    np.testing.assert_array_equal(fx["e_i64"], want["e_i64"])
    np.testing.assert_array_equal(fx["noise"], want["noise"])
    assert bytes(fx["crs"]) == CRS and bytes(fx["seed"]) == SEED
    assert int(fx["log_n"]) == LOG_N


def test_entry_points_need_an_explicit_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    params = tj.new_parameters(PORT_ZP255, 1 << LOG_N, 1)
    with pytest.raises(RuntimeError):
        tj.Prover(params, CRS, seed=SEED)
    with pytest.raises(RuntimeError):
        tj.CommitKey(params, CRS)
    with pytest.raises(RuntimeError):
        tj.Verifier(params, CRS)
    ck = tj.CommitKey(params, CRS, device="cpu")
    with pytest.raises(RuntimeError):
        tj.Verifier(params, CRS, ck=ck)


def write_fixture(path: str = FIXTURE) -> None:
    """Rewrite the golden fixture from the JAX package."""
    r = _jax_reference()
    want = r["results"][0]
    np.savez_compressed(
        path, v=r["vs"][0], crs=np.frombuffer(CRS, np.uint8),
        seed=np.frombuffer(SEED, np.uint8), log_n=np.int64(LOG_N),
        commit_bytes=np.frombuffer(want["bytes"], np.uint8),
        in_commit=want["in_commit"].astype(np.uint16),
        e_i64=want["e_i64"], noise=want["noise"])


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        sys.exit("usage: python tests/test_torch_commit.py --write-fixture")
    write_fixture()
    print("wrote", FIXTURE)
