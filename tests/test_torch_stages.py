"""The port's Jindo stage API against the JAX package's:
``raw_stages()["commit_core"]``, ``partial`` and ``response`` on the graft
entry's example inputs at ZP255, N = 2^10 (the JAX stages jitted on the
CPU, the JAX key carried over with ``commit_key_from_arrays``, the port's
residues converted to the JAX [2, L, ...] digit planes), ``entry()``,
``safe_copy`` (the JAX package's tests/test_jindo.py:70) and
``encode_challenge``.  Every comparison is exact."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ringo_tpu import backend, jindo
from ringo_tpu.fields import ZP255
from ringo_tpu.jindo import challenge as ref_chal
import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch import entry as port_entry
from ringo_tpu_torch.fields import ZP110 as PORT_ZP110, ZP255 as PORT_ZP255
from ringo_tpu_torch.fields import limb
from ringo_tpu_torch.rings.rns import RnsRing

CRS = b"Jindo!"
X = 987654321987654321


def _residues(primes, rng, *shape):
    """Residues below each prime, as the JAX package's uint32 planes."""
    q = np.array(primes, dtype=np.int64).reshape(-1, *([1] * len(shape)))
    r = rng.integers(0, 1 << 62, (len(primes), *shape)) % q
    return np.stack([r & 0xFFFF, r >> 16]).astype(np.uint32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's stages at the graft entry's size and seed."""
    backend.use("jax")
    try:
        params = jindo.new_parameters(ZP255, 1 << 10, 1)
        prv = jindo.Prover(params, CRS, seed=b"graft")
        raw = prv.raw_stages()
        e, noise = graft._example_inputs(params)
        ck = jax.tree_util.tree_map(np.asarray, tuple(prv.ck_device()))
        core = [np.asarray(o) for o in jax.jit(raw["commit_core"])(e, noise,
                                                                   *ck)]
        left = np.asarray(prv.ecd.encode_scalars(ref_chal.left_vec(params, X)))
        chals = _residues(params.ring_q.primes, np.random.default_rng(4),
                          params.cols, params.degree)
        part = np.asarray(jax.jit(raw["partial"])(left, core[0]))
        resp = [np.asarray(o) for o in
                jax.jit(raw["response"])(chals, core[0], core[1])]
        return dict(e=e, noise=noise, core=core, left=left, chals=chals,
                    partial=part, response=resp,
                    key=(prv.ck.In, prv.ck.MLWE, prv.ck.Out))
    finally:
        backend.use("numpy")


@pytest.fixture(scope="module")
def port(ref):
    params = tj.new_parameters(PORT_ZP255, 1 << 10, 1)
    ck = tj.commit_key_from_arrays(params, *ref["key"], device="cpu", crs=CRS)
    return tj.Prover(params, CRS, seed=b"graft", device="cpu", ck=ck)


def _planes(t: torch.Tensor) -> np.ndarray:
    return RnsRing.to_planes(t).numpy()


def test_commit_core_matches_jax(ref, port):
    e, noise = (torch.from_numpy(a) for a in (ref["e"], ref["noise"]))
    got = port.raw_stages()["commit_core"](e, noise, *port.ck_device())
    assert len(got) == 4
    for g, w in zip(got, ref["core"]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_planes(g), w)
    # with a leading batch axis: the same per item
    batched = port.raw_stages()["commit_core"](
        torch.stack([e, e]), torch.stack([noise, noise]), *port.ck_device())
    for g, w in zip(batched, got):
        assert torch.equal(g[0], w) and torch.equal(g[1], w)


def test_partial_and_response_match_jax(ref, port):
    raw = port.raw_stages()
    left = port.ecd.encode_scalars(tj.left_vec(port.params, X))
    np.testing.assert_array_equal(_planes(left), ref["left"])
    enc, mlwe = (RnsRing.from_planes(ref["core"][i]) for i in (0, 1))
    np.testing.assert_array_equal(_planes(raw["partial"](left, enc)),
                                  ref["partial"])
    got = raw["response"](RnsRing.from_planes(ref["chals"]), enc, mlwe)
    for g, w in zip(got, ref["response"]):
        np.testing.assert_array_equal(_planes(g), w)


def test_entry_is_the_commit_core_of_the_graft_entry(ref):
    """entry() expands its key from the CRS itself: the same bytes."""
    fn, args = port_entry.entry(device="cpu")
    np.testing.assert_array_equal(args[0].numpy(), ref["e"])
    np.testing.assert_array_equal(args[1].numpy(), ref["noise"])
    for g, w in zip(fn(*args), ref["core"]):
        np.testing.assert_array_equal(_planes(g), w)


def test_raw_stages_keys():
    params = tj.new_parameters(PORT_ZP110, 1 << 8, 1)
    prv = tj.Prover(params, b"sc!", seed=b"orig", device="cpu")
    assert set(prv.raw_stages()) == {
        "commit_core", "sample", "seeds_encode", "partial", "response",
        "combine", "combine_seeds"}
    assert prv.ck_device() == (prv._pk_in, prv._pk_out)


def test_prover_safe_copy():
    """safe_copy shares the parameters and the commit key but draws from
    sampler states of its own (reference SafeCopy, jindo/prover.go:
    327-339): copies give distinct commitments, a seeded copy is
    reproducible, and a copy's commitment opens through the shared key."""
    params = tj.new_parameters(PORT_ZP110, 1 << 8, 1)
    prv = tj.Prover(params, b"sc!", seed=b"orig", device="cpu")
    vrf = tj.Verifier(params, b"sc!", device="cpu", ck=prv.ck)
    rng = np.random.default_rng(2)
    n = 1 << 8
    v = limb.ints_to_digits([int.from_bytes(rng.bytes(15), "little")
                             % PORT_ZP110.p for _ in range(n)], PORT_ZP110.w)
    c1, _ = prv.safe_copy(seed=b"a").commit(v)
    c2, _ = prv.safe_copy(seed=b"b").commit(v)
    c3, _ = prv.safe_copy(seed=b"a").commit(v)
    assert c1.to_bytes() != c2.to_bytes()
    assert c1.to_bytes() == c3.to_bytes()
    cp = prv.safe_copy(seed=b"a")
    assert cp.ck is prv.ck and cp.uniform is not prv.uniform
    c, o = cp.commit(v)
    ys, pf = cp.evaluate(424242, [v], [c], [o])
    assert vrf.verify(424242, [c], ys, pf) is True
    # the original's own stream is untouched by its copies
    fresh = tj.Prover(params, b"sc!", seed=b"orig", device="cpu", ck=prv.ck)
    assert prv.commit(v)[0].to_bytes() == fresh.commit(v)[0].to_bytes()


@pytest.mark.parametrize("which", ["ring_q", "ring_q_out"])
def test_encode_challenge_matches_jax(which):
    ref_p = jindo.new_parameters(ZP255, 1 << 8, 1)
    p = tj.new_parameters(PORT_ZP255, 1 << 8, 1)
    chal = np.random.default_rng(6).bytes(16)
    want = ref_chal.encode_challenge(ref_p, getattr(ref_p, which), chal)
    got = tj.encode_challenge(p, getattr(p, which), chal)
    np.testing.assert_array_equal(_planes(got), want)
    assert torch.equal(got, tj.challenge.encode_challenges(
        p, getattr(p, which), [chal]))
