"""The port's Buckler against the JAX package on the bfv circuit of
ringo_tpu_torch/circuits.py over ZP240 at N = 2^8: a BFV ciphertext of the
port's BGV switched from q to p, two inf-norm decompositions of bounds
t - 1 and N + t (a Jindo batch of 43), with the checks of
tests/test_torch_buckler.py: proof bytes equal to the fixture's bfv record
(the JAX package's jax backend), cross verification with the JAX
package's numpy backend both ways, a tampered evaluation and a verifier of
another CRS rejected."""

import pytest

from ringo_tpu import buckler as ref_bk
from ringo_tpu.rings.bigring import CyclotomicRing as RefCyclotomicRing
from ringo_tpu_torch import buckler as bk, circuits, fields
from ringo_tpu_torch.rings.bigring import CyclotomicRing

import torch_buckler_cases as cases
from torch_buckler_cases import one_torch_thread  # noqa: F401

NAMES = ("bfv",)


@pytest.mark.parametrize("name", NAMES)
def test_proof_bytes_match_the_jax_fixture(name):
    cases.check_proof_matches_the_fixture(name)


@pytest.mark.parametrize("name", NAMES)
def test_reference_verifier_accepts_the_port_proof(name):
    cases.check_reference_verifier_accepts_the_port_proof(name)


@pytest.mark.parametrize("name", NAMES)
def test_port_verifier_accepts_the_reference_proof(name):
    cases.check_port_verifier_accepts_the_reference_proof(name)


def test_both_packages_get_the_same_statement():
    """The same switched ciphertext, Delta and bounds reach both
    packages' rings; the Jindo batch is the bfv path's 43."""
    port = cases.port_compiled("bfv")
    ref = cases.ref_numpy_case("bfv")
    assert port["params"].batch == ref["params"].batch == 43
    assert cases.public_ints(port["public"], fields.limb.digits_to_ints) == \
        cases.public_ints(ref["public"], ref["prv"].poly_ring.ops.to_ints)
    field, log_n = circuits.CASES["bfv"]
    ring = CyclotomicRing(getattr(fields, field), 1 << log_n, device="cpu")
    c, _, _ = circuits.build("bfv", bk, ring, checker_kw={"device": "cpu"})
    rc, _, _ = circuits.build("bfv", ref_bk, RefCyclotomicRing(
        ref["params"].spec, 1 << log_n))
    q = circuits.bfv_encrypt(log_n, b"any", "cpu")[0].params.q
    assert (c.plaintext_modulus, c.err_bound, c.delta) == \
        (rc.plaintext_modulus, rc.err_bound, rc.delta) == \
        (circuits.BFV_T, (1 << log_n) + circuits.BFV_T,
         pow(circuits.BFV_T, -1, q) * ring.spec.p // q)


def test_the_witness_is_the_encryption():
    """The assignment's message is the BFV message, its error is within
    the bound, and the arithmetic constraint holds coefficient-wise."""
    field, log_n = circuits.CASES["bfv"]
    spec = getattr(fields, field)
    ring = CyclotomicRing(spec, 1 << log_n, device="cpu")
    c, a, pub = circuits.build("bfv", bk, ring, checker_kw={"device": "cpu"})
    p = spec.p
    centred = lambda vs: [v - p if v > p // 2 else v for v in vs]
    m = centred(ring.ops.to_ints(a.message_coeffs))
    assert m[:4] == circuits.BFV_MESSAGE and not any(m[4:])
    e = centred(ring.ops.to_ints(a.error_coeffs))
    assert max(abs(v) for v in e) <= c.err_bound
    c0, c1, s = (ring.ops.to_ints(x) for x in (*pub.ciphertext_ntt,
                                                a.secret_key_ntt))
    mn, en = ring.ops.to_ints(a.message_ntt), ring.ops.to_ints(a.error_ntt)
    assert all((x0 + x1 * sk - c.delta * mi - ei) % p == 0
               for x0, x1, sk, mi, ei in zip(c0, c1, s, mn, en))
    assert pub.secret_key_ntt is None and pub.error_coeffs is None
