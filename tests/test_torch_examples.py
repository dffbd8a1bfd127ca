"""The port's two example programs (ringo_tpu_torch/examples/mult.py and
bfv.py, the reference's examples/mult.py and bfv.py) run end to end on the
CPU at rank 2^8 and verify; bfv's decryption returns the message; with
no device given and no card they raise instead of falling back."""

import numpy as np
import pytest
import torch

from ringo_tpu_torch.examples import bfv, mult

from torch_buckler_cases import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("example", [mult, bfv], ids=["mult", "bfv"])
def test_example_runs_and_verifies_on_the_cpu(example, capsys):
    out = example.main(8, seed=1, device="cpu")
    printed = capsys.readouterr().out
    assert out["ok"] is True and "Verification result: True" in printed
    for what in ("Compile time", "Prover time", "Verifier time",
                 "Estimated proof size"):
        assert what in printed
    assert out["prv"].ctx.rank == 1 << 8 and out["size_mb"] > 0
    # a tampered evaluation does not verify
    bad = out["proof"]
    bad.evals[0] = (bad.evals[0] + 1) % out["spec"].p
    assert out["vrf"].verify(out["public"], bad) is False


def test_bfv_decrypts_its_ciphertext_and_seeds_repeat():
    a = bfv.setup(8, seed=3, device="cpu")
    b = bfv.setup(8, seed=3, device="cpu")
    (c0, c1), bgv = a["ciphertext"], a["bgv"]
    assert c0.shape == (8, 1 << 8) and len(bgv.params.primes) == 8
    assert all(torch.equal(x, y) for x, y in zip(a["ciphertext"],
                                                   b["ciphertext"]))
    assert np.array_equal(a["assignment"].message_coeffs.numpy(),
                          b["assignment"].message_coeffs.numpy())


@pytest.mark.parametrize("example", [mult, bfv], ids=["mult", "bfv"])
def test_examples_need_the_card_or_an_explicit_cpu(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        example.main(8, seed=1)
