"""The reference's two example programs on the port, each runnable as a
module (on the card unless ``--device cpu`` is given):

    python3 -m ringo_tpu_torch.examples.mult [--log-n 13] [--seed S] [--device cpu]
    python3 -m ringo_tpu_torch.examples.bfv  [--log-n 13] [--seed S] [--device cpu]

``setup`` builds the inputs and compiles the circuit, ``prove_and_verify``
proves and verifies, ``main`` does both and prints the times, the verdict
and the estimated proof size as the reference's scripts do.
"""

import argparse
import time

import torch


def clock(device) -> float:
    """Host-clock seconds after the work queued on ``device`` is done."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def prove_and_verify(case: dict) -> dict:
    """Prove the case's assignment and verify the proof against its public
    assignment, each timed on the host clock."""
    dev = case["prv"].device
    t0 = clock(dev)
    pf = case["prv"].prove(case["assignment"])
    t1 = clock(dev)
    ok = case["vrf"].verify(case["public"], pf)
    t2 = clock(dev)
    return dict(proof=pf, ok=ok, prove_s=t1 - t0, verify_s=t2 - t1)


def run(setup, log_n: int, seed, device) -> dict:
    """``setup`` then ``prove_and_verify``, printing as the reference's
    scripts do; raises unless the proof verifies."""
    case = setup(log_n, seed, device)
    print(f"Compile time: {case['compile_s']:.3f}s")
    out = prove_and_verify(case)
    print(f"Prover time: {out['prove_s']:.3f}s")
    print(f"Verifier time: {out['verify_s']:.3f}s")
    print("Verification result:", out["ok"])
    size = case["prv"].params.size() / 2 ** 23
    print(f"Estimated proof size: {size:.3f} MB")
    if out["ok"] is not True:
        raise AssertionError("the proof did not verify")
    return dict(case, **out, size_mb=size)


def cli(main, description: str) -> None:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--log-n", type=int, default=13,
                    help="log2 of the witness rank (default 13)")
    ap.add_argument("--seed", type=int, default=None,
                    help="seed of the inputs, CRS and prover (default random)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the "
                         "plain path)")
    args = ap.parse_args()
    main(args.log_n, args.seed, args.device)
