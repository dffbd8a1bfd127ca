"""ringo_tpu_torch: the Jindo commitment in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.

A port of ``ringo_tpu`` (JAX/Pallas); it imports nothing of that package.
Entry points (``jindo.Prover``, ``jindo.CommitKey``) run on the card
unless the caller passes ``device="cpu"``.
"""
