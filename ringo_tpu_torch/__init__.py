"""ringo_tpu_torch: Jindo and Buckler in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.

A port of ``ringo_tpu`` (JAX/Pallas); it imports nothing of that package.
It holds the Jindo polynomial commitment (``jindo``: commit, evaluate,
verify), the Buckler PIOP toolkit over it (``buckler``), the big-field
and RNS rings under them (``rings``, ``ops``, ``fields``), the minimal
BGV/BFV scheme (``schemes``) and the reference's two example programs
(``examples.mult``, ``examples.bfv``).  Entry points (``jindo.Prover``,
``buckler.compile_circuit``, ``schemes.BGVParams``, ...) run on the card
unless the caller passes ``device="cpu"``.
"""
