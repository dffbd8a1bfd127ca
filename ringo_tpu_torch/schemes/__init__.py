"""Lattice encryption schemes over the RNS ring: the minimal BGV/BFV of
the reference's bfv example."""
from .bgv import BGV, BGVParams, SecretKey  # noqa: F401
