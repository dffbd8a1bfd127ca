"""Fiat-Shamir oracle of the Jindo evaluation proof.

``Shake128Stream`` is an incremental-squeeze SHAKE128 (the reference's
sha3.NewSHAKE128 usage in jindo/prover.go:220-225): absorb with
``write``, squeeze with ``read``; writing after reading is an error;
``reset`` restarts.  The port's own copy of the JAX package's
``ringo_tpu.utils.transcript.Shake128Stream``; the two give the same
bytes (tests/test_torch_challenge.py).
"""

from __future__ import annotations

import hashlib


class Shake128Stream:
    def __init__(self):
        self._data = bytearray()
        self._read_pos = 0
        self._squeezing = False

    def write(self, data: bytes) -> None:
        if self._squeezing:
            raise RuntimeError("write after read on SHAKE stream")
        self._data += data

    def read(self, n: int) -> bytes:
        """The next n bytes of the squeeze.  hashlib has no incremental
        squeeze, so the digest is taken anew up to the read position."""
        self._squeezing = True
        out = hashlib.shake_128(bytes(self._data)).digest(self._read_pos + n)
        chunk = out[self._read_pos:self._read_pos + n]
        self._read_pos += n
        return chunk

    def reset(self) -> None:
        self._data = bytearray()
        self._read_pos = 0
        self._squeezing = False
