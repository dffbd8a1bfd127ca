"""Field descriptors for Jindo-friendly prime fields p = b^k + 1.

The port's own copy of ``ringo_tpu.fields.spec`` (it imports nothing of
the JAX package): a ``FieldSpec`` carries the digit count, Montgomery
constants and host helpers of one modulus, and the seven reference moduli
are defined here.

Digit layout: values are split into ``w`` digits of ``DIGIT_BITS`` (16)
bits, little-endian.  The Montgomery radix is R = 2^(16*w).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

DIGIT_BITS = 16
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1


def is_probable_prime(n: int, rounds: int = 64) -> bool:
    """Miller-Rabin primality test (deterministic bases + random rounds)."""
    if n < 2:
        return False
    small = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37]
    for p in small:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    import random

    rng = random.Random(0xB1E55ED)
    bases = small + [rng.randrange(2, n - 1) for _ in range(rounds)]
    for a in bases:
        a %= n
        if a in (0, 1, n - 1):
            continue
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Descriptor of a prime field p = b^k + 1 for the limb engine."""

    p: int
    b: int
    k: int

    @functools.cached_property
    def bits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def w(self) -> int:
        """Number of 16-bit digits."""
        return -(-self.bits // DIGIT_BITS)

    @functools.cached_property
    def R(self) -> int:
        """Montgomery radix 2^(16w)."""
        return 1 << (DIGIT_BITS * self.w)

    @functools.cached_property
    def r_mod_p(self) -> int:
        return self.R % self.p

    @functools.cached_property
    def r2_mod_p(self) -> int:
        return (self.R * self.R) % self.p

    @functools.cached_property
    def qinv16(self) -> int:
        """-p^{-1} mod 2^16 (per-digit Montgomery constant)."""
        return (-pow(self.p, -1, DIGIT_BASE)) % DIGIT_BASE

    # ---- digit helpers (host) -------------------------------------------

    def to_digits_int(self, x: int) -> list[int]:
        x %= self.p
        return [(x >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(self.w)]

    def from_digits_int(self, digits) -> int:
        x = 0
        for j in reversed(range(self.w)):
            x = (x << DIGIT_BITS) | int(digits[j])
        return x

    @functools.cached_property
    def p_digits(self) -> np.ndarray:
        return np.array(
            [(self.p >> (DIGIT_BITS * j)) & DIGIT_MASK for j in range(self.w)],
            dtype=np.uint32)

    @functools.cached_property
    def r2_digits(self) -> np.ndarray:
        return np.array(self.to_digits_int(self.r2_mod_p), dtype=np.uint32)

    @functools.cached_property
    def one_digits(self) -> np.ndarray:
        d = np.zeros(self.w, dtype=np.uint32)
        d[0] = 1
        return d

    # ---- number-theory helpers ------------------------------------------

    def inverse(self, x: int) -> int:
        return pow(x % self.p, self.p - 2, self.p)

    def find_generator(self, order: int, negacyclic: bool) -> int:
        """Find an element of order ``order`` (cyclic) / ``2*order`` primitive
        root for negacyclic use, by brute-force search from 2 — the same search
        as reference math/bigpoly/ntt.go:43-53,170-180."""
        p = self.p
        if negacyclic:
            t1 = (p - 1) // (2 * order)
            t2 = order
        else:
            t1 = (p - 1) // order
            t2 = order >> 1
        x = 2
        while True:
            g = pow(x, t1, p)
            if pow(g, t2, p) != 1:
                return g
            x += 1

    def marshal(self, x: int) -> bytes:
        """Canonical big-endian fixed-width encoding (goff Marshal-compatible
        width: ceil(bits/64)*8 bytes, matching the reference's 64-bit-limb
        Marshal; reference jindo/internal/zp/element.go Marshal)."""
        n64 = -(-self.bits // 64)
        return int(x % self.p).to_bytes(8 * n64, "big")

    def unmarshal(self, data: bytes) -> int:
        return int.from_bytes(data, "big") % self.p

    def set_bytes(self, data: bytes) -> int:
        """Interpret big-endian bytes, reduced mod p (goff SetBytes)."""
        return int.from_bytes(data, "big") % self.p


# The seven reference moduli (SURVEY.md §2.1 table; values match the generated
# Go packages: jindo/internal/zp, buckler/internal/zp{110,220,440,880},
# examples/{mult,bfv}/zp).
ZP255 = FieldSpec(p=60272 ** 16 + 1, b=60272, k=16)
ZP110 = FieldSpec(p=12640 ** 8 + 1, b=12640, k=8)
ZP220 = FieldSpec(p=13216 ** 16 + 1, b=13216, k=16)
ZP440 = FieldSpec(p=13512 ** 32 + 1, b=13512, k=32)
ZP880 = FieldSpec(p=13694 ** 64 + 1, b=13694, k=64)
ZP128 = FieldSpec(p=60256 ** 8 + 1, b=60256, k=8)
ZP240 = FieldSpec(p=31432 ** 16 + 1, b=31432, k=16)

REFERENCE_FIELDS = {
    "zp255": ZP255, "zp110": ZP110, "zp220": ZP220, "zp440": ZP440,
    "zp880": ZP880, "zp128": ZP128, "zp240": ZP240,
}
