"""RNS rings Z_Q[X]/(X^d + 1), Q a product of NTT-friendly primes < 2^31.

Inside the port a polynomial is a tensor of residues, one ``int32`` per
lane: ``[L, *batch, d]``.  Every prime is below 2^31 (ZP255's are below
2^26), so a product of two residues fits ``int64`` exactly and the ring
operations are plain integer arithmetic; the values are the canonical
residues the JAX package's digit planes hold.  At the public surface
(commitments, openings) polynomials keep the JAX package's digit-plane
layout ``[2, L, *batch, d]`` (16-bit digits): ``to_planes`` /
``from_planes`` convert.

``ntt_mform`` / ``intt_imform`` run the matmul NTT (ops/ntt_matmul.py):
the CUDA kernel for every row count on the card, the plain version on the
CPU; they serve d = 256.  ``ntt`` / ``intt`` run the stage engine
(ops/ntt.py) at any degree, with int64 butterflies through ``mul_mont``
(the BGV ring, schemes/bgv.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.spec import is_probable_prime
from ..ops import ntt as nttmod

R_MONT = 1 << 32  # Montgomery radix of the two-digit residues


def ntt_friendly_primes(bits: int, nth_root: int, count: int,
                        upstream: bool = True) -> list[int]:
    """Next ``count`` primes q = 2^bits +/- i*nth_root + 1 with
    q = 1 mod nth_root, ascending upstream, descending otherwise (lattigo
    NTTFriendlyPrimesGenerator semantics)."""
    out = []
    step = nth_root if upstream else -nth_root
    q = (1 << bits) + 1
    while len(out) < count:
        if q > 3 and is_probable_prime(q):
            out.append(q)
        q += step
        if q < nth_root:
            raise ValueError("prime search exhausted")
    return out


def _as_int64(planes) -> torch.Tensor:
    if isinstance(planes, torch.Tensor):
        return planes.to(torch.int64)
    return torch.as_tensor(np.asarray(planes).astype(np.int64))


class RnsRing:
    """Negacyclic RNS ring of degree d over a chain of primes, with its
    tables on ``device``."""

    def __init__(self, d: int, primes, device="cpu"):
        primes = tuple(int(p) for p in primes)
        if any(p % (2 * d) != 1 for p in primes):
            raise ValueError("primes must be 1 mod 2d")
        if any(p >= 1 << 31 for p in primes):
            raise ValueError("RNS primes must be < 2^31")
        self.d = d
        self.primes = primes
        self.L = len(primes)
        self.device = torch.device(device)
        self.modulus = 1
        for p in primes:
            self.modulus *= p
        self.q = torch.tensor(primes, dtype=torch.int64, device=self.device)
        self.rinv = torch.tensor([pow(R_MONT, -1, p) for p in primes],
                                 dtype=torch.int64, device=self.device)
        self.r2 = torch.tensor([R_MONT * R_MONT % p for p in primes],
                               dtype=torch.int64, device=self.device)
        self._mm = None
        self._stage = None

    def on(self, device) -> "RnsRing":
        """This ring with its tables on ``device``."""
        device = torch.device(device)
        return self if device == self.device else RnsRing(
            self.d, self.primes, device)

    def _col(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """[L] table -> broadcastable against [L, ...] of ``ndim`` dims."""
        return t.reshape(self.L, *([1] * (ndim - 1)))

    # ---- layouts -----------------------------------------------------------

    @staticmethod
    def to_planes(res: torch.Tensor) -> torch.Tensor:
        """Residues [L, ...] -> int64 digit planes [2, L, ...]."""
        r = res.to(torch.int64)
        return torch.stack([r & 0xFFFF, r >> 16])

    @staticmethod
    def from_planes(planes) -> torch.Tensor:
        """Digit planes [2, L, ...] of canonical residues -> int32
        residues [L, ...].  Planes from outside the program go through
        ``from_untrusted_planes``."""
        p = _as_int64(planes)
        return (p[0] | (p[1] << 16)).to(torch.int32)

    def to_bytes(self, planes) -> bytes:
        """Canonical little-endian uint64 words, level-major, of digit
        planes [2, L, ...] (the JAX ring's ``to_bytes``)."""
        p = _as_int64(planes).cpu()
        u = (p[0] | (p[1] << 16)).numpy().astype("<u8")
        return np.ascontiguousarray(u).tobytes()

    @staticmethod
    def from_u64(residues) -> torch.Tensor:
        """Residue words [L, ...] (numpy uint64 or a tensor) -> int64
        digit planes [2, L, ...]; bits above the low 32 are dropped, as
        the JAX ring's ``from_u64`` drops them."""
        if not isinstance(residues, torch.Tensor):
            residues = torch.from_numpy(
                np.ascontiguousarray(residues).astype(np.uint64).view(np.int64))
        r = residues.to(torch.int64)
        return torch.stack([r & 0xFFFF, (r >> 16) & 0xFFFF])

    def from_untrusted_planes(self, planes):
        """Digit planes [2, L, ...] from outside the program (a proof or a
        commitment read from bytes) -> (int32 residues [L, ...] on the
        ring's device, ``ok``).  A lane is the number its two digits
        spell, digit0 + 2^16 * digit1; ``ok`` (a 0-dim bool tensor) says
        that every lane is a canonical residue in [0, q).  The residues
        returned are reduced mod q whatever ``ok`` says, so the arithmetic
        after them is defined; a verifier rejects when ``ok`` is false."""
        p = _as_int64(planes).to(self.device)
        v = p[0] + (p[1] << 16)
        q = self._col(self.q, v.dim())
        ok = ((p >= 0) & (p <= 0xFFFF)).all() & (v < q).all()
        return torch.remainder(v, q).to(torch.int32), ok

    # ---- ring ops ----------------------------------------------------------

    def embed_int64(self, values: torch.Tensor) -> torch.Tensor:
        """Signed int64 values [*batch, d] -> residues [L, *batch, d]
        (reference setCoeffSigned, jindo/utils.go:49-60)."""
        v = values.to(torch.int64)[None]
        return torch.remainder(v, self._col(self.q, v.dim())).to(torch.int32)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a.to(torch.int64) + b.to(torch.int64)
        q = self._col(self.q, s.dim())
        return torch.where(s >= q, s - q, s).to(torch.int32)

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a.to(torch.int64) - b.to(torch.int64)
        q = self._col(self.q, s.dim())
        return torch.where(s < 0, s + q, s).to(torch.int32)

    def mul_mont(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a * b * R^-1 mod q (lattigo MulCoeffsMontgomery)."""
        s = a.to(torch.int64) * b.to(torch.int64)
        q = self._col(self.q, s.dim())
        return (s % q * self._col(self.rinv, s.dim()) % q).to(torch.int32)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        s = a.to(torch.int64)
        q = self._col(self.q, s.dim())
        return torch.where(s == 0, s, q - s).to(torch.int32)

    def mform(self, a: torch.Tensor) -> torch.Tensor:
        """a * R mod q (lattigo MForm)."""
        return self.mul_mont(a, self._col(self.r2, a.dim()))

    def imform(self, a: torch.Tensor) -> torch.Tensor:
        """a * R^-1 mod q (lattigo IMForm)."""
        return self.mul_mont(a, torch.ones_like(a))

    def mul_mont_add(self, a, b, c) -> torch.Tensor:
        """c + a*b*R^-1 (a in Montgomery form)."""
        return self.add(c, self.mul_mont(a, b))

    def mul_mont_sub(self, c, a, b) -> torch.Tensor:
        """c - a*b*R^-1 (a in Montgomery form)."""
        return self.sub(c, self.mul_mont(a, b))

    def scalar_rns_mont(self, value: int) -> torch.Tensor:
        """An integer scalar as per-prime Montgomery residues
        value * R mod q_l, int64 [L] on the ring's device."""
        return torch.tensor([value % p * R_MONT % p for p in self.primes],
                            dtype=torch.int64, device=self.device)

    def mul_scalar_mont(self, a: torch.Tensor,
                        scalar: torch.Tensor) -> torch.Tensor:
        """Pointwise by a per-prime scalar [L] in Montgomery form:
        a * scalar * R^-1 mod q (lattigo MulRNSScalarMontgomery)."""
        return self.mul_mont(a, self._col(scalar, a.dim()))

    def _matmul_ntt(self):
        if self._mm is None:
            from ..ops.ntt_matmul import MatmulNTT
            self._mm = MatmulNTT(self)
        return self._mm

    def _stage_plan(self) -> "_RnsStagePlan":
        if self._stage is None:
            self._stage = _RnsStagePlan(self)
        return self._stage

    def ntt(self, a: torch.Tensor) -> torch.Tensor:
        """Negacyclic NTT of plain residues [L, *batch, d] by the stage
        engine: bit-reversed evaluations, the reference's order."""
        return nttmod.ntt_fwd(self._stage_plan(), a)

    def intt(self, a: torch.Tensor) -> torch.Tensor:
        """Inverse of ``ntt``, with the 1/d scaling."""
        return nttmod.ntt_inv(self._stage_plan(), a)

    def ntt_mform(self, a: torch.Tensor) -> torch.Tensor:
        """ntt(mform(a)) for plain residues [L, *lead, d]."""
        return self._matmul_ntt().ntt_mform(a)

    def intt_imform(self, a: torch.Tensor) -> torch.Tensor:
        """intt(imform(a)) for NTT/Montgomery residues [L, *lead, d]."""
        return self._matmul_ntt().intt_imform(a)


class _RnsStagePlan:
    """The RNS ring's plan of the stage engine (ops/ntt.py): per-prime
    twiddles in Montgomery form [L, d], ``mul`` the ring's reduce-first
    ``mul_mont``, so every product stays below 2^62 in int64."""

    def __init__(self, ring: RnsRing):
        d = ring.d
        self.n = d
        self.mul, self.add, self.sub = ring.mul_mont, ring.add, ring.sub
        tw, twinv, ninv = [], [], []
        for p in ring.primes:
            # FieldSpec only serves the root search; b and k are placeholders
            t, ti, nv = nttmod._tables_host(p, p - 1, 1, d, True)
            tw.append([x * R_MONT % p for x in t])
            twinv.append([x * R_MONT % p for x in ti])
            ninv.append(nv * R_MONT % p)
        mk = lambda v: torch.tensor(v, dtype=torch.int32, device=ring.device)
        self.tw, self.twinv, self.ninv = mk(tw), mk(twinv), mk(ninv)


class RnsReconstructor:
    """Exact CRT reconstruction of plain residues into balanced Python
    ints on the host (reference jindo/rns.go reconstructTo).  For the few
    d-coefficient polynomials the verifier decodes; whole tensors go
    through rings/rns_device.py."""

    def __init__(self, ring: RnsRing):
        self.ring = ring
        Q = ring.modulus
        self.gad = [Q // p * pow(Q // p, -1, p) % Q for p in ring.primes]

    def reconstruct(self, res: torch.Tensor) -> list[int]:
        """Residues [L, n] -> n balanced ints in [-Q/2, Q/2)."""
        Q = self.ring.modulus
        out = []
        for col in res.to(torch.int64).cpu().T.tolist():
            acc = sum(r * g for r, g in zip(col, self.gad)) % Q
            out.append(acc - Q if acc >= Q >> 1 else acc)
        return out

    def set_bigints(self, values) -> torch.Tensor:
        """Python ints -> plain residues [L, len(values)] on the ring's
        device (reference jindo/rns.go setBigCoeffTo)."""
        rg = self.ring
        res = [[int(v) % p for v in values] for p in rg.primes]
        return torch.tensor(res, dtype=torch.int32, device=rg.device)
