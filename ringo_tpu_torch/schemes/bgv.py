"""Minimal BGV/BFV scheme over the RNS ring (the lattigo bgv/rlwe layer
that the reference's bfv example depends on, examples/bfv/main.go:89-125).

Ternary secret keygen, plaintext scale-up by Delta = t^-1 mod q, and
symmetric encryption c = (-c1*s + Delta*m + e, c1).  Ciphertexts are plain
(non-NTT) residues [L, n] at the API boundary, so the modulus switch into
Buckler's prime field is direct.  The samplers run on the host, in the
reference's order; the ring arithmetic on ``params.device`` (default: the
card).  Counterpart of ``ringo_tpu.schemes.bgv``: with the same seed the
same key, ciphertext, error and decryption (tests/test_torch_bgv.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..csprng import RoundedGaussianSampler, UniformSampler
from ..rings.rns import RnsReconstructor, RnsRing, ntt_friendly_primes


class BGVParams:
    def __init__(self, log_n: int, q_bits: list[int], t: int,
                 limb_bits: int = 30, device=None):
        self.device = backend.resolve_device(device)
        self.n = 1 << log_n
        self.t = t
        # the modulus budget sum(q_bits) in primes of at most limb_bits bits
        total_bits = sum(q_bits)
        count = -(-total_bits // limb_bits)
        bits = -(-total_bits // count)
        self.primes = ntt_friendly_primes(bits, 2 * self.n, count)
        self.ring_q = RnsRing(self.n, self.primes, self.device)
        self.q = self.ring_q.modulus
        # lattigo-bgv's scale: t * Delta = 1 (mod q), which the example's
        # switched circuit Delta assumes (examples/bfv/main.go:161)
        self.delta = pow(t, -1, self.q)


class SecretKey:
    def __init__(self, coeffs: torch.Tensor):
        self.coeffs = coeffs  # signed ternary int64 [n] on the ring's device


class BGV:
    def __init__(self, params: BGVParams, seed: bytes | None = None):
        self.params = params
        self.uniform = UniformSampler(seed, device=params.device)
        self.gauss = RoundedGaussianSampler(
            None if seed is None else seed + b"g", device=params.device)
        self.rec = RnsReconstructor(params.ring_q)

    def gen_secret_key(self) -> SecretKey:
        s = self.uniform.sample_n(3, self.params.n).astype(np.int64) - 1
        return SecretKey(torch.from_numpy(s).to(self.params.device))

    def _c1_times_s(self, sk: SecretKey, c1: torch.Tensor) -> torch.Tensor:
        ring = self.params.ring_q
        s = ring.embed_int64(sk.coeffs)
        return ring.intt(ring.mul_mont(ring.mform(ring.ntt(c1)), ring.ntt(s)))

    def encrypt(self, sk: SecretKey, m, err_std: float = 3.2):
        """Symmetric BFV encryption of m (n ints in [0, t)): returns
        (c0, c1, e) with c0 = -c1*s + Delta*m + e; c0, c1 plain residues
        [L, n], e signed int64 [n], all on the ring's device."""
        p = self.params
        ring, n, dev = p.ring_q, p.n, p.device
        res = np.stack([self.uniform.sample_n(q, n) for q in ring.primes])
        c1 = torch.from_numpy(res.astype(np.int64)).to(torch.int32).to(dev)
        e = torch.from_numpy(self.gauss.sample(0.0, err_std, n)).to(dev)
        dm = self.rec.set_bigints(
            [p.delta * int(mi) % p.q for mi in np.asarray(m).tolist()])
        c0 = ring.add(ring.neg(self._c1_times_s(sk, c1)), dm)
        c0 = ring.add(c0, ring.embed_int64(e))
        return c0, c1, e

    def decrypt(self, sk: SecretKey, c0, c1) -> torch.Tensor:
        """m from the phase Delta*m + e: t*phase = m + t*e (mod q), so m is
        the centred residue of t*phase mod q, reduced mod t.  int64 [n] on
        the host."""
        p = self.params
        ring = p.ring_q
        phase = ring.add(c0, self._c1_times_s(sk, c1))
        out = []
        for v in self.rec.reconstruct(phase):
            u = p.t * v % p.q
            if u > p.q // 2:
                u -= p.q
            out.append(u % p.t)
        return torch.tensor(out, dtype=torch.int64)
