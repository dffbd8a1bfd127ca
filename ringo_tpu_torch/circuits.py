"""Four Buckler circuits with their assignments, made from a seed.

* ``public_key``: the RLWE public-key relation pk1 = pk0 * sk + noise
  in the NTT domain, with ternary sk and noise (the reference's
  buckler_test.go, and the Buckler benchmark's circuit): two NTT linear
  constraints, one arithmetic constraint, two inf-norm constraints of
  bound 1.
* ``mult``: X * Y = Z over Z_p[X]/(X^rank + 1) with |X|_inf <= 5 (the
  reference's examples/mult): two NTT linear constraints, one arithmetic
  constraint, an inf-norm decomposition of bound 5.
* ``sum_two_norm``: a zero-sum ternary x with a squared two-norm bound of
  4 * rank and y = Aut_5(x): sum-check, two-norm and automorphism.
* ``approx_inf_norm``: |x|_inf <= 8 by the modular Johnson-Lindenstrauss
  projection (second-round witnesses); it needs rank >= 2^11.
* ``bfv``: a BFV ciphertext is well formed, c0 = -c1*s + Delta*m + e with
  |m| < t and |e| <= N + t, after a modulus switch from the ciphertext
  modulus q to the field p (the reference's examples/bfv): two NTT linear
  constraints, one arithmetic constraint, two inf-norm decompositions.
  The ciphertext comes from the port's BGV (schemes/bgv.py); only
  integers cross into the ring.

The circuit classes are written against a Buckler API passed in as
``bk`` (``Witness``, ``PublicWitness``, ``ArithmeticConstraint``,
``NTTChecker``, ``AutChecker``) and the values come from a
``CyclotomicRing`` passed in as ``ring``, so one description serves every
caller: ``ringo_tpu_torch.buckler`` on the card or the CPU, and the tests,
which hand the same description to the JAX package.
"""

from __future__ import annotations

import types

import numpy as np

# name -> (field, log2 of the witness rank used by the tests)
CASES = {
    "public_key": ("ZP220", 8),
    "mult": ("ZP128", 8),
    "sum_two_norm": ("ZP220", 8),
    "approx_inf_norm": ("ZP220", 11),
    "bfv": ("ZP240", 8),
}
CRS = b"Buckler!"

# the reference bfv example's scheme: t = 2^16 + 1, q of 4 x 60 bits (as
# eight primes of 30 bits), the message 1, 2, 3, 4 in the first slots
BFV_T = (1 << 16) + 1
BFV_Q_BITS = [60, 60, 60, 60]
BFV_MESSAGE = [1, 2, 3, 4]


def seed_of(name: str) -> bytes:
    """The prover seed of a case (the CRS is ``CRS`` for all)."""
    return b"bk-" + name.encode()


def _field_ints(rng, p: int, n: int) -> list[int]:
    nb = (p.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nb), "little") % p for _ in range(n)]


def _small_ints(rng, lo: int, hi: int, p: int, n: int) -> list[int]:
    return [int(v) % p for v in rng.integers(lo, hi + 1, n)]


def _classes(bk):
    class PublicKey:
        def __init__(self):
            self.ntt = None
            self.sk = bk.Witness()
            self.sk_ntt = bk.Witness()
            self.pk_ntt = [bk.PublicWitness(), bk.PublicWitness()]
            self.noise = bk.Witness()
            self.noise_ntt = bk.Witness()

        def define(self, ctx):
            ctx.add_linear_constraint(self.sk_ntt, self.sk, self.ntt)
            ctx.add_linear_constraint(self.noise_ntt, self.noise, self.ntt)
            c = bk.ArithmeticConstraint()            # pk1 - pk0*sk - e = 0
            c.add_term(1, self.pk_ntt[1])
            c.add_term(-1, self.pk_ntt[0], self.sk_ntt)
            c.add_term(-1, None, self.noise_ntt)
            ctx.add_arithmetic_constraint(c)
            ctx.add_inf_norm_constraint(self.sk, 1)
            ctx.add_inf_norm_constraint(self.noise, 1)

    class Mult:
        def __init__(self):
            self.ntt_checker = None
            self.y_ntt = bk.PublicWitness()
            self.x_coeffs = bk.Witness()
            self.z_coeffs = bk.Witness()
            self.x_ntt = bk.Witness()
            self.z_ntt = bk.Witness()

        def define(self, ctx):
            ctx.add_linear_constraint(self.x_ntt, self.x_coeffs,
                                      self.ntt_checker)
            ctx.add_linear_constraint(self.z_ntt, self.z_coeffs,
                                      self.ntt_checker)
            c = bk.ArithmeticConstraint()            # Y*X - Z = 0
            c.add_term(1, self.y_ntt, self.x_ntt)
            c.add_term(-1, None, self.z_ntt)
            ctx.add_arithmetic_constraint(c)
            ctx.add_inf_norm_constraint(self.x_coeffs, 5)

    class SumTwoNorm:
        def __init__(self):
            self.aut = None
            self.x = bk.Witness()
            self.y = bk.Witness()

        def define(self, ctx):
            c = bk.ArithmeticConstraint()
            c.add_term(1, None, self.x)
            ctx.add_sum_check_constraint(c, 0)
            ctx.add_sq_two_norm_constraint(self.x, 4 * ctx.rank)
            ctx.add_linear_constraint(self.y, self.x, self.aut)

    class ApproxInfNorm:
        def __init__(self):
            self.x = bk.Witness()

        def define(self, ctx):
            ctx.add_approx_inf_norm_constraint(self.x, 8)

    class Ciphertext:
        def __init__(self, plaintext_modulus: int, err_bound: int,
                     delta: int):
            self.ntt_checker = None
            self.plaintext_modulus = plaintext_modulus
            self.err_bound = err_bound
            self.delta = delta
            self.ciphertext_ntt = [bk.PublicWitness(), bk.PublicWitness()]
            self.secret_key_ntt = bk.Witness()
            self.message_ntt = bk.Witness()
            self.message_coeffs = bk.Witness()
            self.error_ntt = bk.Witness()
            self.error_coeffs = bk.Witness()

        def define(self, ctx):
            ctx.add_linear_constraint(self.message_ntt, self.message_coeffs,
                                      self.ntt_checker)
            ctx.add_linear_constraint(self.error_ntt, self.error_coeffs,
                                      self.ntt_checker)
            c = bk.ArithmeticConstraint()        # c0 + c1*s - Delta*m - e = 0
            c.add_term(1, self.ciphertext_ntt[0])
            c.add_term(1, self.ciphertext_ntt[1], self.secret_key_ntt)
            c.add_term(-self.delta, None, self.message_ntt)
            c.add_term(-1, None, self.error_ntt)
            ctx.add_arithmetic_constraint(c)
            ctx.add_inf_norm_constraint(self.message_coeffs,
                                        self.plaintext_modulus - 1)
            ctx.add_inf_norm_constraint(self.error_coeffs, self.err_bound)

    return dict(public_key=PublicKey, mult=Mult, sum_two_norm=SumTwoNorm,
                approx_inf_norm=ApproxInfNorm, bfv=Ciphertext)


def _assignments(vals: dict, pub: dict):
    """(assignment, public assignment) from the secret witnesses' ring
    polynomials and the public witnesses' planes."""
    secret = {k: v.coeffs for k, v in vals.items()}
    assignment = types.SimpleNamespace(**secret, **pub)
    public = types.SimpleNamespace(**{k: None for k in secret}, **pub)
    return assignment, public


def bfv_encrypt(log_n: int, seed: bytes, device):
    """The bfv case's ciphertext: the reference example's BGV parameters
    at degree 2^log_n, a key and an encryption of ``BFV_MESSAGE`` from
    ``seed``, on ``device``.  Returns (bgv, sk, m, c0, c1)."""
    from .schemes.bgv import BGV, BGVParams

    bgv = BGV(BGVParams(log_n, BFV_Q_BITS, BFV_T, device=device), seed=seed)
    sk = bgv.gen_secret_key()
    m = np.zeros(bgv.params.n, dtype=np.int64)
    m[:len(BFV_MESSAGE)] = BFV_MESSAGE
    c0, c1, _ = bgv.encrypt(sk, m)
    return bgv, sk, m, c0, c1


def bfv_case(bk, ring, bgv, sk, m, c0, c1, checker_kw=None):
    """(circuit, assignment, public assignment) proving that (c0, c1) is
    a well-formed encryption of m under sk, over the ring's field
    (examples/bfv.py:91-148): c0 and c1 switched from q to p, the
    switched error recomputed, Delta = (t^-1 mod q) * p // q, the error
    bound N + t."""
    spec, n = ring.spec, ring.rank
    p, t, q = spec.p, bgv.params.t, bgv.params.q
    sk_ntt = ring.ntt(ring.from_ints([v % p for v in sk.coeffs.tolist()]))
    m_big = ring.from_ints([(v if v <= t // 2 else v - t) % p
                            for v in np.asarray(m).tolist()])
    m_ntt = ring.ntt(m_big)
    ct_ntt = [ring.ntt(ring.mod_switch_ints(
        [v % q for v in bgv.rec.reconstruct(c)], q)) for c in (c0, c1)]
    delta = pow(t, -1, q) * p // q
    err_ntt = ring.sub(ring.add(ring.mul(ct_ntt[1], sk_ntt), ct_ntt[0]),
                       ring.scalar_mul(m_ntt, delta))
    circuit = _classes(bk)["bfv"](t, n + t, delta)
    circuit.ntt_checker = bk.NTTChecker(spec, n, **(checker_kw or {}))
    vals = dict(secret_key_ntt=sk_ntt, message_ntt=m_ntt,
                message_coeffs=m_big, error_ntt=err_ntt,
                error_coeffs=ring.intt(err_ntt))
    return (circuit, *_assignments(
        vals, dict(ciphertext_ntt=[c.coeffs for c in ct_ntt])))


def build(name: str, bk, ring, seed: int = 0, checker_kw=None):
    """(circuit, assignment, public assignment) of case ``name`` at the
    ring's rank and field.  The assignment holds the ring's coefficient
    planes; the public one holds only the public witnesses.
    ``checker_kw``: extra keyword arguments of ``bk.NTTChecker`` (the
    port's takes ``device``)."""
    spec, n = ring.spec, ring.rank
    p = spec.p
    rng = np.random.default_rng(seed)
    if name == "bfv":
        return bfv_case(bk, ring, *bfv_encrypt(n.bit_length() - 1,
                                               rng.bytes(16), "cpu"),
                        checker_kw)
    circuit = _classes(bk)[name]()
    kw = checker_kw or {}
    if name == "public_key":
        sk = ring.from_ints(_small_ints(rng, -1, 1, p, n))
        noise = ring.from_ints(_small_ints(rng, -1, 1, p, n))
        pk0 = ring.from_ints(_field_ints(rng, p, n), is_ntt=True)
        sk_ntt, noise_ntt = ring.ntt(sk), ring.ntt(noise)
        pk1 = ring.add(ring.mul(pk0, sk_ntt), noise_ntt)
        circuit.ntt = bk.NTTChecker(spec, n, **kw)
        vals = dict(sk=sk, sk_ntt=sk_ntt, noise=noise, noise_ntt=noise_ntt)
        pub = dict(pk_ntt=[pk0.coeffs, pk1.coeffs])
    elif name == "mult":
        x = ring.from_ints(_small_ints(rng, 0, 5, p, n))
        y = ring.from_ints(_field_ints(rng, p, n))
        x_ntt, y_ntt = ring.ntt(x), ring.ntt(y)
        z_ntt = ring.mul(x_ntt, y_ntt)
        z = ring.intt(z_ntt)
        circuit.ntt_checker = bk.NTTChecker(spec, n, **kw)
        vals = dict(x_coeffs=x, z_coeffs=z, x_ntt=x_ntt, z_ntt=z_ntt)
        pub = dict(y_ntt=y_ntt.coeffs)
    elif name == "sum_two_norm":
        while True:
            xs = rng.integers(-1, 2, n)
            last = -int(xs[:-1].sum())
            if last in (-1, 0, 1):
                xs[-1] = last
                break
        x = ring.from_ints([int(v) % p for v in xs])
        circuit.aut = bk.AutChecker(ring, 5, is_ntt=False)
        vals = dict(x=x, y=ring.aut(x, 5))
        pub = {}
    elif name == "approx_inf_norm":
        vals = dict(x=ring.from_ints(_small_ints(rng, -8, 8, p, n)))
        pub = {}
    else:
        raise ValueError(f"unknown circuit {name!r}")
    return (circuit, *_assignments(vals, pub))
