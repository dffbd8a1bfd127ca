"""Automatic parameter selection for the Jindo PCS.

The port's own copy of ``ringo_tpu.jindo.params``: a pure-host search
reproducing the reference exactly (same float64 operations in the same
order, jindo/params.go:18-320).  RNS primes are capped at ``limb_bits``
(default 30, reference 60), as in the JAX package; the security
computation only sees q = 2^(bits*count).  The rings are built on the CPU;
a prover moves them to its device with ``RnsRing.on``.
"""

from __future__ import annotations

import dataclasses
import math

from ..fields.spec import FieldSpec
from ..rings.rns import RnsRing, ntt_friendly_primes

# Security constants (reference jindo/params.go:42-51).
RLWE_RANK = 1 << 13      # secure for stdDev = 2*sqrt(2)*eta
MAX_LOG_Q = 240          # secure for stdDev = 2*sqrt(2)*eta
ETA = 6                  # smoothing parameter
TAIL_CUT = 5             # Gaussian tail cut

DEFAULT_LIMB_BITS = 30   # prime size of the JAX package (reference: 60)


def find_msis_rank(d: float, q: float, beta: float) -> int:
    """Root-Hermite-factor MSIS rank bound (reference params.go:53-61)."""
    if beta > q:
        raise ValueError("findMSISRank: beta > q")
    log_beta = math.log2(beta)
    log_q = math.log2(q)
    log_delta = math.log2(1.005)
    return int(math.ceil((log_beta * log_beta) / (4 * d * log_q * log_delta)))


@dataclasses.dataclass
class Parameters:
    """Jindo PCS parameters (reference jindo/params.go:64-123).

    Field names follow the reference's getters; ``ring_q``/``ring_q_out`` are
    RnsRing instances replacing lattigo rings.
    """

    spec: FieldSpec
    batch: int

    rank: int
    rows: int
    cols: int

    slots: int

    in_msis_rank: int
    out_msis_rank: int
    mlwe_rank: int

    log_in_cutoff: int
    log_out_cutoff: int

    in_com_dcmp_len: int

    ring_q: RnsRing
    ring_q_out: RnsRing

    ecd_std_dev: float
    ecd_blind_std_dev: float
    mask_std_dev: float
    mask_blind_std_dev: float

    mlwe_std_dev: float
    mask_mlwe_std_dev: float

    res_two_nm: float
    in_com_dcmp_two_nm: float

    com_size: float
    pf_size: float

    @property
    def base(self) -> int:
        return self.spec.b

    @property
    def exp(self) -> int:
        return self.spec.k

    @property
    def challenge_bound(self) -> int:
        """min(b, 2^(120/k)) / 2 (reference params.go:357-360)."""
        return min(self.spec.b, 1 << (120 // self.spec.k)) // 2

    @property
    def degree(self) -> int:
        return self.ring_q.d

    @property
    def commitment_size(self) -> float:
        """Analytic commitment size in bits (reference CommitmentSize,
        params.go:443-446)."""
        return self.com_size

    @property
    def proof_size(self) -> float:
        """Analytic evaluation-proof size in bits (reference ProofSize,
        params.go:448-451)."""
        return self.pf_size

    def size(self) -> float:
        return self.com_size + self.pf_size


def _prime_chain(log_modulus: float, d: int, limb_bits: int):
    """Split a modulus budget into NTT-friendly primes (reference
    params.go:279-301 via lattigo NTTFriendlyPrimesGenerator)."""
    limbs = int(math.ceil(log_modulus / limb_bits))
    bits = int(math.ceil(log_modulus / limbs))
    return ntt_friendly_primes(bits, 2 * d, limbs)


def new_parameters(spec: FieldSpec, target_n: int, batch: int,
                   limb_bits: int = DEFAULT_LIMB_BITS) -> Parameters:
    """Reference NewParameters (jindo/params.go:126-320), same search order."""
    if target_n < 1:
        raise ValueError("targetN must be >= 1")
    if batch < 1:
        raise ValueError("batch must be >= 1")

    t = float(batch)
    b = float(spec.b)
    k = float(spec.k)
    d = float(max(spec.k, 256))
    l = d / k

    nu = RLWE_RANK / d

    max_cols = int(math.ceil(target_n / l))
    min_size = math.inf
    best = None

    nn = 1
    while nn <= max_cols:
        n = float(nn)
        m = math.ceil(target_n / (n * l))

        x_one = math.sqrt(k) * b
        c_one = math.sqrt(k) * min(b, 2.0 ** (120 / k)) / 2

        ecd_std = 2 / (b - 1) * (b + 1) * ETA
        ecd_blind_std = 2 * x_one / (b - 1) * (b + 1) * ETA
        mask_std = 2 * c_one / (b - 1) * (b + 1) * ETA
        mask_blind_std = 2 * c_one * x_one / (b - 1) * (b + 1) * ETA

        mlwe_std = 2 * math.sqrt(2) * ETA
        mask_mlwe_std = 2 * c_one * math.sqrt(2) * ETA

        fij_inf = TAIL_CUT * (b + 1) * ecd_std
        f0j_inf = TAIL_CUT * (b + 1) * math.sqrt(m + 1) * ecd_blind_std
        fin_inf = TAIL_CUT * (b + 1) * math.sqrt(n + 1) * mask_std
        f0n_inf = TAIL_CUT * (b + 1) * math.sqrt((m + 1) * n + 1) * mask_blind_std

        res_ecdi_inf = math.sqrt(n) * c_one * fij_inf + fin_inf
        res_ecd0_inf = math.sqrt(n) * c_one * f0j_inf + f0n_inf
        pr_inf = math.sqrt(m) * x_one * fij_inf + f0j_inf
        if t > 1:
            res_ecdi_inf *= math.sqrt(t) * c_one
            res_ecd0_inf *= math.sqrt(t) * c_one
            pr_inf *= math.sqrt(t) * c_one

        res_ecd_two = math.sqrt(d * (m * res_ecdi_inf ** 2 + res_ecd0_inf ** 2))

        mlwe_inf = TAIL_CUT * mlwe_std
        mask_mlwe_inf = TAIL_CUT * math.sqrt(n + 1) * mask_mlwe_std
        res_mlwe_inf = math.sqrt(n) * c_one * mlwe_inf + mask_mlwe_inf
        if t > 1:
            res_mlwe_inf *= math.sqrt(t) * c_one

        # inner-MSIS rank fixed point (params.go:185-217)
        q = in_msis_rank = in_cutoff_two = 0.0
        res_two = d_ext_one = 0.0
        mu = 1
        while True:
            res_mlwe_two = math.sqrt(d * (mu + nu)) * res_mlwe_inf
            res_two = math.sqrt(res_ecd_two ** 2 + res_mlwe_two ** 2)
            in_cutoff_two = res_two

            if t == 1:
                ext_beta = 2 * (res_two + in_cutoff_two)
                c_ext_one = 2 * c_one
                d_ext_one = 1.0
            else:
                ext_beta = 2 * (2 * c_one) * (res_two + in_cutoff_two)
                c_ext_one = (2 * c_one) * (2 * c_one)
                d_ext_one = 2 * c_one

            in_msis_beta = 2 * d_ext_one * c_ext_one * ext_beta
            log_q = math.ceil(math.log2(in_msis_beta))
            q_limbs = int(math.ceil(log_q / 60.0))
            q_bits = int(math.ceil(log_q / q_limbs))
            q = 2.0 ** (q_bits * q_limbs)

            if math.log2(q) > MAX_LOG_Q:
                mu += 1
                continue

            if find_msis_rank(d, q, in_msis_beta) == mu:
                in_msis_rank = float(mu)
                break
            mu += 1

        in_cutoff_inf = in_cutoff_two / ((1 + math.sqrt(n) * c_one)
                                         * math.sqrt(in_msis_rank * d))
        if t > 1:
            in_cutoff_inf /= math.sqrt(t) * c_one

        in_dcmp_inf = q / in_cutoff_inf
        if t > 1:
            in_dcmp_inf *= math.sqrt(t) * c_one

        in_dcmp_two = math.sqrt((n + 1) * in_msis_rank * d) * in_dcmp_inf
        out_cutoff_two = in_dcmp_two

        out_msis_beta = 2 * d_ext_one * (2 * (in_dcmp_two + out_cutoff_two))

        log_qq = math.ceil(math.log2(out_msis_beta))
        qq_limbs = int(math.ceil(log_qq / 60.0))
        qq_bits = int(math.ceil(log_qq / qq_limbs))
        qq = 2.0 ** (qq_bits * qq_limbs)
        if math.log2(qq) > MAX_LOG_Q:
            nn <<= 1
            continue
        out_msis_rank = float(find_msis_rank(d, qq, out_msis_beta))

        out_cutoff_inf = out_cutoff_two / math.sqrt(out_msis_rank * d)
        if t > 1:
            out_cutoff_inf /= math.sqrt(t) * c_one

        com_size = t * out_msis_rank * d * math.log2(qq / out_cutoff_inf)

        pf_size = 0.0
        pf_size += n * d * math.log2(pr_inf)                            # Partial
        pf_size += d * math.log2(q)                                     # Partial * Mask
        pf_size += m * d * math.log2(res_ecdi_inf)                      # Response 1..m
        pf_size += d * math.log2(res_ecd0_inf)                          # Response 0
        pf_size += (in_msis_rank + nu) * d * math.log2(res_mlwe_inf)    # Response MLWE
        pf_size += ((n + 1) * in_msis_rank * d) * math.log2(in_dcmp_inf)  # Inner coms

        if com_size + pf_size < min_size:
            min_size = com_size + pf_size

            ring_q = RnsRing(int(d), _prime_chain(math.log2(q), int(d), limb_bits))
            ring_q_out = RnsRing(int(d), _prime_chain(math.log2(qq), int(d), limb_bits))

            best = Parameters(
                spec=spec,
                batch=batch,
                rank=int(n) * int(m) * int(l),
                rows=int(m) + 1,
                cols=int(n),
                slots=int(d) // spec.k,
                in_msis_rank=int(in_msis_rank),
                out_msis_rank=int(out_msis_rank),
                mlwe_rank=int(nu),
                log_in_cutoff=int(math.floor(math.log2(in_cutoff_inf))),
                log_out_cutoff=int(math.floor(math.log2(out_cutoff_inf))),
                in_com_dcmp_len=int((n + 1) * in_msis_rank),
                ring_q=ring_q,
                ring_q_out=ring_q_out,
                ecd_std_dev=ecd_std / math.sqrt(2 * math.pi),
                ecd_blind_std_dev=ecd_blind_std / math.sqrt(2 * math.pi),
                mask_std_dev=mask_std / math.sqrt(2 * math.pi),
                mask_blind_std_dev=mask_blind_std / math.sqrt(2 * math.pi),
                mlwe_std_dev=mlwe_std / math.sqrt(2 * math.pi),
                mask_mlwe_std_dev=mask_mlwe_std / math.sqrt(2 * math.pi),
                res_two_nm=res_two + in_cutoff_two,
                in_com_dcmp_two_nm=in_dcmp_two + out_cutoff_two,
                com_size=com_size,
                pf_size=pf_size,
            )
        nn <<= 1

    if best is None:
        raise ValueError("no parameter set found")
    return best
