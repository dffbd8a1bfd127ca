"""Gaussian samplers: the host samplers of the reference and the device
twin-CDT search.

The host samplers (Ziggurat rounding, twin-CDT, COSAC) are the port's own
numpy copy of ``ringo_tpu.csprng.gaussian``: the same decision rules in the
same stream order, so each draws exactly what the reference draws.

``TwinCDTDevice`` is the commit path's search on tensors.  ``twin_search``
runs the CUDA kernel (csrc/twin_search.cu) on a CUDA tensor and its plain
version ``twin_search_plain`` on a CPU tensor.  The uint64 draws ``u`` are
held as their raw bits in ``int64``; the plain version compares them
sign-flipped (``u ^ 2^63``), which orders them as unsigned.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import backend
from ..fields import limb
from .uniform import UniformSampler

BLOCK_SIZE = 128
FLOAT_PREC = 52
TWIN_CDT_TAIL_CUT = 9
RN = 3.442619855899  # Marsaglia-Tsang (2000)


def _normal(x):
    return np.exp(-0.5 * x * x)


def _normal_integral(x):
    return math.sqrt(math.pi / 2) * math.erfc(x / math.sqrt(2))


def _ziggurat_tables():
    v = RN * math.exp(-0.5 * RN * RN) + _normal_integral(RN)
    xn = np.zeros(BLOCK_SIZE)
    xn[BLOCK_SIZE - 1] = RN
    for i in range(BLOCK_SIZE - 2, 0, -1):
        xn[i] = math.sqrt(-2 * math.log(v / xn[i + 1] + math.exp(-0.5 * xn[i + 1] ** 2)))
    scale = float(1 << FLOAT_PREC)
    kn = np.zeros(BLOCK_SIZE, dtype=np.uint64)
    wn = np.zeros(BLOCK_SIZE)
    fn = np.zeros(BLOCK_SIZE)  # fn[0] stays 0 — reference leaves it unset
    for i in range(1, BLOCK_SIZE):
        kn[i] = np.uint64(int((xn[i - 1] / xn[i]) * scale))
        wn[i] = xn[i] / scale
        fn[i] = math.exp(-0.5 * xn[i] ** 2)
    kn[0] = np.uint64(int((RN * math.exp(-0.5 * RN * RN) / v) * scale))
    wn[0] = (v / math.exp(-0.5 * RN * RN)) / scale
    return kn, wn, fn


_KN, _WN, _FN = _ziggurat_tables()


class RoundedGaussianSampler:
    """Ziggurat normal sampler + rounding (reference gaussian_rounded.go)."""

    def __init__(self, seed: bytes | None = None):
        self.base = UniformSampler(seed)

    def norm_float(self, count: int) -> np.ndarray:
        out = np.empty(count)
        filled = 0
        while filled < count:
            need = count - filled
            r = self.base.sample_u64(need)
            b = (r >> np.uint64(63)).astype(np.int64)
            i = (r % np.uint64(BLOCK_SIZE)).astype(np.int64)
            j = ((r >> np.uint64(7)) % np.uint64(1 << FLOAT_PREC))
            mag = j.astype(np.float64)
            x = np.where(b == 1, -mag, mag) * _WN[i]
            accept = j < _KN[i]
            # wedge test for non-accepted, i > 0
            wedge = (~accept) & (i > 0)
            if wedge.any():
                u = self.base.sample_float(int(wedge.sum()))
                f0 = _FN[i[wedge] - 1]
                f1 = _FN[i[wedge]]
                ok = u * (f0 - f1) < _normal(x[wedge]) - f1
                w_acc = np.zeros(len(r), dtype=bool)
                w_acc[np.nonzero(wedge)[0][ok]] = True
                accept = accept | w_acc
            # tail algorithm for i == 0 non-accepted
            tail = (~accept) & (i == 0)
            if tail.any():
                nt = int(tail.sum())
                tu = np.empty(nt)
                pend = np.arange(nt)
                while len(pend):
                    uu = -np.log(self.base.sample_float(len(pend))) * (1.0 / RN)
                    vv = -np.log(self.base.sample_float(len(pend)))
                    ok = vv + vv >= uu * uu
                    tu[pend[ok]] = uu[ok]
                    pend = pend[~ok]
                tu += RN
                tx = np.where(b[tail] == 1, -tu, tu)
                x = x.copy()
                x[np.nonzero(tail)[0]] = tx
                accept = accept | tail
            good = np.nonzero(accept)[0]
            take = min(len(good), need)
            out[filled:filled + take] = x[good[:take]]
            filled += take
        return out

    def sample(self, center, std_dev, count: int = 1) -> np.ndarray:
        if np.any(np.asarray(std_dev) <= 0):
            raise ValueError("standard deviation not positive")
        return np.round(np.asarray(center) + self.norm_float(count) * std_dev).astype(np.int64)


def compute_cdt(center: float, sigma: float) -> np.ndarray:
    """Cumulative distribution table (reference computeCDT,
    gaussian_twin_cdt.go:13-33)."""
    tail_hi = int(math.ceil(TWIN_CDT_TAIL_CUT * sigma))
    tail_lo = -tail_hi
    size = tail_hi - tail_lo + 1
    table = np.zeros(size, dtype=np.uint64)
    cdf = 0.0
    norm = math.sqrt(2 * math.pi) * sigma
    for idx, x in enumerate(range(tail_lo, tail_hi + 1)):
        rho = math.exp(-(x - center) ** 2 / (2 * sigma * sigma)) / norm
        cdf += rho
        if cdf > 1:
            table[idx] = np.uint64(0xFFFFFFFFFFFFFFFF)
        else:
            table[idx] = np.uint64(min(int(round(cdf * 2.0 ** 64)), (1 << 64) - 1))
    return table


def twin_cdt_resolve(std_dev: float, tail_lo: int, tail_hi: int,
                     c_frac: np.ndarray, u: np.ndarray,
                     v0: np.ndarray, v1: np.ndarray) -> np.ndarray:
    """Exact resolution of twin-table disagreements (reference Sample slow
    path, gaussian_twin_cdt.go:94-110): CDF walk at the exact fractional
    center; returns the chosen table index per lane.

    The reference sums x from tailLo up to the table *index* v0
    (gaussian_twin_cdt.go:99-104), so the x range must reach the max index
    value 2*tailHi."""
    xs = np.arange(tail_lo, 2 * tail_hi + 1, dtype=np.float64)
    norm = math.sqrt(2 * math.pi) * std_dev
    rho = np.exp(-(xs[None, :] - c_frac[:, None]) ** 2
                 / (2 * std_dev ** 2)) / norm
    cdf_cum = np.cumsum(rho, axis=1)
    idx = np.clip(v0 - tail_lo, 0, len(xs) - 1)
    cdf_at_v0 = cdf_cum[np.arange(len(c_frac)), idx.astype(np.int64)]
    p = u.astype(np.float64) / 2.0 ** 64
    return np.where(p < cdf_at_v0, v0, v1)


class TwinCDTGaussianSampler:
    """Twin-CDT discrete Gaussian: variable center, fixed sigma
    (reference gaussian_twin_cdt.go)."""

    def __init__(self, std_dev: float, seed: bytes | None = None):
        self.base = UniformSampler(seed)
        self.std_dev = float(std_dev)
        self.tables = np.stack(
            [compute_cdt(i / BLOCK_SIZE, std_dev) for i in range(BLOCK_SIZE)])
        self.tail_hi = int(math.ceil(TWIN_CDT_TAIL_CUT * std_dev))
        self.tail_lo = -self.tail_hi

    def sample(self, center, count: int | None = None) -> np.ndarray:
        c = np.atleast_1d(np.asarray(center, dtype=np.float64))
        if count is not None and len(c) == 1:
            c = np.broadcast_to(c, (count,)).copy()
        n = len(c)
        c_floor = np.floor(c)
        c_frac = c - c_floor
        c0 = (np.floor(BLOCK_SIZE * c_frac).astype(np.int64)) % BLOCK_SIZE
        c1 = (np.ceil(BLOCK_SIZE * c_frac).astype(np.int64)) % BLOCK_SIZE
        u = self.base.sample_u64(n)
        out = np.empty(n, dtype=np.int64)
        v0 = self._bsearch(c0, u)
        v1 = self._bsearch(c1, u) if not (c0 == c1).all() else v0
        agree = v0 == v1
        out[agree] = v0[agree] + c_floor[agree].astype(np.int64) + self.tail_lo
        bad = np.nonzero(~agree)[0]
        if len(bad):
            res = twin_cdt_resolve(self.std_dev, self.tail_lo, self.tail_hi,
                                   c_frac[bad], u[bad], v0[bad], v1[bad])
            out[bad] = res + self.tail_lo + c_floor[bad].astype(np.int64)
        return out

    def _bsearch(self, cc: np.ndarray, u: np.ndarray) -> np.ndarray:
        """Per-table binary search (Go slices.BinarySearch semantics with the
        found -> v-1 adjustment), vectorized across all lanes at once: each
        lane searches its own table row via log2(T) gather+compare steps
        (no sort needed, ~6x faster than sort-and-segment at 500k lanes)."""
        tbl_len = self.tables.shape[1]
        # searchsorted(side='left'): find lo = #entries < u ... with the Go
        # semantics: pos = first index with tbl[pos] >= u; found (==) -> pos-1.
        lo = np.zeros(len(cc), dtype=np.int64)          # invariant: tbl[lo-1] < u
        hi = np.full(len(cc), tbl_len, dtype=np.int64)  # invariant: tbl[hi] >= u
        steps = (tbl_len).bit_length()
        for _ in range(steps):
            mid = (lo + hi) >> 1
            less = self.tables[cc, np.minimum(mid, tbl_len - 1)] < u
            mid_ok = mid < hi
            lo = np.where(mid_ok & less, mid + 1, lo)
            hi = np.where(mid_ok & ~less, mid, hi)
        pos = lo
        eq = (pos < tbl_len) & (self.tables[cc, np.minimum(pos, tbl_len - 1)] == u)
        return pos - eq


class COSACSampler:
    """COSAC discrete Gaussian: variable center *and* sigma
    (reference gaussian_cosac.go)."""

    def __init__(self, seed: bytes | None = None):
        self.base = UniformSampler(seed)
        self.rounded = RoundedGaussianSampler(seed if seed is None else seed + b"r")

    def sample(self, center, std_dev, count: int | None = None) -> np.ndarray:
        c = np.atleast_1d(np.asarray(center, dtype=np.float64))
        s = np.atleast_1d(np.asarray(std_dev, dtype=np.float64))
        if count is not None and len(c) == 1:
            c = np.broadcast_to(c, (count,)).copy()
        if len(s) == 1:
            s = np.broadcast_to(s, c.shape)
        n = len(c)
        c_int = np.round(c)
        c_frac = c_int - c
        r = self.base.sample_float(n)
        direct = r < np.exp(-(c_frac ** 2) / (2 * s ** 2)) / (np.sqrt(2 * math.pi) * s)
        out = np.empty(n, dtype=np.int64)
        out[direct] = c_int[direct].astype(np.int64)
        pend = np.nonzero(~direct)[0]
        while len(pend):
            m = len(pend)
            sf, cf = s[pend], c_frac[pend]
            y = sf * self.rounded.norm_float(m)
            b = self.base.sample_u64(m) & np.uint64(1)
            y_round = np.where(b == 0, np.round(y) - 1, np.round(y) + 1)
            cmp = np.where(b == 0, y_round <= 0.5, y_round >= -0.5)
            rr = self.base.sample_float(m)
            acc_p = np.exp(-((y_round + cf) ** 2 - y * y) / (2 * sf * sf))
            ok = cmp & (rr < acc_p)
            idx = pend[ok]
            out[idx] = (y_round[ok] + c_int[idx]).astype(np.int64)
            pend = pend[~ok]
        return out


# ------------------------------------------------------- device search

_SIGN = -(1 << 63)  # int64 with only the top bit set: u ^ _SIGN orders as u64
_PLAIN_CHUNK = 1 << 16  # lanes per gathered [chunk, T] block of the plain search


def u64_to_f64(u: torch.Tensor) -> torch.Tensor:
    """Raw uint64 bits in int64 -> float64 value, correctly rounded (one
    rounding of the exact sum hi * 2^32 + lo)."""
    hi = ((u >> 32) & 0xFFFFFFFF).to(torch.float64)
    lo = (u & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + lo


def twin_search_plain(tables_flipped: torch.Tensor, c0: torch.Tensor,
                      c1: torch.Tensor, u: torch.Tensor):
    """Plain version of the twin search: for each lane, the Go
    BinarySearch position of u in table row c (found -> pos - 1), as
    (#entries < u) - (some entry == u), for c0 and c1.  Chunked
    compare-and-count over gathered rows.  ``tables_flipped`` is the
    [128, T] table ^ 2^63."""
    uf = u.reshape(-1) ^ _SIGN
    c0f = c0.reshape(-1).long()
    c1f = c1.reshape(-1).long()

    def count(cc, uu):
        rows = tables_flipped[cc]                      # [n, T]
        n_lt = (rows < uu[:, None]).sum(1)
        n_le = (rows <= uu[:, None]).sum(1)
        return n_lt - (n_le > n_lt).long()

    v0 = torch.empty_like(uf)
    v1 = torch.empty_like(uf)
    for s in range(0, uf.shape[0], _PLAIN_CHUNK):
        sl = slice(s, s + _PLAIN_CHUNK)
        v0[sl] = count(c0f[sl], uf[sl])
        v1[sl] = torch.where(c0f[sl] == c1f[sl], v0[sl],
                             count(c1f[sl], uf[sl]))
    return v0.reshape(u.shape), v1.reshape(u.shape)


def twin_search_cuda(tables: torch.Tensor, c0: torch.Tensor,
                     c1: torch.Tensor, u: torch.Tensor):
    """The CUDA twin search (csrc/twin_search.cu): ``tables`` [128, T] raw
    u64 bits in int64, c0/c1 int32, u raw u64 bits in int64, all on one
    card.  Returns int64 (v0, v1) of u's shape."""
    n = u.numel()
    backend.require(tables, torch.int64, name="tables")
    for name, t, dt in (("c0", c0, torch.int32), ("c1", c1, torch.int32),
                        ("u", u, torch.int64)):
        backend.require(t, dt, name=name)
        if t.numel() != n or not t.is_cuda:
            raise ValueError(f"{name}: expected {n} lanes on the card")
    if tables.shape[0] != BLOCK_SIZE or tables.shape[1] > 128:
        raise ValueError(f"tables: expected [128, T<=128], got "
                         f"{tuple(tables.shape)}")
    v0 = torch.empty(u.shape, dtype=torch.int64, device=u.device)
    v1 = torch.empty(u.shape, dtype=torch.int64, device=u.device)
    err = backend.lib().ringo_twin_search(
        tables.data_ptr(), c0.data_ptr(), c1.data_ptr(), u.data_ptr(),
        v0.data_ptr(), v1.data_ptr(), tables.shape[1], n,
        backend.stream_ptr(u))
    backend.check(err, "twin_search")
    backend.LAUNCHES["twin"] += 1
    return v0, v1


class TwinCDTDevice:
    """Twin-CDT search on tensors for one sigma (the device half of the
    reference sampler, gaussian_twin_cdt.go): the per-lane table search
    and the exact CDF walk for the lanes where the twin tables disagree.
    Its tables live on this object, on ``device``."""

    def __init__(self, std_dev: float, device):
        self.std_dev = float(std_dev)
        self.tables = np.stack(
            [compute_cdt(i / BLOCK_SIZE, std_dev) for i in range(BLOCK_SIZE)])
        self.tail_hi = int(math.ceil(TWIN_CDT_TAIL_CUT * std_dev))
        self.tail_lo = -self.tail_hi
        self.device = torch.device(device)
        raw = torch.from_numpy(self.tables.view(np.int64).copy())
        self.tables_raw = raw.to(self.device)
        self.tables_flipped = (raw ^ _SIGN).to(self.device)

    def twin_search(self, c0, c1, u):
        """(v0, v1) int64: the kernel on the card, the plain version on
        the CPU."""
        if u.is_cuda:
            return twin_search_cuda(self.tables_raw, c0.contiguous(),
                                    c1.contiguous(), u.contiguous())
        return twin_search_plain(self.tables_flipped, c0, c1, u)

    def search(self, centers, u, zero_center: bool = False):
        """centers f64, u raw u64 bits (int64), same shape.  Returns
        (prov, agree, c_floor, c_frac, v0, v1): ``prov`` is the sample
        where the twin tables agree; the other lanes go through
        ``resolve_device``.  ``zero_center`` searches table 0 only."""
        if zero_center:
            zc = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
            v0, _ = self.twin_search(zc, zc, u)
            zf = torch.zeros(u.shape, dtype=torch.float64, device=u.device)
            agree = torch.ones(u.shape, dtype=torch.bool, device=u.device)
            return v0 + self.tail_lo, agree, zf, zf, v0, v0
        c_floor = torch.floor(centers)
        c_frac = centers - c_floor
        c0 = torch.floor(BLOCK_SIZE * c_frac).to(torch.int32) % BLOCK_SIZE
        c1 = torch.ceil(BLOCK_SIZE * c_frac).to(torch.int32) % BLOCK_SIZE
        v0, v1 = self.twin_search(c0, c1, u)
        prov = v0 + c_floor.to(torch.int64) + self.tail_lo
        return prov, v0 == v1, c_floor, c_frac, v0, v1

    MARGIN = 1e-4

    def resolve_device(self, c_frac, u, v0, v1, c_floor, valid=None,
                       tier2: int = 4096):
        """Exact CDF walk for disagreeing lanes (reference
        gaussian_twin_cdt.go:94-110), in two tiers: a float32 CDF decides
        every lane whose draw lies farther than MARGIN from it, and the
        lanes inside the margin (``valid`` ones, at most ``tier2``) are
        recomputed in float64.  |cdf32 - cdf64| stays near 1e-5, so the
        margin keeps the outcome equal to the float64 walk's although this
        card's ``exp`` differs from XLA's by a few ULPs."""
        dev = c_frac.device
        T = 2 * self.tail_hi + 1 - self.tail_lo
        xs = torch.arange(self.tail_lo, 2 * self.tail_hi + 1,
                          dtype=torch.float64, device=dev)
        norm = math.sqrt(2 * math.pi) * self.std_dev
        inv2s2 = 1.0 / (2 * self.std_dev ** 2)
        idx = torch.clamp(v0 - self.tail_lo, 0, T - 1)
        cols = torch.arange(T, dtype=torch.int64, device=dev)
        c32 = c_frac.to(torch.float32)
        rho32 = torch.exp(-(xs.to(torch.float32)[None, :] - c32[:, None]) ** 2
                          * np.float32(inv2s2)) * np.float32(1.0 / norm)
        within = cols[None, :] <= idx[:, None]
        cdf32 = torch.where(within, rho32, torch.zeros((), device=dev)).sum(1)
        p_f = u64_to_f64(u) / 2.0 ** 64
        cdf = cdf32.to(torch.float64)
        close = (p_f - cdf).abs() < self.MARGIN
        if valid is not None:
            close = close & valid
        n_lanes = c_frac.shape[0]
        i2 = limb.nonzero_idx(close, tier2)
        safe = torch.clamp(i2, max=n_lanes - 1)
        cf2 = c_frac[safe]
        idx2 = idx[safe]
        rho64 = torch.exp(-(xs[None, :] - cf2[:, None]) ** 2 * inv2s2) / norm
        within2 = cols[None, :] <= idx2[:, None]
        cdf64 = torch.where(within2, rho64,
                            torch.zeros((), dtype=torch.float64,
                                        device=dev)).sum(1)
        cdf = limb.put_drop(cdf, i2, cdf64)
        res = torch.where(p_f < cdf, v0, v1)
        return res + self.tail_lo + c_floor.to(torch.int64)
