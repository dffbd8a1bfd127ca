"""Gaussian samplers: the host samplers of the reference, their device
loop, and the device twin-CDT search.

The host samplers (Ziggurat rounding, twin-CDT, COSAC) are the port's own
numpy copy of ``ringo_tpu.csprng.gaussian``: the same decision rules in the
same stream order, so each draws exactly what the reference draws.  Each
takes the device its uniform keystream is drawn on.

``RoundedGaussianSampler.sample_device`` and ``COSACSampler.sample_device``
draw the same integers on tensors of the sampler's device, each call one
run of the whole rejection loop (``_draw``): on a CUDA device one launch of
the loop kernel of csrc/gaussian.cu (``gauss_loop_cuda``), on the CPU its
plain version in torch (``gauss_loop_plain``, one ``gauss_step`` a phase),
reading the samplers' streams from read-aheads (``UniformSampler.
read_ahead``) in the numpy loop's order, committed at the end.  The host
reads the loop's state once a launch (one sync, counted in ``SYNCS``); the
loop returns early only to have the host decide, with the numpy rule on
the same draws, the few lanes whose exp or log result passed within
``MARGIN`` of its threshold, or to read further ahead, and resumes.

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
from .uniform import UniformSampler, u64_to_unit_float

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

    def __init__(self, seed: bytes | None = None, *, device):
        self.base = UniformSampler(seed, device=device)

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

    def sample_device(self, center, std_dev, count: int = 1) -> torch.Tensor:
        """``sample`` on the sampler's device: int64 [count]; ``center``
        and ``std_dev`` are floats or float64 tensors [count] there.  One
        launch of the loop kernel on the card (``gauss_loop``)."""
        dev = self.base.device
        if count == 0:   # no launch: numpy's check alone
            if bool((torch.as_tensor(std_dev) <= 0).any()):
                raise ValueError("standard deviation not positive")
            return torch.empty(0, dtype=torch.int64, device=dev)
        return _draw(_Loop(ROUNDED, count, dev, c=_lanes(center, count, dev),
                           s=_lanes(std_dev, count, dev), rounded=self.base))


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

    def __init__(self, std_dev: float, seed: bytes | None = None, *, device):
        self.base = UniformSampler(seed, device=device)
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

    def __init__(self, seed: bytes | None = None, *, device):
        self.base = UniformSampler(seed, device=device)
        self.rounded = RoundedGaussianSampler(
            seed if seed is None else seed + b"r", device=device)

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

    def sample_device(self, center, std_dev) -> torch.Tensor:
        """``sample`` on the sampler's device: centers float64 [n] there,
        ``std_dev`` a float or float64 [n]; int64 [n].  One launch of the
        loop kernel on the card (``gauss_loop``)."""
        dev = self.base.device
        c = center.to(torch.float64).reshape(-1)
        n = c.shape[0]
        if n == 0:
            return torch.empty(0, dtype=torch.int64, device=dev)
        c_int = torch.round(c)
        return _draw(_Loop(COSAC_CALL, n, dev, c=c_int, cf=c_int - c,
                           s=_lanes(std_dev, n, dev), base=self.base,
                           rounded=self.rounded.base))


# ------------------------------------------------------ device loop steps

ZIG, WEDGE, TAIL, DIRECT, COSAC, ROUND = range(6)
OPS = ("zig", "wedge", "tail", "direct", "cosac", "round")
# relative margin around a decision or rounding that went through exp or
# log: lanes within it are decided on the host with the numpy rule.  The
# card's and numpy's exp and log differ by 1-2 ulp (2^-52 relative); 2^-40
# leaves room for the few ulp they pick up on the way to the comparison.
MARGIN = 2.0 ** -40
_TINY = 2.0 ** -1000
SQRT_2PI = float(np.sqrt(2 * math.pi))   # numpy's, as the COSAC rule has it
SYNCS = 0   # host syncs of the loop: one status read a launch, one a settle
CALLS = EXITS = 0   # sample_device calls through the loop, and their exits

# slots of the kernel's int64 header (csrc/gaussian.cu H_*)
(H_N, H_R, H_R2, H_IDX, H_X, H_SRC, H_CF, H_S, H_CENTER, H_TAB, H_OUTF,
 H_OUTI, H_DEC, H_CNT, H_MARGIN, H_INV_RN, H_SQ2PI, H_LEN) = range(18)

_TABLES = {}   # device -> int64 [384]: kn, then wn and fn as float64 bits


def _lanes(v, n: int, dev) -> torch.Tensor:
    """A float or a float64 tensor -> contiguous float64 [n] on ``dev``."""
    t = torch.as_tensor(v, dtype=torch.float64, device=dev).reshape(-1)
    return t.expand(n).contiguous() if t.numel() == 1 else t.contiguous()


def _settle(dec: torch.Tensor, n_flag: int, rule, *ins):
    """Decide the ``n_flag`` flagged lanes of ``dec`` (2) on the host:
    ``rule`` gets each input's flagged entries as numpy arrays and returns
    (accept bool [k], value [k] or None); ``dec`` takes the decisions.
    Returns (the flagged lanes' indices, accept, value)."""
    global SYNCS
    SYNCS += 1
    fi = torch.nonzero(dec == 2).reshape(-1)
    ok, val = rule(*[None if t is None else t[fi].cpu().numpy() for t in ins])
    dec[fi] = torch.from_numpy(ok.astype(np.int8)).to(dec.device)
    return fi, ok, val


def _unit_np(raw: np.ndarray) -> np.ndarray:
    """``sample_float``'s map of raw uint64 bits (int64) to [0, 1)."""
    r = raw.view(np.uint64) % np.uint64(1 << FLOAT_PREC)
    bits = r | np.uint64((1023 + FLOAT_PREC) << FLOAT_PREC)
    return bits.view(np.float64) / float(1 << FLOAT_PREC) - 1.0


def _x_np(x: np.ndarray, src: np.ndarray) -> np.ndarray:
    """numpy's norm_float value: x itself, or for a tail lane the tail's
    ``tu`` recomputed from its draw with the sign x carries."""
    if src is None:
        return x
    tail = src >= 0
    if not tail.any():
        return x
    tu = -np.log(np.where(tail, src, 0.5)) * (1.0 / RN) + RN
    return np.where(tail, np.where(x < 0, -tu, tu), x)


def _wedge_host(u, r, x):
    i = (r.view(np.uint64) % np.uint64(BLOCK_SIZE)).astype(np.int64)
    f0, f1 = _FN[i - 1], _FN[i]
    return _unit_np(u) * (f0 - f1) < _normal(x) - f1, None


def _tail_host(fa, fb):
    uu = -np.log(_unit_np(fa)) * (1.0 / RN)
    vv = -np.log(_unit_np(fb))
    return vv + vv >= uu * uu, None


def _direct_host(r, c_frac, s):
    return _unit_np(r) < np.exp(-(c_frac ** 2) / (2 * s ** 2)) / (
        np.sqrt(2 * math.pi) * s), None


def _cosac_host(x, src, bits, rr, sf, cf):
    y = sf * _x_np(x, src)
    b = bits.view(np.uint64) & np.uint64(1)
    y_round = np.where(b == 0, np.round(y) - 1, np.round(y) + 1)
    cmp = np.where(b == 0, y_round <= 0.5, y_round >= -0.5)
    acc_p = np.exp(-((y_round + cf) ** 2 - y * y) / (2 * sf * sf))
    return cmp & (_unit_np(rr) < acc_p), y_round


def _round_host(x, src, c, s):
    return np.zeros(len(x), dtype=bool), np.round(
        c + _x_np(x, src) * s).astype(np.int64)


def _tables(dev) -> torch.Tensor:
    t = _TABLES.get(dev)
    if t is None:
        t = torch.from_numpy(np.concatenate([
            _KN.view(np.int64), _WN.view(np.int64),
            _FN.view(np.int64)])).to(dev)
        _TABLES[dev] = t
    return t


def _near(p, q, scale):
    return (p - q).abs() <= MARGIN * scale + _TINY


def _near_half(y):
    return ((y - torch.floor(y)) - 0.5).abs() <= MARGIN * y.abs() + _TINY


def _dec(flag, ok):
    return torch.where(flag, 2, ok.to(torch.int64)).to(torch.int8)


def gauss_plain(op: int, n: int, r=None, r2=None, idx=None, x=None,
                src=None, cf=None, s=None, center=None, out=None):
    """Plain version of one loop step (csrc/gaussian.cu states each
    op): the kernel's arithmetic in torch ops, one IEEE rounding per numpy
    operation in numpy's order, the same margin rule, on the inputs'
    device.  Returns (out_f, out_i, dec int8 [n], counts int32 [2]);
    COSAC's out_i is ``out``, written in place at its accepted lanes."""
    out_f = out_i = None
    tab = _tables(next(v for v in (r, x, cf) if v is not None).device)
    kn, wn, fn = tab[:128], tab[128:256].view(torch.float64), \
        tab[256:].view(torch.float64)
    if op == ZIG:
        i = r & (BLOCK_SIZE - 1)
        j = (r >> 7) & ((1 << FLOAT_PREC) - 1)
        mag = j.to(torch.float64)
        out_f = torch.where(r < 0, -mag, mag) * wn[i]
        acc = j < kn[i]
        p, q = ~acc & (i > 0), ~acc & (i == 0)
        dec = torch.where(acc, 0, torch.where(p, 1, 2)).to(torch.int8)
    elif op == WEDGE:
        i = r[idx] & (BLOCK_SIZE - 1)
        xx = x[idx]
        f1 = fn[i]
        lhs = u64_to_unit_float(r2) * (fn[i - 1] - f1)
        e = torch.exp(-0.5 * xx * xx)
        rhs = e - f1
        q = _near(lhs, rhs, e)
        p = ~q & (lhs < rhs)
    elif op == TAIL:
        uu = -torch.log(u64_to_unit_float(r)) * (1.0 / RN)
        vv = -torch.log(u64_to_unit_float(r2))
        lhs, rhs = vv + vv, uu * uu
        q = _near(lhs, rhs, rhs)
        p = ~q & (lhs >= rhs)
        out_f = uu
    elif op == DIRECT:
        e = torch.exp(-(cf * cf) / (2.0 * (s * s)))
        t = e / (SQRT_2PI * s)
        rr = u64_to_unit_float(r)
        q = _near(rr, t, t)
        p = ~q & (rr < t)
        out_i = torch.where(p, center.to(torch.int64), 0)
    elif op == COSAC:
        sf, c = s[idx], cf[idx]
        y = sf * x
        ry = torch.round(y)
        b0 = (r & 1) == 0
        yr = torch.where(b0, ry - 1.0, ry + 1.0)
        cmp = torch.where(b0, yr <= 0.5, yr >= -0.5)
        a1 = yr + c
        acc = torch.exp(-(a1 * a1 - y * y) / ((2.0 * sf) * sf))
        rr = u64_to_unit_float(r2)
        q = cmp & _near(rr, acc, acc)
        if src is not None:
            q = q | ((src >= 0) & _near_half(y))
        p = ~q & cmp & (rr < acc)
        out_f = yr
        lanes = idx[p]
        out[lanes] = (yr[p] + center[lanes]).to(torch.int64)
        out_i = out
    elif op == ROUND:
        v = center + x * s
        q = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
        if src is not None:
            q = (src >= 0) & _near_half(v)
        p = torch.zeros_like(q)
        out_i = torch.round(v).to(torch.int64)
    else:
        raise ValueError(f"gauss: no op {op}")
    if op != ZIG:
        dec = _dec(q, p)
    cnt = torch.stack([p.sum(), q.sum()]).to(torch.int32)
    return out_f, out_i, dec, cnt


def gauss_cuda(op: int, n: int, r=None, r2=None, idx=None, x=None,
               src=None, cf=None, s=None, center=None, out=None):
    """One launch of csrc/gaussian.cu for ``op`` over n lanes, all tensors
    on one card (raw u64 draws as int64, lane indices and ``out`` int64,
    the rest float64).  Returns (out_f, out_i, dec, counts) as
    ``gauss_plain``."""
    ins = dict(r=(r, torch.int64), r2=(r2, torch.int64),
               idx=(idx, torch.int64), x=(x, torch.float64),
               src=(src, torch.float64), cf=(cf, torch.float64),
               s=(s, torch.float64), center=(center, torch.float64),
               out=(out, torch.int64))
    dev = None
    for name, (t, dt) in ins.items():
        if t is not None:
            backend.require(t, dt, name=name)
            if not t.is_cuda:
                raise ValueError(f"gauss: {name} is not on the card")
            dev = t.device if dev is None else dev
    if dev is None or not 0 < n < 1 << 31:
        raise ValueError("gauss: expected lanes on the card")
    hdr = np.zeros(H_LEN, dtype=np.int64)
    hdr[H_N] = n
    for slot, name in ((H_R, "r"), (H_R2, "r2"), (H_IDX, "idx"), (H_X, "x"),
                       (H_SRC, "src"), (H_CF, "cf"), (H_S, "s"),
                       (H_CENTER, "center")):
        if ins[name][0] is not None:
            hdr[slot] = ins[name][0].data_ptr()
    hdr[H_TAB] = _tables(dev).data_ptr()
    out_f = out_i = None
    if op in (ZIG, TAIL, COSAC):
        out_f = torch.empty(n, dtype=torch.float64, device=dev)
        hdr[H_OUTF] = out_f.data_ptr()
    if op in (DIRECT, ROUND):
        out_i = torch.empty(n, dtype=torch.int64, device=dev)
    elif op == COSAC:
        out_i = out
    if out_i is not None:
        hdr[H_OUTI] = out_i.data_ptr()
    dec = torch.empty(n, dtype=torch.int8, device=dev)
    cnt = torch.empty(2, dtype=torch.int32, device=dev)   # zeroed by the launch
    hdr[H_DEC] = dec.data_ptr()
    hdr[H_CNT] = cnt.data_ptr()
    hdr[H_MARGIN:H_SQ2PI + 1] = np.array(
        [MARGIN, 1.0 / RN, SQRT_2PI], dtype=np.float64).view(np.int64)
    err = backend.lib().ringo_gauss(op, hdr.ctypes.data, backend.stream_ptr(dec))
    backend.check(err, f"gauss {OPS[op]}")
    backend.LAUNCHES["gauss"] += 1
    return out_f, out_i, dec, cnt


def gauss_step(op: int, n: int, **ins):
    """One step of the loop (the per-op unit): the step kernel when the
    inputs lie on the card, the plain version on the CPU."""
    t = next(v for v in ins.values() if v is not None)
    if t.is_cuda:
        return gauss_cuda(op, n, **ins)
    return gauss_plain(op, n, **ins)


# ------------------------------------------- the loop: one launch a call

COSAC_CALL, ROUNDED = range(2)    # what a loop draws
(P_CHECK, P_DIRECT, P_ZIG, P_WEDGE, P_TAIL, P_KEEP, P_COSAC, P_ROUND,
 P_DONE) = range(9)
PHASES = ("check", "direct", "zig", "wedge", "tail", "keep", "cosac",
          "round", "done")
DONE, FLAGGED, EXHAUSTED, BAD_SIGMA = range(4)
STATUSES = ("done", "flagged", "window exhausted", "std_dev not positive")
# slots of the loop's int64 state (csrc/gaussian.cu S_*)
(S_STATUS, S_PHASE, S_STAGE, S_M, S_FILLED, S_NEED, S_NW, S_NT, S_PP, S_TPP,
 S_OFF_B, S_OFF_R, S_WANT, S_NFLAG, S_PHASES, S_BARRIERS, S_ROUNDS, S_GRID,
 S_LEN) = range(19)
# slots of the loop kernel's int64 arguments (csrc/gaussian.cu A_*); the
# state follows them
(A_KIND, A_N, A_C, A_CF, A_S, A_OUT, A_WIN_B, A_START_B, A_LEN_B, A_WIN_R,
 A_START_R, A_LEN_R, A_P, A_TP, A_W, A_X, A_SRC, A_RZ, A_XZ, A_SRCZ, A_ZST,
 A_DEC, A_BLK, A_BLK_CAP, A_ST_OUT, A_TAB, A_MARGIN, A_INV_RN, A_SQ2PI, A_RN,
 A_ST) = range(31)
A_LEN = A_ST + S_LEN
BLK_CAP = 4096   # blocks the loop kernel's count array holds
# stream bytes a lane reads ahead (base, rounded): a COSAC lane takes about
# 5 u64 of the base stream and 2 of the rounded one, a rounded lane about
# 1 (the numpy samplers at the commit's and bfv's sigmas), plus slack.
LANE_BYTES = {COSAC_CALL: (42, 18), ROUNDED: (0, 9)}
WINDOW_SLACK = 1 << 16
LAST = {}   # the last call: launches, exits, phases, barriers, bytes


class _Loop:
    """One ``sample_device`` call: its inputs and output, the pending
    lists (COSAC lanes ``P`` and Ziggurat tail lanes ``TP``, each a
    ping-pong pair; wedge lanes ``W``), the norm_float values ``X`` / ``SRC``,
    the Ziggurat batch (``rz``, ``xz``, ``srcz``, ``zst``), a phase's
    decisions ``dec``, the read-aheads of its streams (0 the base, 1 the
    rounded one) and ``st``, the state (numpy int64 [S_LEN]) that the
    kernel or its plain version advances."""

    def __init__(self, kind: int, n: int, dev, c, s, cf=None, base=None,
                 rounded=None):
        self.kind, self.n, self.dev = kind, n, torch.device(dev)
        self.c, self.cf, self.s = c, cf, s
        self.smp = (base, rounded)
        i64 = lambda *shape: torch.empty(shape, dtype=torch.int64, device=dev)
        f64 = lambda: torch.empty(n, dtype=torch.float64, device=dev)
        self.out = i64(n)
        self.P = i64(2, n) if kind == COSAC_CALL else None
        self.TP, self.W, self.rz = i64(2, n), i64(n), i64(n)
        self.X, self.SRC, self.xz, self.srcz = f64(), f64(), f64(), f64()
        self.zst = torch.empty(n, dtype=torch.int8, device=dev)
        self.dec = torch.empty(n, dtype=torch.int8, device=dev)
        self.st = np.zeros(S_LEN, dtype=np.int64)
        self.st[S_PHASE] = P_DIRECT if kind == COSAC_CALL else P_CHECK
        self.win = [None, None]
        self.used, self.ahead = [0, 0], [0, 0]
        self.blk = self.st_dev = self.st_pin = None   # the kernel's, lazily
        for w in (0, 1):
            if self.smp[w] is not None:
                self.open(w, self.budget(w))

    def budget(self, w: int) -> int:
        return LANE_BYTES[self.kind][w] * self.n + WINDOW_SLACK

    def open(self, w: int, nbytes: int) -> None:
        self.win[w] = self.smp[w].read_ahead(nbytes)
        self.ahead[w] += self.win[w][2]

    def take(self, w: int) -> None:
        """Commit stream w's bytes read so far; its offset goes to 0."""
        slot = S_OFF_B if w == 0 else S_OFF_R
        off = int(self.st[slot])
        self.smp[w].commit(off)
        self.used[w] += off
        self.st[slot] = 0

    def draws(self, w: int, off: int, count: int) -> torch.Tensor:
        """``count`` raw u64 draws (int64) of stream w from byte ``off``
        of its read-ahead."""
        ext, start, _ = self.win[w]
        b = ext[start + off:start + off + 8 * count]
        if b.storage_offset() % 8:     # an int64 view needs 8-byte alignment
            b = b.clone()
        return b.view(torch.int64)


def _draw(L: _Loop) -> torch.Tensor:
    """Drive one call to its end, the same protocol on the card and on
    the CPU: launch (``gauss_loop``), read the state (one sync), then on
    an exit decide the flagged lanes on the host or read further ahead,
    and launch again, the kernel resuming from its state; at the end
    commit both streams.  A std_dev not positive raises before any
    stream is committed, as numpy's check leaves the sampler."""
    global SYNCS, CALLS, EXITS
    CALLS += 1
    launches, exits = 0, []
    while True:
        gauss_loop(L)
        launches += 1
        if L.st_pin is not None:
            torch.cuda.current_stream(L.dev).synchronize()
            L.st[:] = L.st_pin.numpy()
        SYNCS += 1
        status = int(L.st[S_STATUS])
        if status == DONE:
            break
        exits.append(STATUSES[status])
        EXITS += 1
        if status == BAD_SIGMA:
            raise ValueError("standard deviation not positive")
        if status == FLAGGED:
            _settle_phase(L)
        else:
            w = 0 if L.st[S_PHASE] in (P_DIRECT, P_COSAC) else 1
            L.take(w)
            L.open(w, int(L.st[S_WANT]) + L.budget(w))
    for w in (0, 1):
        if L.smp[w] is not None:
            L.take(w)
    LAST.clear()
    LAST.update(lanes=L.n, launches=launches, exits=exits,
                phases=int(L.st[S_PHASES]), barriers=int(L.st[S_BARRIERS]),
                rounds=int(L.st[S_ROUNDS]), grid=int(L.st[S_GRID]),
                used=list(L.used), read_ahead=list(L.ahead))
    return L.out


def _settle_phase(L: _Loop) -> None:
    """The flagged lanes of the phase that exited, decided on the host by
    the numpy rule on the same draws (``_settle``): ``dec`` takes the
    decisions and ``out`` the values; the loop resumes at the phase's
    compaction."""
    st, dev = L.st, L.dev
    ph, k = int(st[S_PHASE]), int(st[S_NFLAG])
    off_b, off_r, n = int(st[S_OFF_B]), int(st[S_OFF_R]), L.n
    if ph == P_DIRECT:
        fi, ok, _ = _settle(L.dec[:n], k, _direct_host, L.draws(0, off_b, n),
                            L.cf, L.s)
        acc = fi[torch.from_numpy(ok).to(dev)]
        L.out[acc] = L.c[acc].to(torch.int64)
    elif ph == P_WEDGE:
        nw = int(st[S_NW])
        w = L.W[:nw]
        _settle(L.dec[:nw], k, _wedge_host, L.draws(1, off_r, nw), L.rz[w],
                L.xz[w])
    elif ph == P_TAIL:
        nt = int(st[S_NT])
        f = L.draws(1, off_r, 2 * nt)
        _settle(L.dec[:nt], k, _tail_host, f[:nt], f[nt:])
    elif ph == P_COSAC:
        m = int(st[S_M])
        pend = L.P[int(st[S_PP]), :m]
        d = L.draws(0, off_b, 2 * m)
        fi, ok, val = _settle(L.dec[:m], k, _cosac_host, L.X[:m], L.SRC[:m],
                              d[:m], d[m:], L.s[pend], L.cf[pend])
        acc = torch.from_numpy(ok).to(dev)
        lanes = pend[fi[acc]]
        L.out[lanes] = (torch.from_numpy(val).to(dev)[acc]
                        + L.c[lanes]).to(torch.int64)
    else:   # P_ROUND
        fi, _, val = _settle(L.dec[:n], k, _round_host, L.X[:n], L.SRC[:n],
                             L.c, L.s)
        L.out[fi] = torch.from_numpy(val).to(dev)


def gauss_loop(L: _Loop) -> None:
    """Run the loop from ``L.st`` until the call is done or must exit:
    the kernel when the call's tensors lie on the card, the plain version
    on the CPU."""
    if L.dev.type == "cuda":
        gauss_loop_cuda(L)
    else:
        gauss_loop_plain(L)


def gauss_loop_plain(L: _Loop) -> None:
    """Plain version of the loop kernel (csrc/gaussian.cu states the
    phases): the same phase machine over L's tensors on their device, one
    ``gauss_step`` a phase (``gauss_plain`` on the CPU), the same read-ahead
    offsets, the same exits (flagged lanes after a phase's decisions, a
    read-ahead too short before a phase's draws, a std_dev not positive)
    and the same resume at the phase and stage ``L.st`` holds; advances
    ``L.st`` as the kernel does, its count of phases too (the grid
    barriers are the kernel's alone)."""
    st, n = L.st, L.n

    def short(w: int, nbytes: int) -> bool:
        if st[S_OFF_B if w == 0 else S_OFF_R] + nbytes <= L.win[w][2]:
            return False
        st[S_STATUS], st[S_WANT] = EXHAUSTED, nbytes
        return True

    def flagged(cnt) -> bool:
        st[S_PHASES] += 1
        k = int(cnt[1])
        if k:
            st[S_STATUS], st[S_NFLAG], st[S_STAGE] = FLAGGED, k, 1
        return k > 0

    def rejected(count: int) -> torch.Tensor:
        return torch.nonzero(L.dec[:count] == 0).reshape(-1)

    while True:
        ph, resume = int(st[S_PHASE]), int(st[S_STAGE]) == 1
        if ph == P_CHECK:
            st[S_PHASES] += 1
            if bool((L.s <= 0).any()):
                st[S_STATUS] = BAD_SIGMA
                return
            st[S_M], st[S_FILLED], st[S_PHASE] = n, 0, P_ZIG
        elif ph == P_DIRECT:
            off = int(st[S_OFF_B])
            if not resume:
                if short(0, 8 * n):
                    return
                _, out_i, dec, cnt = gauss_step(
                    DIRECT, n, r=L.draws(0, off, n), cf=L.cf, s=L.s,
                    center=L.c)
                L.out.copy_(out_i)
                L.dec[:n] = dec
                if flagged(cnt):
                    return
            rej = rejected(n)
            L.P[0, :len(rej)] = rej
            st[S_OFF_B] = off + 8 * n
            st[S_M], st[S_PP], st[S_FILLED], st[S_STAGE] = len(rej), 0, 0, 0
            st[S_PHASE] = P_ZIG if len(rej) else P_DONE
        elif ph == P_ZIG:
            need = int(st[S_M] - st[S_FILLED])
            if short(1, 8 * need):
                return
            off = int(st[S_OFF_R])
            r = L.draws(1, off, need)
            x, _, dec, cnt = gauss_step(ZIG, need, r=r)
            L.rz[:need], L.xz[:need], L.zst[:need] = r, x, dec
            L.srcz[:need] = -1.0
            st[S_PHASES] += 1
            w = torch.nonzero(dec == 1).reshape(-1)
            t = torch.nonzero(dec == 2).reshape(-1)
            L.W[:len(w)], L.TP[0, :len(t)] = w, t
            st[S_OFF_R] = off + 8 * need
            st[S_NEED], st[S_NW], st[S_NT], st[S_TPP] = need, len(w), len(t), 0
            st[S_PHASE] = P_WEDGE if len(w) else P_TAIL if len(t) else P_KEEP
        elif ph == P_WEDGE:
            nw, need, off = int(st[S_NW]), int(st[S_NEED]), int(st[S_OFF_R])
            w = L.W[:nw]
            if not resume:
                if short(1, 8 * nw):
                    return
                _, _, dec, cnt = gauss_step(
                    WEDGE, nw, r=L.rz[:need], idx=w, x=L.xz[:need],
                    r2=L.draws(1, off, nw))
                L.dec[:nw] = dec
                if flagged(cnt):
                    return
            L.zst[w] = torch.where(L.dec[:nw] == 1, 0, 3).to(torch.int8)
            st[S_OFF_R] = off + 8 * nw
            st[S_STAGE] = 0
            st[S_PHASE] = P_TAIL if st[S_NT] else P_KEEP
        elif ph == P_TAIL:
            nt, tpp, off = int(st[S_NT]), int(st[S_TPP]), int(st[S_OFF_R])
            t = L.TP[tpp, :nt]
            if not resume:
                if short(1, 16 * nt):
                    return
                f = L.draws(1, off, 2 * nt)
                uu, _, dec, cnt = gauss_step(TAIL, nt, r=f[:nt], r2=f[nt:])
                tu = uu + RN
                L.xz[t] = torch.where(L.rz[t] < 0, -tu, tu)
                L.srcz[t] = u64_to_unit_float(f[:nt])
                L.dec[:nt] = dec
                if flagged(cnt):
                    return
            rej = rejected(nt)
            L.TP[1 - tpp, :len(rej)] = t[rej]
            st[S_OFF_R] = off + 16 * nt
            st[S_NT], st[S_TPP], st[S_STAGE] = len(rej), 1 - tpp, 0
            st[S_PHASE] = P_TAIL if len(rej) else P_KEEP
        elif ph == P_KEEP:
            need, filled = int(st[S_NEED]), int(st[S_FILLED])
            keep = torch.nonzero(L.zst[:need] != 3).reshape(-1)
            k = len(keep)
            L.X[filled:filled + k] = L.xz[keep]
            L.SRC[filled:filled + k] = L.srcz[keep]
            st[S_PHASES] += 1
            st[S_FILLED] = filled + k
            st[S_PHASE] = (P_ZIG if filled + k < st[S_M] else
                           P_COSAC if L.kind == COSAC_CALL else P_ROUND)
        elif ph == P_COSAC:
            m, pp, off = int(st[S_M]), int(st[S_PP]), int(st[S_OFF_B])
            pend = L.P[pp, :m]
            if not resume:
                if short(0, 16 * m):
                    return
                d = L.draws(0, off, 2 * m)
                _, _, dec, cnt = gauss_step(
                    COSAC, m, idx=pend, x=L.X[:m], src=L.SRC[:m], r=d[:m],
                    r2=d[m:], cf=L.cf, s=L.s, center=L.c, out=L.out)
                L.dec[:m] = dec
                if flagged(cnt):
                    return
            rej = rejected(m)
            L.P[1 - pp, :len(rej)] = pend[rej]
            st[S_OFF_B] = off + 16 * m
            st[S_M], st[S_PP], st[S_STAGE] = len(rej), 1 - pp, 0
            st[S_FILLED] = 0
            st[S_ROUNDS] += 1
            st[S_PHASE] = P_ZIG if len(rej) else P_DONE
        elif ph == P_ROUND:
            if not resume:
                _, out_i, dec, cnt = gauss_step(
                    ROUND, n, x=L.X, src=L.SRC, center=L.c, s=L.s)
                L.out.copy_(out_i)
                L.dec[:n] = dec
                if flagged(cnt):
                    return
            st[S_STAGE] = 0
            st[S_PHASE] = P_DONE
        else:   # P_DONE
            st[S_STATUS] = DONE
            return


def gauss_loop_cuda(L: _Loop) -> None:
    """One cooperative launch of the loop kernel (csrc/gaussian.cu,
    ``ringo_gauss_loop``) over L's tensors on one card, from the state
    ``L.st``; the state it ends in is copied to a pinned host buffer
    (``L.st_pin``) that the caller reads after a sync."""
    ts = dict(c=(L.c, torch.float64), s=(L.s, torch.float64),
              out=(L.out, torch.int64), TP=(L.TP, torch.int64),
              W=(L.W, torch.int64), X=(L.X, torch.float64),
              SRC=(L.SRC, torch.float64), rz=(L.rz, torch.int64),
              xz=(L.xz, torch.float64), srcz=(L.srcz, torch.float64),
              zst=(L.zst, torch.int8), dec=(L.dec, torch.int8))
    if L.kind == COSAC_CALL:
        ts.update(cf=(L.cf, torch.float64), P=(L.P, torch.int64))
    for name, (t, dt) in ts.items():
        backend.require(t, dt, name=name)
        if not t.is_cuda or t.device != L.out.device:
            raise ValueError(f"gauss_loop: {name} is not on the call's card")
        if name not in ("P", "TP") and t.shape[0] != L.n:
            raise ValueError(f"gauss_loop: {name} has not {L.n} lanes")
    if not 0 < L.n < 1 << 31:
        raise ValueError("gauss_loop: lane count out of range")
    dev = L.out.device
    if L.blk is None:
        L.blk = torch.empty(4 * BLK_CAP, dtype=torch.int32, device=dev)
        L.st_dev = torch.empty(S_LEN, dtype=torch.int64, device=dev)
        L.st_pin = torch.empty(S_LEN, dtype=torch.int64, pin_memory=True)
    a = np.zeros(A_LEN, dtype=np.int64)
    a[A_KIND], a[A_N] = L.kind, L.n
    for slot, name in ((A_C, "c"), (A_CF, "cf"), (A_S, "s"), (A_OUT, "out"),
                       (A_P, "P"), (A_TP, "TP"), (A_W, "W"), (A_X, "X"),
                       (A_SRC, "SRC"), (A_RZ, "rz"), (A_XZ, "xz"),
                       (A_SRCZ, "srcz"), (A_ZST, "zst"), (A_DEC, "dec")):
        if name in ts:
            a[slot] = ts[name][0].data_ptr()
    for w, (p_win, p_start, p_len) in enumerate(
            ((A_WIN_B, A_START_B, A_LEN_B), (A_WIN_R, A_START_R, A_LEN_R))):
        if L.win[w] is not None:
            ext, start, avail = L.win[w]
            if not ext.is_cuda or ext.device != dev:
                raise ValueError("gauss_loop: a read-ahead is not on the card")
            a[p_win], a[p_start], a[p_len] = ext.data_ptr(), start, avail
    a[A_BLK], a[A_BLK_CAP] = L.blk.data_ptr(), BLK_CAP
    a[A_ST_OUT] = L.st_dev.data_ptr()
    a[A_TAB] = _tables(dev).data_ptr()
    a[A_MARGIN:A_RN + 1] = np.array([MARGIN, 1.0 / RN, SQRT_2PI, RN],
                                    dtype=np.float64).view(np.int64)
    a[A_ST:] = L.st
    err = backend.lib().ringo_gauss_loop(a.ctypes.data, backend.stream_ptr(L.out))
    backend.check(err, "gauss_loop")
    backend.LAUNCHES["gauss"] += 1
    L.st_pin.copy_(L.st_dev, non_blocking=True)


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
