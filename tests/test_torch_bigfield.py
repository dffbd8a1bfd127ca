"""The launch side of the big-field kernel (csrc/bigfield.cu,
ringo_tpu_torch/fields/bigfield.py) on the CPU, where the kernel cannot
run:

* the seven entry points on CPU tensors run their plain versions and never
  load the kernel library;
* the operand layout the kernel reads (shape, digit and element strides)
  against ``torch.broadcast_tensors`` for every broadcasting caller and for
  sliced views;
* the wrappers' argument checks, and that a wrapper given CPU tensors
  raises instead of falling back; ``launch_args`` hands out the
  wrapper's own header and pointers;
* the kernel's per-lane steps, written out in Python ints as the CUDA
  source runs them (the tree sum's order, the limb chains in two passes),
  against the plain versions on ZP110, ZP255 and ZP880, corner values
  included;
* the word-level mul_mod and reduce_cols kernels step for step (32-bit
  words, carry chains, funnel shifts, truncations) against the plain
  versions at all seven field widths, on the corner planes and on every
  column count and magnitude that changes their path.

Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from ringo_tpu_torch import backend
from ringo_tpu_torch import fields as F
from ringo_tpu_torch.fields import ZP110, ZP255, ZP880, bigfield, limb
from ringo_tpu_torch.ops import horner
from ringo_tpu_torch.ops.bigmul import BigMul

FIELDS = {"zp110": ZP110, "zp255": ZP255, "zp880": ZP880}
# one field of each width the kernel is built for
ALL_FIELDS = {name.lower(): getattr(F, name) for name in (
    "ZP110", "ZP128", "ZP220", "ZP240", "ZP255", "ZP440", "ZP880")}
MASK = 0xFFFF
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(spec, n, seed):
    """n random field elements, then 0, 1, p-1."""
    rng = random.Random(seed)
    return [rng.randrange(spec.p) for _ in range(n)] + [0, 1, spec.p - 1]


def _planes(spec, values):
    return limb.ints_to_digits(values, spec.w)


# ------------------------------------------------ CPU tensors: plain path

def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(backend, "lib", no_library)
    before = backend.LAUNCHES["bigfield"]
    spec = ZP255
    big = BigMul(spec)
    p = spec.p
    xs, ys = _values(spec, 9, 1), list(reversed(_values(spec, 9, 2)))
    x, y = _planes(spec, xs), _planes(spec, ys)
    pd = _planes(spec, [p])

    got = big.mul_mod(x, y)
    assert torch.equal(got, big.mul_mod_plain(x, y))
    assert limb.digits_to_ints(got) == [a * b % p for a, b in zip(xs, ys)]

    rng = np.random.default_rng(3)
    cols = torch.from_numpy(rng.integers(0, 1 << 18, (2 * spec.w + 1, 5)))
    assert torch.equal(big.reduce_cols(cols), big.reduce_cols_plain(cols))

    xt = x.reshape(spec.w, 3, 4)
    got = horner.tree_sum(big, xt)
    assert torch.equal(got, horner.tree_sum_plain(big, xt))
    assert limb.digits_to_ints(got) == [sum(xs[4 * r:4 * r + 4]) % p
                                        for r in range(3)]

    assert limb.digits_to_ints(limb.add(x, y, pd)) == [
        (a + b) % p for a, b in zip(xs, ys)]
    assert torch.equal(limb.add(x, y, pd), limb.add_plain(x, y, pd))
    assert limb.digits_to_ints(limb.sub(x, y, pd)) == [
        (a - b) % p for a, b in zip(xs, ys)]
    assert torch.equal(limb.sub(x, y, pd), limb.sub_plain(x, y, pd))
    assert limb.digits_to_ints(limb.neg(x, pd)) == [(-a) % p for a in xs]
    assert torch.equal(limb.neg(x, pd), limb.neg_plain(x, pd))
    assert limb.geq(x, y).tolist() == [a >= b for a, b in zip(xs, ys)]
    assert torch.equal(limb.geq(x, y), limb.geq_plain(x, y))
    assert backend.LAUNCHES["bigfield"] == before


# ------------------------------------------------------- operand layout

def _w(*shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)


def _layout_cases():
    w = 3
    P = _w(w, 40)                       # a powers table, sliced below
    yield "horner powers [w, m] x [w, 1]", (_w(w, 8), _w(w, 5)[:, 2][:, None])
    yield "horner products [w, t, n] x [w, 1, n]", (_w(w, 2, 16), P[:, None, :16])
    yield "linear [w, a, 1] x [w, 1, b]", (_w(w, 4, 1), _w(w, 1, 6))
    yield "linear sliced v[:, :nv, None] x base[:, None, :]", (
        _w(w, 10)[:, :4, None], _w(w, 5)[:, None, :])
    g = _w(w, 2, 6, 4).transpose(-1, -2)           # [.., n1, n2] transposed
    yield "bigntt_matmul grid, transposed", (g, _w(w, 4, 6).reshape(w, 1, 4, 6))
    yield "bigntt_matmul twist [w, *batch, n] x [w, 1, n]", (
        _w(w, 3, 2, 8), _w(w, 8).reshape(w, 1, 1, 8))
    x = _w(w, 2, 9)
    yield "tree halves x[..., :h], x[..., h:2h], q [w, 1, 1]", (
        x[..., :4], x[..., 4:8], _w(w, 1, 1))
    yield "modsum narrow on a middle axis", (
        _w(w, 7, 3).narrow(1, 0, 3), _w(w, 7, 3).narrow(1, 3, 3), _w(w, 1, 1))
    yield "q [w] against values [w, a, b]", (_w(w, 2, 3), _w(w))
    yield "scalars [w]", (_w(w), _w(w))
    yield "five value dims that merge", (_w(w, 2, 3, 2, 2, 5), _w(w, 1, 1, 1, 1, 5))
    yield "rows of a tree sum x[..., 0]", (_w(w, 3, 5, 7).transpose(1, 2)[..., 0],)


@pytest.mark.parametrize("label,ops", list(_layout_cases()),
                         ids=[c[0] for c in _layout_cases()])
def test_operand_layout_matches_broadcast_tensors(label, ops):
    vshape, n, shape4, per_op = bigfield.operand_layout(*ops)
    want = torch.broadcast_tensors(*(t[0] for t in ops))
    assert vshape == tuple(want[0].shape)
    assert n == want[0].numel()
    assert len(shape4) == bigfield.MAX_DIMS and np.prod(shape4) == n
    for t, (dstride, strides), full in zip(ops, per_op, want):
        assert dstride == t.stride(0)
        got = torch.as_strided(t, [t.shape[0]] + shape4, [dstride] + strides,
                               t.storage_offset())
        ref = torch.stack([t[j].expand(vshape) for j in range(t.shape[0])])
        assert torch.equal(got, ref.reshape([t.shape[0]] + shape4)), label
        assert torch.equal(got[0].reshape(vshape), full)


def test_operand_layout_refuses_more_than_four_dims():
    a = _w(2, 2, 3, 2, 3, 2)
    b = _w(2, 1, 3, 1, 3, 1)        # broadcast on alternate axes: no merge
    with pytest.raises(ValueError, match="dims after merging"):
        bigfield.operand_layout(a, b)


# --------------------------------------------------- wrappers' arguments

@pytest.mark.parametrize("case", ["dtype", "width", "digits", "geq digits",
                                  "cpu tensor"])
def test_wrappers_check_their_arguments(case, monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(backend, "lib", no_library)
    big = BigMul(ZP255)
    x = _planes(ZP255, _values(ZP255, 3, 4))
    pd = _planes(ZP255, [ZP255.p])
    if case == "dtype":
        for fn in (lambda: bigfield.mul_mod_cuda(big, x.to(torch.int32), x),
                   lambda: bigfield.add_cuda(x, x, pd.to(torch.int32)),
                   lambda: bigfield.geq_cuda(x.to(torch.int32), x)):
            with pytest.raises(TypeError, match="int64"):
                fn()
    elif case == "width":
        odd = BigMul(ZP255)
        odd.w = 12
        for fn in (lambda: bigfield.mul_mod_cuda(odd, x, x),
                   lambda: bigfield.reduce_cols_cuda(odd, x),
                   lambda: bigfield.tree_sum_cuda(odd, x)):
            with pytest.raises(ValueError, match="not a field width"):
                fn()
    elif case == "digits":
        for fn in (lambda: bigfield.mul_mod_cuda(big, x[:15], x[:15]),
                   lambda: bigfield.add_cuda(x, x[:15], pd),
                   lambda: bigfield.sub_cuda(x, x, pd[:15]),
                   lambda: bigfield.neg_cuda(x, pd[:15])):
            with pytest.raises(ValueError, match="digit planes"):
                fn()
    elif case == "geq digits":
        with pytest.raises(ValueError, match="expected 16 digit planes, got 3"):
            bigfield.geq_cuda(x, x[:3])
    else:
        # right arguments on the CPU: the wrapper raises, it does not fall back
        for fn in (lambda: bigfield.mul_mod_cuda(big, x, x),
                   lambda: bigfield.reduce_cols_cuda(big, x),
                   lambda: bigfield.tree_sum_cuda(big, x),
                   lambda: bigfield.add_cuda(x, x, pd),
                   lambda: bigfield.sub_cuda(x, x, pd),
                   lambda: bigfield.neg_cuda(x, pd),
                   lambda: bigfield.geq_cuda(x, x)):
            with pytest.raises(ValueError, match="on the card"):
                fn()


@pytest.mark.parametrize("op", ["mul_mod", "reduce_cols", "horner", "powers",
                                "tree_sum"])
def test_launch_args_are_the_wrappers(op, monkeypatch):
    """``launch_args`` (the C entry's arguments for timing it alone) hands
    out the very header the wrapper builds and launches with, and the
    wrapper's operand pointers and sum buffers."""
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(backend, "lib", no_library)
    monkeypatch.setattr(backend, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(bigfield, "_HEADERS", {})
    big, plan = BigMul(ZP255), horner.HornerPlan(ZP255)
    x = _planes(ZP255, _values(ZP255, 5, 7))
    y = x[:, :1]
    steps = plan.steps_for(12345, 8)
    vs = torch.stack([x, x.flip(1)], 1)
    code = {"mul_mod": bigfield.MUL_MOD, "reduce_cols": bigfield.REDUCE_COLS,
            "horner": bigfield.HORNER, "powers": bigfield.POWERS,
            "tree_sum": bigfield.TREE_SUM}[op]
    ts, n, wrapper, ptrs = {
        "mul_mod": ((x, y), 0, lambda: bigfield.mul_mod_cuda(big, x, y),
                    [x.data_ptr(), y.data_ptr(), 0]),
        "reduce_cols": ((x,), 0, lambda: bigfield.reduce_cols_cuda(big, x),
                        [x.data_ptr(), 0, 0]),
        "horner": ((vs, steps), 0, lambda: bigfield.horner_cuda(big, vs, steps),
                   [vs.data_ptr(), steps.data_ptr(), 0]),
        "powers": ((steps,), 8, lambda: bigfield.powers_cuda(big, steps, 8),
                   [0, steps.data_ptr(), 0]),
        "tree_sum": ((x,), 0, lambda: bigfield.tree_sum_cuda(big, x),
                     [x.data_ptr(), 0, 0]),
    }[op]
    hdr, got, scratch, count = bigfield.launch_args(big, code, ts, n)
    assert got == ptrs
    assert hdr[bigfield.H_W] == big.w
    if op in ("mul_mod", "reduce_cols"):
        m = x.shape[0] if op == "reduce_cols" else 0
        np.testing.assert_array_equal(hdr, bigfield.pack(big.w, ts, m=m)[2])
    if op == "horner":
        assert scratch and count
        assert hdr[bigfield.H_PARTS] == bigfield.horner_blocks(big.w, 2, vs.shape[2])
    elif op == "tree_sum":
        assert scratch and count
        assert hdr[bigfield.H_PARTS] == bigfield.sum_parts(1, x.shape[1])
    else:
        assert scratch == count == 0
    with pytest.raises(ValueError, match="on the card"):
        wrapper()
    [cached] = bigfield._HEADERS.values()
    assert cached[0] is hdr
    with pytest.raises(ValueError, match="not mul_mod"):
        bigfield.launch_args(big, bigfield.ADD, (x, x, x))


# ------------------------------------ the kernel's steps in Python ints

def _k_consts(big):
    c = [int(v) for v in big.consts]
    w = big.w
    return c[:w + 2], c[w + 2:2 * w + 4], c[2 * w + 4:]


def _lanes(t):
    """[d, n] planes -> n digit lists."""
    return t.T.tolist()


def _corner_planes(spec, n, seed):
    """Random field elements, 0, 1, p-1 and the all-0xFFFF digit plane."""
    vals = _values(spec, n, seed) + [(1 << (16 * spec.w)) - 1]
    return _planes(spec, vals)


@pytest.mark.parametrize("name,m", [("zp110", 15), ("zp110", 3), ("zp110", 40),
                                    ("zp255", 33), ("zp255", 31),
                                    ("zp880", 111)])
def test_kernel_steps_reduce_cols(name, m):
    """reduce_cols_kernel<W> (the word-level model below): biglinmap's
    count 2w+1, fewer columns than the fold needs, and more than reach the
    kept digits; columns up to 2^23 and the all-0xFFFF ones."""
    spec = FIELDS[name]
    big = BigMul(spec)
    rng = np.random.default_rng(m)
    cols = rng.integers(0, 1 << 23, (m, 10))
    cols[:, 0] = MASK
    cols[:, 1] = 0
    cols = torch.from_numpy(cols)
    want = big.reduce_cols_plain(cols)
    assert [_w_reduce_cols(big, c) for c in _lanes(cols)] == _lanes(want)


# ------------------------- mul_mod and reduce_cols on words, step for step

def _w_pack(digits, n):
    """Digits -> n words, digit j in word j // 2 (__byte_perm(lo, hi,
    0x5410) of two digits < 2^16), zero above."""
    d = list(digits) + [0] * (2 * n - len(digits))
    return [(d[2 * k] & MASK) | (d[2 * k + 1] & MASK) << 16 for k in range(n)]


def _w_consts(big):
    """The kernel's Words: p, mu (w + 2 digits each) and B^(2w-1) mod p (w
    digits) packed by the host entry point."""
    p, mu, bs = _k_consts(big)
    hz = (big.w + 3) // 2
    return _w_pack(p, hz), _w_pack(mu, hz), _w_pack(bs, hz)


def _w_mac(c, a, b):
    """mac: (c2:c1:c0) += a * b as mad.lo.cc, madc.hi.cc, addc."""
    c0, c1, c2 = c
    prod = a * b
    s = c0 + (prod & M32)
    c0, cc = s & M32, s >> 32
    s = c1 + (prod >> 32) + cc
    c1, cc = s & M32, s >> 32
    return c0, c1, (c2 + cc) & M32


def _w_mul(a, b, na, nb, no):
    """mul_words<NA, NB, NO>: product scanning, the top column's low word
    by 32-bit multiply-adds."""
    c, out = (0, 0, 0), []
    for k in range(no):
        for i in range(na):
            j = k - i
            if 0 <= j < nb:
                if k == no - 1:
                    c = ((c[0] + a[i] * b[j]) & M32, c[1], c[2])
                else:
                    c = _w_mac(c, a[i], b[j])
        out.append(c[0])
        c = (c[1], c[2], 0)
    return out


def _w_shr(v, s, no):
    """shr_digits<S>: floor(v / B^S) mod 2^(32 no), __funnelshift_r(lo, hi,
    16) where S is odd."""
    out = []
    for k in range(no):
        o = s // 2 + k
        lo = v[o] if o < len(v) else 0
        if s % 2 == 0:
            out.append(lo)
        else:
            hi = v[o + 1] if o + 1 < len(v) else 0
            out.append(((hi << 32 | lo) >> 16) & M32)
    return out


def _w_keep(v, d):
    """keep_digits<D>: v mod B^D on its ceil(D / 2) words."""
    assert len(v) == (d + 1) // 2
    if d % 2:
        v[d // 2] &= MASK


def _w_sub(a, b, n):
    """sub_words<N>: (a - b) mod 2^(32 n) and the borrow out, in 64-bit."""
    r, borrow = [], 0
    for k in range(n):
        t = (a[k] - b[k] - borrow) & ((1 << 64) - 1)
        r.append(t & M32)
        borrow = t >> 63
    return r, borrow


def _w_barrett(w, z, consts):
    """barrett_words<W>: z (words, zero above) < B^(2w+1) -> w + 2 digits
    in words, the low w the result."""
    p, mu, _ = consts
    h, hq, hz = (w + 1) // 2, (w + 2) // 2, (w + 3) // 2
    zh = _w_shr(z, w - 1, hz)
    q = _w_mul(zh, mu, hz, hz, w + 1)
    qh = _w_shr(q, w + 1, hq)       # q has no word w + 1: w + 1 digits
    qp = _w_mul(qh, p, hq, h, hz)
    zl = [z[k] if k < len(z) else 0 for k in range(hz)]
    r, _ = _w_sub(zl, qp, hz)
    _w_keep(r, w + 2)
    for _ in range(2):
        d, borrow = _w_sub(r, p, hz)
        if not borrow:
            r = d
    return r


def _w_digits(r, w):
    """store_words<W>: the low w digits of the words r."""
    return [(r[j // 2] >> (16 * (j % 2))) & MASK for j in range(w)]


def _w_mul_mod(big, x, y):
    """mul_mod_kernel<W> on one lane's digit lists."""
    w = big.w
    h = (w + 1) // 2
    z = _w_mul(_w_pack(x, h), _w_pack(y, h), h, h, 2 * h)
    return _w_digits(_w_barrett(w, z, _w_consts(big)), w)


def _w_reduce_cols(big, col):
    """reduce_cols_kernel<W> on one lane's column list."""
    w = big.w
    consts = _w_consts(big)
    bs = consts[2]
    S, ND, h = 2 * w - 1, 4 * w, (w + 1) // 2
    m = min(len(col), ND)
    hw = (min(m + 1, ND) - S + 1) // 2 if m + 1 > S else 0
    z, carry = [], 0
    for k in range(2 * w):
        d = [0, 0]
        for half in range(2):
            j = 2 * k + half
            if j < m:
                s = col[j] + carry
                d[half], carry = s & MASK, s >> 16
            elif j == m:
                d[half] = carry & MASK
        z.append(d[0] | d[1] << 16)
    hi = _w_shr(z, S, w + 1)        # z stops at digit S + 2w: 2w + 1 digits
    f = [0] * (w + 1)
    for row in range(w + 1):
        if row < hw:
            up = 0
            for j in range(h):
                if row + j > w:
                    break
                t = hi[row] * bs[j] + f[row + j] + up
                assert t < 1 << 64
                f[row + j], up = t & M32, t >> 32
            if row + h <= w:
                assert f[row + h] == 0
                f[row + h] = up
    zf, cy = [], 0
    for k in range(w + 1):
        lo = z[k] if k < w - 1 else z[k] & MASK if k == w - 1 else 0
        t = lo + f[k] + cy
        zf.append(t & M32)
        cy = t >> 32
    _w_keep(zf, 2 * w + 1)
    return _w_digits(_w_barrett(w, zf, consts), w)


def _w_corners(spec):
    """The corner planes 0, 1, p - 1 and all-0xFFFF (>= p)."""
    return [0, 1, spec.p - 1, (1 << (16 * spec.w)) - 1]


@pytest.mark.parametrize("name", ALL_FIELDS)
def test_kernel_words_mul_mod(name):
    """Every pair of corner planes and a few random field elements."""
    spec = ALL_FIELDS[name]
    big = BigMul(spec)
    corners = _w_corners(spec)
    rng = random.Random(spec.w)
    xs = [a for a in corners for _ in corners] + [rng.randrange(spec.p)
                                                  for _ in range(3)]
    ys = [b for _ in corners for b in corners] + [rng.randrange(1 << (16 * spec.w))
                                                  for _ in range(3)]
    x, y = _planes(spec, xs), _planes(spec, ys)
    want = big.mul_mod_plain(x, y)
    got = [_w_mul_mod(big, a, b) for a, b in zip(_lanes(x), _lanes(y))]
    assert got == _lanes(want)
    assert limb.digits_to_ints(want) == [a * b % spec.p for a, b in zip(xs, ys)]


@pytest.mark.parametrize("name,m", [(n, m) for n in ALL_FIELDS
                                    for m in ("8", "2w-1", "2w", "2w+1", "4w+3")])
def test_kernel_words_reduce_cols(name, m):
    """Columns all 0, all 0xFFFF, all 2^18 - 1, all 2^23 - 1 and two random
    lanes below 2^23, at no fold (m = 8 below 2w - 1), the first fold
    (2w - 1, 2w), BigLinMap's 2w + 1 and more columns than reach the kept
    digits (4w + 3, where the truncation at B^(2w+1) leaves z' != z mod
    B^(2w+1))."""
    spec = ALL_FIELDS[name]
    big, w = BigMul(spec), spec.w
    m = {"8": 8, "2w-1": 2 * w - 1, "2w": 2 * w, "2w+1": 2 * w + 1,
         "4w+3": 4 * w + 3}[m]
    rng = np.random.default_rng(m)
    cols = rng.integers(0, 1 << 23, (m, 6))
    for k, v in enumerate((0, MASK, (1 << 18) - 1, (1 << 23) - 1)):
        cols[:, k] = v
    cols = torch.from_numpy(cols)
    want = big.reduce_cols_plain(cols)
    assert [_w_reduce_cols(big, c) for c in _lanes(cols)] == _lanes(want)


K_FOLD = 1 << 15      # tree_sum_kernel's kFold


def _k_carry(s):
    """carry_digits<N>: column sums (each < 2^32 - 2^16) -> 16-bit digits
    of the same value; the carry out of the top digit must be 0."""
    out, c = [], 0
    for v in s:
        t = v + c
        assert t < 1 << 32
        out.append(t & MASK)
        c = t >> 16
    assert c == 0
    return out


def _k_block_add(vals):
    """block_add<N>: shuffle-down trees of column sums in each warp, then
    over the warps' sums; the result of thread 0, every column < 2^32."""
    def warp(v):
        v = [list(x) for x in v]
        for sh in (16, 8, 4, 2, 1):
            v = [[a + b for a, b in zip(v[l], v[l + sh] if l + sh < 32 else v[l])]
                 for l in range(32)]
        assert max(v[0]) < 1 << 32
        return v[0]
    zero = [0] * len(vals[0])
    sums = [warp(vals[k:k + 32]) for k in range(0, len(vals), 32)]
    return warp(sums + [zero] * (32 - len(sums)))


def _k_tree_sum(big, row, pairs, fold=K_FOLD):
    """tree_sum_kernel on one row of digit lists: each thread's column sums
    of its values' digits (with ``pairs``, lane e of the grid-stride loop
    adds elements 2e and 2e + 1, and the lane whose pair index reaches
    (m - 1) / 2 the odd last element), carried every ``fold`` values and at
    the end; each block's column sums carried into w + 2 digits; the last
    block's sum of the partials carried and reduced by barrett_words."""
    w = big.w
    D, T, m = w + 2, bigfield.SUM_THREADS, len(row)
    parts = bigfield.sum_parts(1, m)

    def add(s, v):
        s = [a + b for a, b in zip(s, list(v) + [0, 0])]
        assert max(s) < 1 << 32
        return s

    partials = []
    for part in range(parts):
        acc = []
        for tid in range(T):
            s, since, e = [0] * D, 0, part * T + tid
            if pairs:
                while 2 * e + 1 < m:
                    s = add(add(s, row[2 * e]), row[2 * e + 1])
                    since += 2
                    if since >= fold:
                        s, since = _k_carry(s), 0
                    e += parts * T
                e = min(2 * e, m)
            for e in range(e, m, parts * T):
                s = add(s, row[e])
                since += 1
                if since >= fold:
                    s, since = _k_carry(s), 0
            acc.append(_k_carry(s))
        partials.append(_k_carry(_k_block_add(acc)))
    acc = [[0] * D for _ in range(T)]
    for tid in range(T):
        for e in range(tid, parts, T):
            acc[tid] = [a + b for a, b in zip(acc[tid], partials[e])]
    s = _k_carry(_k_block_add(acc))
    z = _w_pack(s, (D + 1) // 2)
    return _w_digits(_w_barrett(w, z, _w_consts(big)), w)


@pytest.mark.parametrize("name,m", [("zp110", 1), ("zp110", 2600),
                                    ("zp255", 700), ("zp880", 40),
                                    ("zp255", 2051)])
def test_kernel_steps_tree_sum(name, m):
    """The kernel's column sums of the digits, with pair loads and one by
    one, carried at the kernel's points (and, at a fold of 3 values, far
    more often), and its one reduction mod p give the plain version's
    digits for canonical values (0 and p-1 among them); no column passes
    2^32 and no carry leaves the w + 2 digits."""
    spec = FIELDS[name]
    big = BigMul(spec)
    vals = _values(spec, max(m - 3, 0), m)[-m:]
    x = _planes(spec, vals)
    want = horner.tree_sum_plain(big, x[:, None, :])[:, 0]
    for pairs in (True, False):
        assert _k_tree_sum(big, _lanes(x), pairs) == want.tolist()
        assert _k_tree_sum(big, _lanes(x), pairs, fold=3) == want.tolist()
    assert limb.digits_to_ints(want[:, None]) == [sum(vals) % spec.p]


def _k_limb(op, a, b, q):
    """limb_kernel on one lane: the plain chains in two passes."""
    w = len(a)
    if op == "add":
        carry = borrow = 0
        for j in range(w):
            s = a[j] + b[j] + carry
            carry = s >> 16
            borrow = int((s & MASK) - q[j] - borrow < 0)
        use_d = carry != 0 or borrow == 0
        out, carry, borrow = [], 0, 0
        for j in range(w):
            s = a[j] + b[j] + carry
            carry = s >> 16
            e = (s & MASK) - q[j] - borrow
            borrow = int(e < 0)
            out.append(e & MASK if use_d else s & MASK)
        return out
    if op == "sub":
        borrow = 0
        for j in range(w):
            borrow = int(a[j] - b[j] - borrow < 0)
        fix = borrow != 0
        out, carry, borrow = [], 0, 0
        for j in range(w):
            s = a[j] - b[j] - borrow
            borrow = int(s < 0)
            f = (s & MASK) + q[j] + carry
            carry = f >> 16
            out.append(f & MASK if fix else s & MASK)
        return out
    if op == "neg":
        zero = all(d == 0 for d in a)
        out, borrow = [], 0
        for j in range(w):
            s = q[j] - a[j] - borrow
            borrow = int(s < 0)
            out.append(0 if zero else s & MASK)
        return out
    borrow = 0
    for j in range(w):
        borrow = int(a[j] - b[j] - borrow < 0)
    return borrow == 0


@pytest.mark.parametrize("op", ["add", "sub", "neg", "geq"])
@pytest.mark.parametrize("name", FIELDS)
def test_kernel_steps_limb(op, name):
    spec = FIELDS[name]
    a = _corner_planes(spec, 10, 7)
    b = _corner_planes(spec, 10, 8).flip(1)
    q = _planes(spec, [spec.p])
    qs = q.expand(-1, a.shape[1])
    want = {"add": lambda: limb.add_plain(a, b, q),
            "sub": lambda: limb.sub_plain(a, b, q),
            "neg": lambda: limb.neg_plain(a, q),
            "geq": lambda: limb.geq_plain(a, b)}[op]()
    got = [_k_limb(op, x, y, z)
           for x, y, z in zip(_lanes(a), _lanes(b), _lanes(qs))]
    assert got == (want.tolist() if op == "geq" else _lanes(want))


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__14mul_mod_kernelILi14EEEvNS_4ArgsENS_5WordsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__14mul_mod_kernelILi14EEEvNS_4ArgsENS_5WordsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, 1360 bytes cmem[0]
ptxas info    : Function properties for _ZN4_GLOBAL__11mul_mod_farILi16EEEvRA16_KjS3_RKNS_6ConstsERA16_j
    72 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN4_GLOBAL__18reduce_cols_kernelILi55EEEvNS_4ArgsENS_6ConstsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__18reduce_cols_kernelILi55EEEvNS_4ArgsENS_6ConstsE
    912 bytes stack frame, 32 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 255 registers, 8 bytes lmem, 1024 bytes cmem[0]
"""


def test_parse_ptxas_reads_each_entry():
    """The register log of chip_smoke.py: registers, stack frame, spills
    and lmem of every entry function; out-of-line device functions are
    not entries."""
    got = backend.parse_ptxas(PTXAS_LOG)
    assert got == {
        "_ZN4_GLOBAL__14mul_mod_kernelILi14EEEvNS_4ArgsENS_5WordsE": dict(
            registers=46, stack=0, spill_stores=0, spill_loads=0, lmem=0),
        "_ZN4_GLOBAL__18reduce_cols_kernelILi55EEEvNS_4ArgsENS_6ConstsE": dict(
            registers=255, stack=912, spill_stores=32, spill_loads=32, lmem=8),
    }

