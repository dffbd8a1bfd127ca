"""Horner's evaluation and the powers of x in one launch (csrc/bigfield.cu
``horner_kernel`` and ``powers_kernel``, fields/bigfield.py ``horner_cuda``
and ``powers_cuda``) on the CPU, where the kernel cannot run:

* a model of the kernels' steps in Python ints, as the CUDA source runs
  them (the shared tables x^l and x^(32m), each block's base x^(bT) by a
  product tree over the step digits, Horner's rule in x^S over a lane's
  coefficients, the lane, warp and block products, the partials and the
  last block's sum), which asserts at every product that barrett_words'
  input stays below B^(2w), held against Horner's rule in Python ints and
  the JAX package's ``HornerPlan`` at every field width, n in {1, 2, 255,
  257, 1000}, t in {1, 3}, x in {0, 1, p - 1, random}, coefficients 0, 1,
  p - 1 and the all-0xFFFF plane, at the launch geometry the wrapper picks
  and at more blocks;
* the kernels' word-level multiply-add (``mul_add_words``: the product on
  32-bit words, the addend's carry, ``barrett_words``) step for step at
  all seven widths, at the extremes the Horner step reaches;
* the plain versions ``eval_stacked_plain`` and ``powers_plain`` against
  the JAX package's ``evaluate_many`` and ``powers`` and Python ints;
* the wrappers with ``bigfield.on_card`` patched true and
  ``bigfield._launch`` counting: one call for ``evaluate_many``, ``powers``
  and ``tree_sum``, the header slots of the new ops, and the argument
  checks.

Exact equality throughout."""

import random

import numpy as np
import pytest
import torch

from ringo_tpu.fields import (ZP110, ZP128, ZP220, ZP240, ZP255, ZP440, ZP880,
                              limb as ref_limb)
from ringo_tpu.ops.horner import HornerPlan as RefHorner
from ringo_tpu_torch import backend
from ringo_tpu_torch.fields import bigfield, limb, spec as port_spec
from ringo_tpu_torch.ops import horner
from ringo_tpu_torch.ops.bigmul import BigMul

from test_torch_bigfield import (ALL_FIELDS, M32, MASK, _w_barrett, _w_consts,
                                 _w_digits, _w_mul, _w_pack)

FIELDS = {"zp110": ZP110, "zp128": ZP128, "zp220": ZP220, "zp240": ZP240,
          "zp255": ZP255, "zp440": ZP440, "zp880": ZP880}
SIZES = (1, 2, 255, 257, 1000)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(spec):
    return port_spec.FieldSpec(p=spec.p, b=spec.b, k=spec.k)


def _points(spec, seed):
    return {"0": 0, "1": 1, "p-1": spec.p - 1,
            "random": random.Random(seed).randrange(spec.p)}


def _coeffs(spec, n, seed, wide=False):
    """n coefficients: 0, 1, p - 1 first (as many as fit), then random
    ones below p; with ``wide`` the last is the all-0xFFFF value (>= p)."""
    rng = random.Random(seed)
    c = ([0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(n)])[:n]
    if wide:
        c[-1] = (1 << (16 * spec.w)) - 1
    return c


def _horner_ints(coeffs, x, p):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def _steps(spec, x, n):
    """x^(2^k) mod p for k < max(1, bit length of n - 1), as ints."""
    return [pow(x, 1 << k, spec.p) for k in range(max(1, (n - 1).bit_length()))]


# ------------------------------------------- the kernels' steps in Python ints

class _Model:
    """The arithmetic the kernels run, in Python ints: every product is
    barrett_words of x * y + a, which must stay below B^(2w)."""

    def __init__(self, spec, steps, T, G):
        self.p, self.w = spec.p, spec.w
        self.steps, self.T, self.G = steps, T, G
        self.lt, self.lg = T.bit_length() - 1, G.bit_length() - 1
        self.lo = [self.pow_bits(l, 0, 5) for l in range(32)]
        self.hi = [self.pow_bits(32 * m, 5, self.lt) for m in range(T // 32)]

    def mul(self, x, y, a=0):
        """mul_add_words<W>: (x * y + a) mod p."""
        top = 1 << (16 * self.w)
        assert 0 <= x < top and 0 <= y < top and 0 <= a < top
        assert x * y + a < top * top
        return (x * y + a) % self.p

    def add(self, a, v):
        """add_mod<W> of canonical values."""
        assert a < self.p and v < self.p
        return (a + v) % self.p

    def step(self, k):
        """load_step: x^(2^k), 1 for k >= logn."""
        return self.steps[k] if k < len(self.steps) else 1

    def pow_bits(self, e, b0, b1):
        v = 1
        for k in range(b0, b1):
            if e >> k & 1:
                v = self.mul(v, self.step(k))
        return v

    def base(self, b):
        """Warp 1 of build_tables: factors x^(2^(lt + j)) for the set bits
        j of b, then the shuffle product tree into lane 0."""
        f = [self.step(self.lt + j) if j < self.lg and b >> j & 1 else 1
             for j in range(32)]
        sh = 1
        while sh < self.lg:
            for lane in range(0, 32, 2 * sh):
                if lane + sh < self.lg:
                    f[lane] = self.mul(f[lane], f[lane + sh])
            sh *= 2
        return f[0]

    def horner(self, v):
        """horner_kernel on one row of coefficients (ints < B^w)."""
        T, G, n = self.T, self.G, len(v)
        S = T * G
        parts = []
        for b in range(G):
            warp_parts = []
            for warp in range(T // 32):
                s = 0
                for lane in range(32):
                    g = b * T + 32 * warp + lane
                    acc = 0
                    if g < n:
                        k = (n - 1 - g) // S
                        acc = v[g + k * S]
                        for kk in range(k - 1, -1, -1):
                            acc = self.mul(acc, self.step(self.lt + self.lg),
                                           v[g + kk * S])
                    s = self.add(s, self.mul(acc, self.lo[lane]))
                warp_parts.append(self.mul(s, self.hi[warp]))
            s = 0
            for wp in warp_parts:
                s = self.add(s, wp)
            parts.append(self.mul(s, self.base(b)))
        s = 0                                  # the last block: finish_row
        for part in parts:
            s = self.add(s, part)
        return s

    def powers(self, n):
        """powers_kernel: x^g from the tables, then one product a step."""
        T, G = self.T, self.G
        S, out = T * G, [None] * n
        u = self.step(self.lt + self.lg)
        for b in range(G):
            base = self.base(b)
            for tid in range(T):
                g = b * T + tid
                if g >= n:
                    continue
                v = self.mul(self.mul(self.lo[tid & 31], self.hi[tid >> 5]), base)
                for i in range(g, n, S):
                    if i > g:
                        v = self.mul(v, u)
                    out[i] = v
        return out


def _geometries(w, t, n):
    """(threads, blocks): the wrapper's launch, one block (up to 8
    coefficients a lane at n = 1000) and more blocks (block bases from the
    product tree; lanes past n)."""
    T = bigfield.horner_threads(w)
    return [(T, bigfield.horner_blocks(w, t, n)), (T, 1), (T, 2), (T, 16)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", FIELDS)
def test_kernel_steps_horner_and_powers(name, n):
    spec = FIELDS[name]
    for i, (label, x) in enumerate(_points(spec, n).items()):
        t = 3 if i % 2 else 1
        rows = [_coeffs(spec, n, 10 * n + r, wide=r == 1) for r in range(t)]
        steps = _steps(spec, x, n)
        want = [_horner_ints(c, x, spec.p) for c in rows]
        want_pw = [pow(x, i, spec.p) for i in range(n)]
        for T, G in _geometries(spec.w, t, n):
            m = _Model(spec, steps, T, G)
            assert [m.horner(c) for c in rows] == want, (label, T, G)
            assert m.powers(n) == want_pw, (label, T, G)


def _w_mul_add(big, x, y, v):
    """mul_add_words<W, true> of csrc/bigfield.cu on one lane's digit
    lists: mul_words into 2H words, v's H words added into the low ones
    with the carry up to the top word, barrett_words, the low H words."""
    w = big.w
    h = (w + 1) // 2
    z = _w_mul(_w_pack(x, h), _w_pack(y, h), h, h, 2 * h)
    vw, cy = _w_pack(v, h), 0
    for k in range(2 * h):
        t = z[k] + (vw[k] if k < h else 0) + cy
        z[k], cy = t & M32, t >> 32
    assert cy == 0
    return _w_digits(_w_barrett(w, z, _w_consts(big))[:h], w)


@pytest.mark.parametrize("name", ALL_FIELDS)
def test_kernel_words_mul_add_mod(name):
    """The Horner step acc * u + v on words at the extremes it reaches: acc
    and v the all-0xFFFF value (the first coefficient enters unreduced),
    u = p - 1, all three all-0xFFFF, 0 and 1, and random ones."""
    spec = ALL_FIELDS[name]
    big = BigMul(spec)
    top = (1 << (16 * spec.w)) - 1
    rng = random.Random(spec.w)
    cases = [(top, spec.p - 1, top), (top, top, top), (0, spec.p - 1, top),
             (top, spec.p - 1, 0), (1, 1, 0), (0, 0, 0)] + [
        (rng.randrange(top), rng.randrange(spec.p), rng.randrange(top))
        for _ in range(8)]
    digits = lambda v: [(v >> (16 * j)) & MASK for j in range(spec.w)]
    for x, y, a in cases:
        got = _w_mul_add(big, digits(x), digits(y), digits(a))
        assert got == digits((x * y + a) % spec.p), (x, y, a)


# ------------------------------------------------- the plain versions

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", FIELDS)
def test_plain_versions_match_jax_and_ints(name, n):
    spec = FIELDS[name]
    points = list(_points(spec, n).items())
    i = SIZES.index(n)
    label, x = points[i % 4]
    t = 3 if i % 2 else 1
    rows = [_coeffs(spec, n - r, 20 * n + r, wide=r == 1) for r in range(t)]
    rows = [c for c in rows if c] or [[1]]
    vs = [ref_limb.ints_to_digits(c, spec.w) for c in rows]
    plan, ref = horner.HornerPlan(_port(spec)), RefHorner(spec)
    nmax = max(len(c) for c in rows)
    got = plan.eval_stacked_plain(plan.stack_inputs(vs, nmax, "cpu"),
                                  plan.steps_for(x, nmax))
    got = limb.digits_to_ints(got)
    assert got == [_horner_ints(c, x, spec.p) for c in rows], label
    assert got == ref.evaluate_many(vs, x), label
    np.testing.assert_array_equal(plan.steps_for(x, n).numpy(),
                                  ref.steps_for(x, n))
    pw = plan.powers_plain(plan.steps_for(x, n), n)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(ref.powers(x, n)))
    assert limb.digits_to_ints(pw) == [pow(x, k, spec.p) for k in range(n)]


# ------------------------------------------------------- the wrappers

@pytest.fixture
def card(monkeypatch):
    """on_card true for any tensor, and _launch recording its calls (op,
    header, pointers) instead of launching."""
    calls = []

    def launch(op, addr, cst, like, what, out, a, b=0, c=0, sums=None):
        hdr = next(h for h, ad, *_ in bigfield._HEADERS.values() if ad == addr)
        calls.append(dict(op=op, hdr=hdr.copy(), cst=cst, out=out, ptrs=(a, b, c),
                          sums=sums))

    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(bigfield, "on_card", lambda t: True)
    monkeypatch.setattr(bigfield, "_launch", launch)
    monkeypatch.setattr(backend, "lib", no_library)
    return calls


def _planes(spec, values):
    return limb.ints_to_digits(values, spec.w)


def test_card_path_makes_one_call_each(card):
    spec = _port(ZP255)
    plan = horner.HornerPlan(spec)
    x = 0x1234567890ABCDEF
    vs = [_planes(spec, _coeffs(spec, 1000, 1)), _planes(spec, _coeffs(spec, 7, 2))]
    plan.evaluate_many(vs, x, "cpu")
    assert [c["op"] for c in card] == [bigfield.HORNER]
    plan.powers(x, 300, "cpu")
    assert [c["op"] for c in card[1:]] == [bigfield.POWERS]
    horner.tree_sum(plan.big, _planes(spec, _coeffs(spec, 40, 3)).reshape(16, 4, 10))
    assert [c["op"] for c in card[2:]] == [bigfield.TREE_SUM]
    assert all(c["cst"] == plan.big.consts_addr for c in card)


@pytest.mark.parametrize("name,t,n", [("zp255", 1, 1000), ("zp220", 4, 3000),
                                      ("zp880", 3, 257), ("zp110", 1, 1)])
def test_horner_header_slots(card, name, t, n):
    spec = _port(FIELDS[name])
    plan = horner.HornerPlan(spec)
    w = spec.w
    full = torch.zeros((w, t + 2, n + 5), dtype=torch.int64)
    vs = full[:, 1:t + 1, 2:n + 2]                 # a sliced view
    steps = plan.steps_for(12345, n)
    plan.eval_stacked(vs, steps)
    (c,) = card
    h = c["hdr"]
    G = bigfield.horner_blocks(w, t, n)
    assert G & (G - 1) == 0 and G >= 1
    assert h[bigfield.H_W] == w and h[bigfield.H_N] == t and h[bigfield.H_M] == n
    assert h[bigfield.H_MSTRIDE] == 1
    assert list(h[bigfield.H_SHAPE:bigfield.H_SHAPE + 4]) == [1, 1, 1, t]
    assert h[bigfield.H_PARTS] == G
    assert h[bigfield.H_AUX] == steps.shape[0] == max(1, (n - 1).bit_length())
    o0, o1 = bigfield.H_OPS, bigfield.H_OPS + bigfield.H_OP_LEN
    assert (h[o0], h[o0 + 4]) == (full.stride(0), full.stride(1))
    assert (h[o1], h[o1 + 1]) == (1, w)
    assert c["ptrs"] == (vs.data_ptr(), steps.data_ptr(), 0)
    assert c["sums"] == (t, w * t * G)

    plan.powers(12345, n, "cpu")
    h = card[1]["hdr"]
    assert h[bigfield.H_M] == n and h[bigfield.H_N] == 1
    assert h[bigfield.H_PARTS] == bigfield.horner_blocks(w, 1, n)
    assert h[bigfield.H_AUX] == max(1, (n - 1).bit_length())
    assert card[1]["ptrs"][0] == 0 and card[1]["sums"] is None


def test_launch_geometry():
    """Blocks per row: a power of two, a lane per coefficient up to about
    HORNER_LANES lanes in all rows, at least one block."""
    assert bigfield.horner_blocks(16, 1, 1 << 19) == 256     # 8 a lane
    assert bigfield.horner_blocks(14, 4, 1 << 15) == 64      # 2 a lane
    assert bigfield.horner_blocks(14, 43, 1 << 15) == 4
    assert bigfield.horner_blocks(14, 1, 1 << 15) == 128     # 1 a lane
    assert bigfield.horner_blocks(55, 1, 1 << 15) == 256     # 128 threads
    assert bigfield.horner_blocks(16, 1, 1000) == 2
    assert bigfield.horner_blocks(16, 1, 1) == 1
    assert bigfield.horner_threads(55) == 128 and bigfield.horner_threads(28) == 256


@pytest.mark.parametrize("pairs", [True, False])
def test_tree_sum_header_pairs(card, pairs):
    """16-byte pair loads for rows whose elements are neighbours; a
    transposed view is read one by one."""
    spec = _port(ZP255)
    big = BigMul(spec)
    x = torch.zeros((16, 6, 20), dtype=torch.int64)
    horner.tree_sum(big, x if pairs else x.transpose(1, 2))
    h = card[0]["hdr"]
    assert h[bigfield.H_AUX] == pairs
    assert h[bigfield.H_MSTRIDE] == (1 if pairs else 20)
    assert card[0]["sums"][0] == (6 if pairs else 20)


@pytest.mark.parametrize("case", ["dtype", "width", "digits", "rank", "steps",
                                  "steps width", "empty", "cpu tensor"])
def test_new_wrappers_check_their_arguments(case, monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(backend, "lib", no_library)
    spec = _port(ZP255)
    plan = horner.HornerPlan(spec)
    big = plan.big
    vs = torch.zeros((16, 2, 100), dtype=torch.int64)
    steps = plan.steps_for(5, 100)
    if case == "dtype":
        for fn in (lambda: bigfield.horner_cuda(big, vs.to(torch.int32), steps),
                   lambda: bigfield.powers_cuda(big, steps.to(torch.int32), 100)):
            with pytest.raises(TypeError, match="int64"):
                fn()
    elif case == "width":
        odd = BigMul(spec)
        odd.w = 12
        for fn in (lambda: bigfield.horner_cuda(odd, vs, steps),
                   lambda: bigfield.powers_cuda(odd, steps, 100)):
            with pytest.raises(ValueError, match="not a field width"):
                fn()
    elif case == "digits":
        with pytest.raises(ValueError, match="digit planes"):
            bigfield.horner_cuda(big, vs[:15], steps)
    elif case == "rank":
        with pytest.raises(ValueError, match=r"vs \[w, t, n\]"):
            bigfield.horner_cuda(big, vs[:, 0], steps)
    elif case == "steps":
        for fn in (lambda: bigfield.horner_cuda(big, vs, steps[:6]),
                   lambda: bigfield.powers_cuda(big, steps[:6], 100)):
            with pytest.raises(ValueError, match="steps must be"):
                fn()
    elif case == "steps width":
        with pytest.raises(ValueError, match="steps must be"):
            bigfield.horner_cuda(big, vs, steps[:, :15])
    elif case == "empty":
        with pytest.raises(ValueError, match="t, n > 0"):
            bigfield.horner_cuda(big, vs[:, :, :0], steps)
        with pytest.raises(ValueError, match="0 < n"):
            bigfield.powers_cuda(big, steps, 0)
    else:
        # right arguments on the CPU: the wrapper raises, it does not fall back
        for fn in (lambda: bigfield.horner_cuda(big, vs, steps),
                   lambda: bigfield.powers_cuda(big, steps, 100),
                   lambda: bigfield.tree_sum_cuda(big, vs)):
            with pytest.raises(ValueError, match="on the card"):
                fn()


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    """eval_stacked and powers on CPU tensors: the plain versions, no
    launch and no library."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(backend, "lib", no_library)
    before = backend.LAUNCHES["bigfield"]
    spec = _port(ZP220)
    plan = horner.HornerPlan(spec)
    x = 987654321
    rows = [_coeffs(spec, 300, 7), _coeffs(spec, 300, 8, wide=True)]
    vs = torch.stack([_planes(spec, c) for c in rows], dim=1)
    steps = plan.steps_for(x, 300)
    got = plan.eval_stacked(vs, steps)
    assert torch.equal(got, plan.eval_stacked_plain(vs, steps))
    assert limb.digits_to_ints(got) == [_horner_ints(c, x, spec.p) for c in rows]
    assert torch.equal(plan.powers(x, 300, "cpu"), plan.powers_plain(steps, 300))
    assert backend.LAUNCHES["bigfield"] == before
