"""The launch side of csrc/bigfield.cu: big-field arithmetic on the card
in one launch per call.

The entry points of fields/limb.py (``add``, ``sub``, ``neg``, ``geq``),
ops/bigmul.py (``BigMul.mul_mod``, ``reduce_cols``) and ops/horner.py
(``tree_sum``, ``HornerPlan.eval_stacked`` and ``powers``) hand a tensor on
the card to the wrappers here and keep their plain versions for the CPU
(:func:`on_card`).  A wrapper checks its arguments, allocates the output
with ``torch.empty`` and makes one ctypes call on the current stream, with
the operands' pointers as arguments.  Everything else the kernel reads
about the call, its layout (:func:`operand_layout`: strides, never
copies), sits in an int64 header that is built once per shapes, strides,
dtypes and devices of the operands and kept (:func:`_header`): a later
call of the same layout passed the same checks and reuses it.  It reads
no device tensor on the host: the field's constants come from the host
ints of ``BigMul`` (``BigMul.consts``), a modulus that arrives as a tensor
is read by the kernel through its pointer.  The tree sum and the Horner
evaluation sum across blocks in the same launch; their partials and
ticket counters live in buffers kept per device and stream
(:func:`_sum_buffers`), which the kernel leaves zeroed for the next call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import backend

# field digit counts the kernel is compiled for: ZP110, ZP128, ZP220,
# ZP240, ZP255, ZP440, ZP880
WIDTHS = (7, 8, 14, 15, 16, 28, 55)
MAX_DIMS = 4

# op codes of csrc/bigfield.cu, and its int64 header (Slot there): w,
# lanes, m, m's stride, shape[4], parts, aux, then for each of three
# operands its digit stride and strides[4] (pointers travel as the call's
# arguments)
MUL_MOD, REDUCE_COLS, TREE_SUM, ADD, SUB, NEG, GEQ, HORNER, POWERS = range(9)
OP_NAMES = ("mul_mod", "reduce_cols", "tree_sum", "add", "sub", "neg", "geq",
            "horner", "powers")
# launches by entry, beside backend.LAUNCHES["bigfield"] (their sum)
CALLS = {name: 0 for name in OP_NAMES}
H_W, H_N, H_M, H_MSTRIDE, H_SHAPE = 0, 1, 2, 3, 4
H_PARTS, H_AUX, H_OPS, H_OP_LEN = 8, 9, 10, 5
HEADER_LEN = H_OPS + 3 * H_OP_LEN

SUM_THREADS = 256          # threads of a tree-sum block
SUM_BLOCKS = 1056          # tree-sum blocks aimed at: 8 per SM of the H100
MAX_PARTS = 1024
HORNER_LANES = 132 * 512   # Horner / powers lanes of a launch, at most
MAX_ROWS = 65535           # Horner rows: the grid's y extent
_CACHE_MAX = 4096          # layouts kept before the cache starts anew


def on_card(t: torch.Tensor) -> bool:
    """Whether a big-field entry point launches the kernel for ``t``: the
    one place the choice is made."""
    return t.is_cuda


def consts(p_ext, mu, bs) -> np.ndarray:
    """The kernel's constants of one field, int64 [3w + 4]: p's digits
    (w + 2), mu's (w + 2), B^(2w-1) mod p's (w)."""
    return np.array(list(p_ext) + list(mu) + list(bs), dtype=np.int64)


def operand_layout(*ts: torch.Tensor):
    """Digit-plane operands [d_k, *v_k] -> (value shape, lanes, shape4,
    [(digit stride, strides4)] per operand).

    The value shapes broadcast as torch broadcasts them; an operand's
    stride is 0 on an axis it broadcasts over.  Axes of size 1 are
    dropped and neighbours that every operand steps through evenly are
    merged, leaving at most four dims, padded in front with size-1 dims:
    element (i0, i1, i2, i3) of operand k, digit j, lies at
    ``data_ptr + j * dstride + sum(i * stride)`` elements."""
    shapes = [t.shape[1:] for t in ts]
    strides = [t.stride()[1:] for t in ts]
    nd = max(len(s) for s in shapes)
    vshape, dims = [], []
    for k in range(nd):
        size, st = 1, []
        for shp, sd in zip(shapes, strides):
            i = k - nd + len(shp)
            if i < 0 or shp[i] == 1:
                st.append(0)
                continue
            if size not in (1, shp[i]):
                raise ValueError(f"bigfield: value shapes {shapes} do not "
                                 "broadcast")
            size = shp[i]
            st.append(sd[i])
        vshape.append(size)
        if size == 1:
            continue
        if dims and all(ps == s * size for ps, s in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * size, st)
        else:
            dims.append((size, st))
    if len(dims) > MAX_DIMS:
        raise ValueError(f"bigfield: operands of value shape {tuple(vshape)} "
                         f"need {len(dims)} dims after merging; the kernel "
                         f"takes {MAX_DIMS}")
    dims = [(1, [0] * len(ts))] * (MAX_DIMS - len(dims)) + dims
    shape4 = [size for size, _ in dims]
    per_op = [(t.stride(0), [st[k] for _, st in dims]) for k, t in enumerate(ts)]
    return tuple(vshape), math.prod(vshape), shape4, per_op


def _check(ts, what: str, digits: int | None = None) -> None:
    """int64 digit planes on one device, each with ``digits`` planes (by
    default the first operand's)."""
    for t in ts:
        if t.dtype != torch.int64:
            raise TypeError(f"{what}: expected int64 digit planes, got {t.dtype}")
        if t.dim() < 1:
            raise ValueError(f"{what}: expected digit planes [w, ...]")
        if t.device != ts[0].device:
            raise ValueError(f"{what}: operands on {ts[0].device} and {t.device}")
    digits = ts[0].shape[0] if digits is None else digits
    for t in ts:
        if t.shape[0] != digits:
            raise ValueError(f"{what}: expected {digits} digit planes, got "
                             f"{t.shape[0]}")


def _check_width(w: int, what: str) -> None:
    if w not in WIDTHS:
        raise ValueError(f"{what}: w = {w} is not a field width of the "
                         f"kernel {WIDTHS}")


def pack(w: int, ts, m: int = 0, mstride: int = 0):
    """The kernel's header for operands ``ts`` -> (value shape, lanes,
    int64 header).  The parts and aux slots are the caller's."""
    vshape, n, shape4, per_op = operand_layout(*ts)
    if n >= 1 << 31:
        raise ValueError(f"bigfield: {n} lanes; the kernel takes < 2^31")
    hdr = [w, n, m, mstride, *shape4] + [0] * (H_OPS - H_SHAPE - MAX_DIMS)
    for dstride, strides in per_op:
        hdr += [dstride, *strides]
    hdr += [0] * (HEADER_LEN - len(hdr))
    return vshape, n, np.array(hdr, dtype=np.int64)


_HEADERS: dict = {}


def _header(key, build):
    """The cached (header, its address, *rest) of a call's layout ``key``
    (shapes, strides, dtypes, devices and sizes of the operands: every
    input of the wrapper's checks); ``build()`` checks the arguments and
    returns (header, *rest) on a miss, or raises."""
    hit = _HEADERS.get(key)
    if hit is None:
        hdr, *rest = build()
        if len(_HEADERS) >= _CACHE_MAX:
            _HEADERS.clear()
        hit = _HEADERS[key] = (hdr, hdr.ctypes.data, *rest)
    return hit


def _key(ts):
    """What the layout and the checks of a call read from its operands."""
    return tuple((t.shape, t.stride(), t.dtype, t.get_device()) for t in ts)


_FN = None


def _launch(op: int, hdr_addr: int, cst_addr, like: torch.Tensor, what: str,
            out: int, a: int, b: int = 0, c: int = 0, sums=None) -> None:
    """One ctypes call of ``ringo_bigfield`` on ``like``'s current stream,
    with the partials and ticket counters of ``sums`` = (rows, words)
    where the op sums across blocks; raises on its CUDA error."""
    global _FN
    if not like.is_cuda:
        raise ValueError(f"{what}: the kernel takes tensors on the card, "
                         f"got {like.device}")
    stream = backend.stream_ptr(like)
    scratch, count = _sum_buffers(like, stream, *sums) if sums else (0, 0)
    if _FN is None:
        _FN = backend.lib().ringo_bigfield
    err = _FN(op, hdr_addr, cst_addr, out, a, b, c, scratch, count, stream)
    backend.check(err, f"bigfield {what}")
    backend.LAUNCHES["bigfield"] += 1
    CALLS[OP_NAMES[op]] += 1


def _elementwise_header(op: int, w: int, ts, what: str, dtype=torch.int64,
                        m: int = 0, digits: int | None = None,
                        width: bool = True):
    """(header, its address, output shape, lanes) of an element-wise op."""
    def build():
        if width:
            _check_width(w, what)
        _check(ts, what, digits)
        if op == REDUCE_COLS and m == 0:
            raise ValueError("reduce_cols: no columns")
        vshape, n, hdr = pack(w, ts, m=m)
        return hdr, (vshape if dtype == torch.bool else (w,) + vshape), n

    return _header((op, w, m, digits, _key(ts)), build)


def _elementwise(op: int, w: int, ts, cst_addr, what: str,
                 dtype=torch.int64, m: int = 0, digits: int | None = None,
                 width: bool = True) -> torch.Tensor:
    """One launch over the broadcast lanes of ``ts`` -> a contiguous
    [w, *value shape] (``geq``: [*value shape] bool)."""
    _, addr, shape, n = _elementwise_header(op, w, ts, what, dtype, m, digits,
                                            width)
    out = torch.empty(shape, dtype=dtype, device=ts[0].device)
    if n:
        _launch(op, addr, cst_addr, ts[0], what, out.data_ptr(),
                *(t.data_ptr() for t in ts))
    return out


def mul_mod_cuda(big, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``BigMul.mul_mod`` in one launch: (x * y) mod p, x and y digit
    planes [w, ...] broadcasting against each other."""
    return _elementwise(MUL_MOD, big.w, (x, y), big.consts_addr, "mul_mod",
                        digits=big.w)


def reduce_cols_cuda(big, cols: torch.Tensor) -> torch.Tensor:
    """``BigMul.reduce_cols`` in one launch: lazy columns [m, ...] ->
    digit planes [w, ...] of their value mod p."""
    return _elementwise(REDUCE_COLS, big.w, (cols,), big.consts_addr,
                        "reduce_cols", m=_digits(cols))


def _digits(a: torch.Tensor) -> int:
    """The digit count of a limb op: its first operand's (0 for a scalar,
    which the checks refuse)."""
    return a.shape[0] if a.dim() else 0


def add_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``limb.add`` in one launch: (a + b) mod q."""
    return _elementwise(ADD, _digits(a), (a, b, q), None, "add", width=False)


def sub_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``limb.sub`` in one launch: (a - b) mod q."""
    return _elementwise(SUB, _digits(a), (a, b, q), None, "sub", width=False)


def neg_cuda(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``limb.neg`` in one launch: (-a) mod q."""
    return _elementwise(NEG, _digits(a), (a, q), None, "neg", width=False)


def geq_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``limb.geq`` in one launch: a >= b as bool over the broadcast
    lanes; the digit count is the operands' (any, equal for both)."""
    return _elementwise(GEQ, _digits(a), (a, b), None, "geq", torch.bool,
                        width=False)


# ------------------------------------------- sums across blocks in one launch

_SUM_BUFFERS: dict = {}


def _sum_buffers(like: torch.Tensor, stream: int, rows: int, words: int):
    """Pointers (partials, ticket counters) of ``like``'s device and this
    stream: int32 buffers of at least ``words`` and ``rows`` elements,
    kept.  The counters start at zero and each launch leaves them so (its
    last block per row resets its row); a launch that grows them frees the
    old ones, which the caching allocator hands out again only behind the
    launches queued on this stream."""
    key = (like.get_device(), stream)
    bufs = _SUM_BUFFERS.get(key)
    if bufs is None or bufs[0].numel() < words or bufs[1].numel() < rows:
        have = (0, 0) if bufs is None else (bufs[0].numel(), bufs[1].numel())
        scratch = torch.empty(max(words, have[0], 1 << 16), dtype=torch.int32,
                              device=like.device)
        count = torch.zeros(max(rows, have[1], 256), dtype=torch.int32,
                            device=like.device)
        bufs = _SUM_BUFFERS[key] = (scratch, count, scratch.data_ptr(),
                                    count.data_ptr())
    return bufs[2], bufs[3]


def sum_parts(rows: int, m: int) -> int:
    """Partial sums per row of a tree sum: about ``SUM_BLOCKS`` blocks in
    all, each thread summing at least 2 values (one 16-byte pair load a
    digit), so that a row's loads are in flight at once."""
    want = max(1, SUM_BLOCKS // max(rows, 1))
    return max(1, min(-(-m // (2 * SUM_THREADS)), want, MAX_PARTS))


def tree_sum_cuda(big, x: torch.Tensor) -> torch.Tensor:
    """``horner.tree_sum``: the sum mod p of canonical digit planes
    [w, ..., m] over the last axis -> [w, ...], in one launch (per-block
    column sums of the digits as w + 2 digits; the last block of each row
    adds the row's partials and reduces the sum mod p).
    Rows whose elements are neighbours in memory, 16-byte aligned at even
    strides, are read in 16-byte pairs."""
    _, addr, shape, n, parts = _tree_sum_header(big, x)
    out = torch.empty(shape, dtype=torch.int64, device=x.device)
    if n:
        _launch(TREE_SUM, addr, big.consts_addr, x, "tree_sum",
                out.data_ptr(), x.data_ptr(),
                sums=(n, (big.w + 2) * n * parts))
    return out


def _tree_sum_header(big, x: torch.Tensor):
    """(header, its address, output shape, rows, partials a row) of a tree
    sum of x."""
    aligned = x.data_ptr() % 16 == 0

    def build():
        _check_width(big.w, "tree_sum")
        _check((x,), "tree_sum", big.w)
        if x.dim() < 2 or x.shape[-1] == 0:
            raise ValueError("tree_sum: expected [w, ..., m] with m > 0")
        m = x.shape[-1]
        if m >= 1 << 31:
            raise ValueError(f"tree_sum: {m} values per row; the kernel "
                             "takes < 2^31")
        vshape, n, hdr = pack(big.w, (x[..., 0],), m=m, mstride=x.stride(-1))
        parts = sum_parts(n, m) if n else 1
        if n * parts >= 1 << 31:
            raise ValueError(f"tree_sum: {n} rows; too many blocks")
        hdr[H_PARTS] = parts
        hdr[H_AUX] = aligned and x.stride(-1) == 1 and all(
            s % 2 == 0 for s in hdr[H_OPS:H_OPS + H_OP_LEN])
        return hdr, (big.w,) + vshape, n, parts

    return _header((TREE_SUM, big.w, aligned, _key((x,))), build)


# ------------------------------------------ Horner's evaluation, the powers

def horner_threads(w: int) -> int:
    """Threads of a Horner or powers block (csrc/bigfield.cu
    ``HORNER_THREADS``): 8 warps, 4 above w = 32."""
    return 128 if w > 32 else 256


def horner_blocks(w: int, rows: int, n: int) -> int:
    """Blocks per row of a Horner or powers launch, a power of two: lane g
    of a row owns coefficients g, g + S, g + 2S, ... (S = blocks x
    threads).  A lane per coefficient where the launch stays within about
    ``HORNER_LANES`` lanes in all rows (the small calls are bound by the
    chain of products a lane waits on), else as many coefficients a lane
    as that cap needs (8 at [16, 1, 2^19]); at least one block."""
    t = horner_threads(w)
    want = max(1, min(n, HORNER_LANES // max(rows, 1)))
    g = 1
    while 2 * g * t <= want:
        g *= 2
    return g


def _check_steps(big, steps: torch.Tensor, n: int, like: torch.Tensor,
                 what: str) -> None:
    """steps: int64 [logn', w] digits of x^(2^k) on ``like``'s device,
    logn' >= max(1, bit length of n - 1)."""
    _check((steps,), what)
    need = max(1, (n - 1).bit_length())
    if steps.dim() != 2 or steps.shape[1] != big.w or steps.shape[0] < need:
        raise ValueError(f"{what}: steps must be [>= {need}, {big.w}] digits "
                         f"of x^(2^k), got {tuple(steps.shape)}")
    if steps.device != like.device:
        raise ValueError(f"{what}: steps on {steps.device}, values on "
                         f"{like.device}")


def _steps_hdr(hdr, steps: torch.Tensor) -> None:
    o = H_OPS + H_OP_LEN
    hdr[H_AUX] = steps.shape[0]
    hdr[o], hdr[o + 1] = steps.stride(1), steps.stride(0)


def _horner_header(big, vs: torch.Tensor, steps: torch.Tensor):
    """(header, its address, rows, blocks a row) of a Horner launch."""
    def build():
        _check_width(big.w, "horner")
        _check((vs,), "horner", big.w)
        if vs.dim() != 3 or vs.shape[1] == 0 or vs.shape[2] == 0:
            raise ValueError("horner: expected vs [w, t, n] with t, n > 0")
        _, t, n = vs.shape
        if t > MAX_ROWS or n >= 1 << 31:
            raise ValueError(f"horner: t = {t}, n = {n}; the kernel takes "
                             f"t <= {MAX_ROWS}, n < 2^31")
        _check_steps(big, steps, n, vs, "horner")
        hdr = np.zeros(HEADER_LEN, dtype=np.int64)
        hdr[H_W], hdr[H_N], hdr[H_M], hdr[H_MSTRIDE] = big.w, t, n, vs.stride(2)
        hdr[H_SHAPE:H_SHAPE + MAX_DIMS] = (1, 1, 1, t)
        hdr[H_OPS], hdr[H_OPS + 4] = vs.stride(0), vs.stride(1)
        _steps_hdr(hdr, steps)
        parts = hdr[H_PARTS] = horner_blocks(big.w, t, n)
        return hdr, t, parts

    return _header((HORNER, big.w, _key((vs, steps))), build)


def horner_cuda(big, vs: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """``HornerPlan.eval_stacked`` in one launch: vs [w, t, n] digit
    planes (any values below B^w, read through their strides), steps
    [logn, w] digits of x^(2^k) (``HornerPlan.steps_for``) -> [w, t]
    canonical digits of sum_i vs[:, r, i] * x^i mod p."""
    _, addr, t, parts = _horner_header(big, vs, steps)
    out = torch.empty((big.w, t), dtype=torch.int64, device=vs.device)
    _launch(HORNER, addr, big.consts_addr, vs, "horner", out.data_ptr(),
            vs.data_ptr(), steps.data_ptr(), sums=(t, big.w * t * parts))
    return out


def _powers_header(big, steps: torch.Tensor, n: int):
    """(header, its address) of a powers launch."""
    def build():
        _check_width(big.w, "powers")
        if not 0 < n < 1 << 31:
            raise ValueError(f"powers: n = {n}; the kernel takes 0 < n < 2^31")
        _check_steps(big, steps, n, steps, "powers")
        hdr = np.zeros(HEADER_LEN, dtype=np.int64)
        hdr[H_W], hdr[H_N], hdr[H_M] = big.w, 1, n
        hdr[H_SHAPE:H_SHAPE + MAX_DIMS] = 1
        _steps_hdr(hdr, steps)
        hdr[H_PARTS] = horner_blocks(big.w, 1, n)
        return (hdr,)

    return _header((POWERS, big.w, n, _key((steps,))), build)


def powers_cuda(big, steps: torch.Tensor, n: int) -> torch.Tensor:
    """``HornerPlan.powers`` in one launch: steps [logn, w] digits of
    x^(2^k) -> [w, n] digit planes of x^0 .. x^(n-1)."""
    addr = _powers_header(big, steps, n)[1]
    out = torch.empty((big.w, n), dtype=torch.int64, device=steps.device)
    _launch(POWERS, addr, big.consts_addr, steps, "powers", out.data_ptr(),
            0, steps.data_ptr())
    return out


def launch_args(big, op: int, ts, n: int = 0) -> tuple:
    """The arguments of ``ringo_bigfield`` that the wrapper of ``op``
    passes for operands ``ts``, all but the output and the stream, for
    timing the C entry alone: ``MUL_MOD`` (x, y), ``REDUCE_COLS`` (cols,),
    ``HORNER`` (vs, steps), ``POWERS`` (steps,) with ``n`` powers,
    ``TREE_SUM`` (x,) ->
    (header, operand pointers [a, b, c], partials, ticket counters); the
    header is the int64 array whose address the wrapper passes."""
    x = ts[0]
    if op == HORNER:
        hdr, _, t, parts = _horner_header(big, *ts)
        return (hdr, [x.data_ptr(), ts[1].data_ptr(), 0],
                *_sum_buffers(x, backend.stream_ptr(x), t, big.w * t * parts))
    if op == POWERS:
        return _powers_header(big, x, n)[0], [0, x.data_ptr(), 0], 0, 0
    if op == TREE_SUM:
        hdr, _, _, rows, parts = _tree_sum_header(big, x)
        return (hdr, [x.data_ptr(), 0, 0],
                *_sum_buffers(x, backend.stream_ptr(x), rows,
                              (big.w + 2) * rows * parts))
    if op == MUL_MOD:
        hit = _elementwise_header(op, big.w, ts, "mul_mod", digits=big.w)
    elif op == REDUCE_COLS:
        hit = _elementwise_header(op, big.w, ts, "reduce_cols", m=_digits(x))
    else:
        raise ValueError(f"launch_args: op {op} is not mul_mod, reduce_cols, "
                         "horner, powers or tree_sum")
    return hit[0], [t.data_ptr() for t in ts] + [0] * (3 - len(ts)), 0, 0
