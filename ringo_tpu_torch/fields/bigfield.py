"""The launch side of csrc/bigfield.cu: big-field arithmetic on the card
in one launch per call.

The entry points of fields/limb.py (``add``, ``sub``, ``neg``, ``geq``),
ops/bigmul.py (``BigMul.mul_mod``, ``reduce_cols``) and ops/horner.py
(``tree_sum``) hand a tensor on the card to the wrappers here and keep
their plain versions for the CPU (:func:`on_card`).  A wrapper checks its
arguments, lays its operands out for the kernel (:func:`operand_layout`:
strides, never copies), packs one int64 header, allocates the output with
``torch.empty`` and launches on the current stream.  It reads no device
tensor on the host: the field's constants come from the host ints of
``BigMul`` (``BigMul.consts``), a modulus that arrives as a tensor is read
by the kernel through its pointer.
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
# lanes, m, m's stride, shape[4], out, scratch, parts, then for each of
# three operands its pointer, digit stride and strides[4]
MUL_MOD, REDUCE_COLS, TREE_SUM, ADD, SUB, NEG, GEQ = range(7)
H_OUT, H_SCRATCH, H_PARTS = 8, 9, 10
HEADER_LEN = 11 + 3 * 6

SUM_THREADS = 256          # threads of a tree-sum block
SUM_BLOCKS = 1056          # tree-sum blocks aimed at: 8 per SM of the H100
MAX_PARTS = 1024


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
    ``data_ptr + j * dstride + sum(i * stride)`` elements.  Plain Python
    on shapes and strides: it runs on every launch."""
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
    int64 header).  The output, scratch and parts slots are the caller's."""
    vshape, n, shape4, per_op = operand_layout(*ts)
    if n >= 1 << 31:
        raise ValueError(f"bigfield: {n} lanes; the kernel takes < 2^31")
    hdr = [w, n, m, mstride, *shape4, 0, 0, 0]
    for t, (dstride, strides) in zip(ts, per_op):
        hdr += [t.data_ptr(), dstride, *strides]
    hdr += [0] * (HEADER_LEN - len(hdr))
    return vshape, n, np.array(hdr, dtype=np.int64)


def _launch(op: int, hdr: np.ndarray, cst, like: torch.Tensor, what: str):
    if not like.is_cuda:
        raise ValueError(f"{what}: the kernel takes tensors on the card, "
                         f"got {like.device}")
    err = backend.lib().ringo_bigfield(
        op, hdr.ctypes.data, None if cst is None else cst.ctypes.data,
        backend.stream_ptr(like))
    backend.check(err, f"bigfield {what}")
    backend.LAUNCHES["bigfield"] += 1


def _elementwise(op: int, w: int, ts, cst, what: str, dtype=torch.int64,
                 m: int = 0) -> torch.Tensor:
    """One launch over the broadcast lanes of ``ts`` -> a contiguous
    [w, *value shape] (``geq``: [*value shape] bool)."""
    vshape, n, hdr = pack(w, ts, m=m)
    shape = vshape if dtype == torch.bool else (w,) + vshape
    out = torch.empty(shape, dtype=dtype, device=ts[0].device)
    if n:
        hdr[H_OUT] = out.data_ptr()
        _launch(op, hdr, cst, ts[0], what)
    return out


def mul_mod_cuda(big, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``BigMul.mul_mod`` in one launch: (x * y) mod p, x and y digit
    planes [w, ...] broadcasting against each other."""
    _check_width(big.w, "mul_mod")
    _check((x, y), "mul_mod", big.w)
    return _elementwise(MUL_MOD, big.w, (x, y), big.consts, "mul_mod")


def reduce_cols_cuda(big, cols: torch.Tensor) -> torch.Tensor:
    """``BigMul.reduce_cols`` in one launch: lazy columns [m, ...] ->
    digit planes [w, ...] of their value mod p."""
    _check_width(big.w, "reduce_cols")
    _check((cols,), "reduce_cols")
    m = cols.shape[0]
    if m == 0:
        raise ValueError("reduce_cols: no columns")
    return _elementwise(REDUCE_COLS, big.w, (cols,), big.consts,
                        "reduce_cols", m=m)


def sum_parts(rows: int, m: int) -> int:
    """Partial sums per row of the first tree-sum launch: about
    ``SUM_BLOCKS`` blocks in all, each thread summing at least 4 values."""
    want = max(1, SUM_BLOCKS // max(rows, 1))
    return max(1, min(-(-m // (4 * SUM_THREADS)), want, MAX_PARTS))


def tree_sum_cuda(big, x: torch.Tensor) -> torch.Tensor:
    """``horner.tree_sum``: the sum mod p of canonical digit planes
    [w, ..., m] over the last axis -> [w, ...], in one call (a launch of
    per-block partial sums and one that sums each row's partials)."""
    _check_width(big.w, "tree_sum")
    _check((x,), "tree_sum", big.w)
    if x.dim() < 2 or x.shape[-1] == 0:
        raise ValueError("tree_sum: expected [w, ..., m] with m > 0")
    m = x.shape[-1]
    if m >= 1 << 31:
        raise ValueError(f"tree_sum: {m} values per row; the kernel takes < 2^31")
    vshape, n, hdr = pack(big.w, (x[..., 0],), m=m, mstride=x.stride(-1))
    out = torch.empty((big.w,) + vshape, dtype=torch.int64, device=x.device)
    if n == 0:
        return out
    parts = sum_parts(n, m)
    if n * parts >= 1 << 31:
        raise ValueError(f"tree_sum: {n} rows; too many blocks")
    scratch = torch.empty((big.w, n * parts), dtype=torch.int32, device=x.device)
    hdr[H_OUT], hdr[H_SCRATCH], hdr[H_PARTS] = (out.data_ptr(),
                                                scratch.data_ptr(), parts)
    _launch(TREE_SUM, hdr, big.consts, x, "tree_sum")
    return out


def add_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``limb.add`` in one launch: (a + b) mod q."""
    _check((a, b, q), "add")
    return _elementwise(ADD, a.shape[0], (a, b, q), None, "add")


def sub_cuda(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``limb.sub`` in one launch: (a - b) mod q."""
    _check((a, b, q), "sub")
    return _elementwise(SUB, a.shape[0], (a, b, q), None, "sub")


def neg_cuda(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``limb.neg`` in one launch: (-a) mod q."""
    _check((a, q), "neg")
    return _elementwise(NEG, a.shape[0], (a, q), None, "neg")


def geq_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``limb.geq`` in one launch: a >= b as bool over the broadcast
    lanes; the digit count is the operands' (any, equal for both)."""
    _check((a, b), "geq")
    return _elementwise(GEQ, a.shape[0], (a, b), None, "geq", torch.bool)
