"""Big-field NTT as a recursive four-step over byte-plane matrix products.

Structure (cyclic, natural in and out, true DFT order inside):

    X[k2 + n2*k1] = sum_{i1} (w^{n2})^{i1 k1} * [ w^{i1 k2} *
                    NTT_{n2}(x[i1 + n1*:])[k2] ]

* the radix-``leaf`` DFT blocks are one ops/biglinmap.BigLinMap product
  each; every level shares the block, since all sub-roots are the
  canonical g^(n/leaf);
* the twiddle grids w^(i1*k2) between levels are elementwise Barrett
  products (ops/bigmul.py): log_leaf(n) - 1 of them, not log2(n)
  butterfly stages;
* negacyclic transforms twist by psi^i first and untwist and scale last;
* a final gather puts the result into ops/bigntt.BigNTTDev's output order,
  found once per plan by running the stage recurrence on an impulse in
  Python ints, so the two engines are interchangeable bit for bit.

``make_device_plan`` picks the engine as the JAX package does: this one
for fields of 14 digits or more at n >= 256, the stage engine otherwise;
``RINGO_BIG_NTT=stage|matmul`` forces one (``auto`` is the default).
Both engines are plain PyTorch.  Counterpart of
``ringo_tpu.ops.bigntt_matmul``; equal outputs (tests/test_torch_bigntt.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import backend
from ..fields import limb
from ..fields.spec import FieldSpec
from . import ntt as nttmod
from .biglinmap import BigLinMap
from .bigmul import BigMul
from .bigntt import BigNTTDev


def engine_mode() -> str:
    """``RINGO_BIG_NTT``: "auto" (the default), "stage" or "matmul"."""
    mode = os.environ.get("RINGO_BIG_NTT", "auto")
    if mode not in ("auto", "stage", "matmul"):
        raise ValueError(f"RINGO_BIG_NTT={mode!r}: expected auto|stage|matmul")
    return mode


def make_device_plan(spec: FieldSpec, n: int, negacyclic: bool,
                     leaf: int | None = None, device=None):
    """The NTT plan of a big-field ring: ``MatmulBigNTT`` for wide fields at
    meaningful ranks, ``BigNTTDev`` otherwise; ``RINGO_BIG_NTT`` forces one."""
    mode = engine_mode()
    if mode == "matmul" or (mode == "auto" and spec.w >= 14 and n >= 256):
        return MatmulBigNTT(spec, n, negacyclic, leaf=leaf, device=device)
    return BigNTTDev(spec, n, negacyclic, device=device)


def _default_leaf(spec: FieldSpec) -> int:
    """Largest power-of-two block <= 32 that passes BigLinMap's exact-
    accumulation guards for this digit width."""
    leaf = 32
    while leaf > 2 and 255 * 255 * (2 * spec.w) * leaf >= 1 << 31:
        leaf //= 2
    return leaf


def _simulate_engine_order(spec: FieldSpec, n: int, negacyclic: bool,
                           tw: list[int], root: int) -> np.ndarray:
    """Run the BigNTTDev stage recurrence on the impulse delta_1 in Python
    ints (sparse: about 2n products) and return perm with
    engine_out[j] = X_true[perm[j]], where X_true[k] = x(root^k) (cyclic)
    or x(root^(2k+1)) (negacyclic, root of order 2n), natural k."""
    p = spec.p
    x = [0] * n
    x[1] = 1
    m = 1
    while m <= n // 2:
        t = n // (2 * m)
        nxt = [0] * n
        for blk in range(m):
            twm = tw[m + blk]
            for j in range(t):
                u = x[blk * 2 * t + j]
                v = x[blk * 2 * t + t + j]
                vw = v * twm % p if v else 0
                nxt[blk * 2 * t + j] = (u + vw) % p
                nxt[blk * 2 * t + t + j] = (u - vw) % p
        x = nxt
        m <<= 1
    pos = {}
    if negacyclic:
        acc, step = root % p, root * root % p
        for k in range(n):
            pos[acc] = k                     # root^(2k+1)
            acc = acc * step % p
    else:
        acc = 1
        for k in range(n):
            pos[acc] = k                     # root^k
            acc = acc * root % p
    return np.array([pos[v] for v in x], dtype=np.int64)


class MatmulBigNTT:
    """Drop-in for BigNTTDev (same fwd/inv, bit-identical outputs) on
    ``device``.  Every table is built at construction, the engine order
    included (O(n log n) Python-int work: seconds at n = 2^17).

    ``generator`` replaces the canonical root (of order 2n if negacyclic,
    n otherwise): the sharded four-step (parallel/bigntt.py) needs its
    sub-transforms to be powers of one fixed root.  ``order="engine"``
    puts the outputs into BigNTTDev's order (the drop-in); ``"dft"``
    returns and takes true DFT order, natural k, with no gathers."""

    def __init__(self, spec: FieldSpec, n: int, negacyclic: bool,
                 leaf: int | None = None, device=None,
                 generator: int | None = None, order: str = "engine"):
        if order not in ("engine", "dft"):
            raise ValueError(f"order={order!r}: expected engine|dft")
        self.spec = spec
        self.n = n
        self.negacyclic = negacyclic
        self.device = dev = backend.resolve_device(device)
        self.leaf = leaf if leaf is not None else _default_leaf(spec)
        # a tail block up to 2*leaf still passes BigLinMap's guards and
        # saves one twiddle+matmul level (e.g. 2^16 = 32*32*64)
        self.leaf_direct = self.leaf
        if 255 * 255 * (2 * spec.w) * (2 * self.leaf) < 1 << 31:
            self.leaf_direct = 2 * self.leaf
        self.big = BigMul(spec)
        p, w = spec.p, spec.w
        put = lambda v: limb.ints_to_digits(v, w).to(dev)

        n_inv = pow(n, p - 2, p)
        if negacyclic:
            psi = generator if generator is not None \
                else spec.find_generator(n, True)
            g = psi * psi % p
            psi_inv = pow(psi, p - 2, p)
            tws, unt = [], []
            a, b = 1, n_inv
            for _ in range(n):
                tws.append(a)
                unt.append(b)
                a = a * psi % p
                b = b * psi_inv % p
            self.twist, self.untwist_scale = put(tws), put(unt)   # [w, n]
            self.scale = None
        else:
            g = psi = generator if generator is not None \
                else spec.find_generator(n, False)
            self.twist = self.untwist_scale = None
            self.scale = put([n_inv])                             # [w, 1]
        self.g = g
        self.g_inv = pow(g, p - 2, p)

        self.perm_f = self.perm_b = None
        if order == "engine":
            tw_engine, _, _ = nttmod._tables_host(p, spec.b, spec.k, n,
                                                  negacyclic, generator)
            perm = _simulate_engine_order(spec, n, negacyclic, tw_engine, psi)
            self.perm_f = torch.from_numpy(perm).to(dev)  # engine = true[perm]
            inv_perm = np.empty(n, dtype=np.int64)
            inv_perm[perm] = np.arange(n)
            self.perm_b = torch.from_numpy(inv_perm).to(dev)

        self._maps = {}                               # (tag, m) -> BigLinMap
        self._grids = {"f": self._build_grids(g), "b": self._build_grids(self.g_inv)}
        n_l = n
        while n_l > self.leaf_direct:
            n_l //= self.leaf
        for tag, root in (("f", g), ("b", self.g_inv)):
            self._leaf_map(tag, root, n_l)
            if n_l != n:
                self._leaf_map(tag, root, self.leaf)

    # -- plan tables ------------------------------------------------------
    def _leaf_map(self, tag: str, root: int, m: int) -> BigLinMap:
        key = (tag, m)
        if key not in self._maps:
            p = self.spec.p
            r = pow(root, self.n // m, p)             # canonical order-m root
            rows = [[pow(r, (k * i) % m, p) for i in range(m)]
                    for k in range(m)]
            self._maps[key] = BigLinMap(self.spec, rows, big=self.big,
                                        device=self.device)
        return self._maps[key]

    def _build_grids(self, root: int) -> list[torch.Tensor]:
        """Twiddle grids per level: level l transforms n_l = n / leaf^l
        with outer factor n1 = leaf; grid[i1, k2] = (root^(n/n_l))^(i1*k2)
        as digit planes [w, n1, n2]."""
        p, w = self.spec.p, self.spec.w
        grids = []
        n_l = self.n
        while n_l > self.leaf_direct:
            n1, n2 = self.leaf, n_l // self.leaf
            wl = pow(root, self.n // n_l, p)
            flat = []
            for i1 in range(n1):
                r = pow(wl, i1, p)
                acc = 1
                for _ in range(n2):
                    flat.append(acc)
                    acc = acc * r % p
            grids.append(limb.ints_to_digits(flat, w).reshape(w, n1, n2)
                         .to(self.device))
            n_l = n2
        return grids

    # -- transform --------------------------------------------------------
    def _rec(self, x: torch.Tensor, n_l: int, level: int, tag: str,
             root: int) -> torch.Tensor:
        """True-DFT-order transform of the last axis (size n_l)."""
        if n_l <= self.leaf_direct:
            return self._leaf_map(tag, root, n_l).apply(x)
        n1 = self.leaf
        n2 = n_l // n1
        lead = x.shape[1:-1]
        g = x.reshape(x.shape[:-1] + (n2, n1)).transpose(-1, -2)  # [.., i1, i2]
        g = self._rec(g, n2, level + 1, tag, root)
        grid = self._grids[tag][level].reshape(
            (self.spec.w,) + (1,) * len(lead) + (n1, n2))
        g = self.big.mul_mod(g, grid)
        g = self._leaf_map(tag, root, n1).apply(g.transpose(-1, -2))  # [.., k2, k1]
        return g.transpose(-1, -2).reshape(x.shape[:-1] + (n_l,))

    def _planes(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """[w, m] table -> [w, 1.., m] against a value of ``ndim`` dims."""
        return t.reshape((self.spec.w,) + (1,) * (ndim - 2) + (t.shape[-1],))

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """Forward NTT over the last axis; x plain planes [w, *batch, n].
        Output bit-identical to BigNTTDev.fwd (order "engine")."""
        if self.twist is not None:
            x = self.big.mul_mod(x, self._planes(self.twist, x.dim()))
        out = self._rec(x, self.n, 0, "f", self.g)
        return out if self.perm_f is None else out[..., self.perm_f]

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse NTT (with 1/n) of values in BigNTTDev's order (order
        "engine") or DFT order.  Output bit-identical to BigNTTDev.inv."""
        if self.perm_b is not None:
            x = x[..., self.perm_b]
        out = self._rec(x, self.n, 0, "b", self.g_inv)
        fix = self.untwist_scale if self.scale is None else self.scale
        return self.big.mul_mod(out, self._planes(fix, out.dim()))
