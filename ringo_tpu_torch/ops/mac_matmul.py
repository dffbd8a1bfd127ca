"""Exact mod-q MAC contractions: the Ajtai products of the commitment.

    com[l, j, n, :] = sum_k key[l, j, k, :] * x[l, k, n, :]  mod q_l

runs as one batched float64 matmul per call, with exact integer results:

* x residues (< 2^32) are split into IN_PLANES = 4 byte planes offset by
  -128, stacked along the contraction axis;
* the key is pre-folded: F[(b, j), (a, k)] = ((2^8a * key' mod q) >> 7b)
  & 127 with key' = key * R^-1 mod q (R = 2^32), so the integer product
  equals a Montgomery-product accumulation;
* T = F @ (x - 128) plus 128 * rowsum(F) gives the true plane sums, each
  < 255 * 127 * 4K < 2^31 for K <= MAX_K, so every partial sum of the
  float64 product is an integer below 2^53 and exact;
* y = sum_b 2^7b * T_b mod q, recombined in int64.

The JAX package runs this product as an XLA int8 ``dot_general``, not a
Pallas kernel; PyTorch has no batched int8 product to rely on, so the port
uses ``torch.matmul`` in float64.  Bit-identical to
``ringo_tpu.ops.mac_matmul.mod_mac`` (tests/test_torch_mac_crt.py).
"""

from __future__ import annotations

import torch

P7 = 5          # 7-bit output planes: 5 * 7 = 35 bits cover values < 2^31
SHIFT = 7
PMAX = 127
IN_PLANES = 4   # byte input planes: 4 * 8 = 32 bits
MAX_K = 16384   # 255 * 127 * IN_PLANES * K < 2^31


def recombine_mod_q(q: torch.Tensor, t: torch.Tensor, d: int) -> torch.Tensor:
    """t int64 [L, ..., P7 * d] plane sums, plane b in columns
    [b*d, (b+1)*d) -> int32 [L, ..., d] residues of sum_b 2^(7b) t_b mod q
    (q int64 [L]).  The sum stays below 2^60: exact in int64."""
    s = t[..., :d]
    for b in range(1, P7):
        s = s + (t[..., b * d:(b + 1) * d] << (SHIFT * b))
    qb = q.reshape(-1, *([1] * (t.dim() - 1)))
    return (s % qb).to(torch.int32)


def byte_planes(v: torch.Tensor, dim: int) -> torch.Tensor:
    """u32 residues -> float64 offset byte planes (b - 128), the four
    planes concatenated along ``dim``."""
    u = v.to(torch.int64)
    return torch.cat([(((u >> (8 * a)) & 0xFF) - 128).to(torch.float64)
                      for a in range(IN_PLANES)], dim=dim)


def fold_key(ring, key: torch.Tensor) -> torch.Tensor:
    """Key residues int32 [L, J, K, d] -> planes float64
    [L, d, P7*J, IN_PLANES*K] with planes[l, :, b*J + j, a*K + k] =
    ((2^8a * key'[l,j,k,:] mod q_l) >> 7b) & 127.  Once per commit key."""
    L, J, K, d = key.shape
    if K > MAX_K:
        raise ValueError(f"MAC contraction length {K} > {MAX_K}")
    q = ring.q.reshape(L, 1, 1, 1)
    v = key.to(torch.int64) * ring.rinv.reshape(L, 1, 1, 1) % q  # key'
    planes = torch.empty((L, d, P7, J, IN_PLANES, K), dtype=torch.int64,
                         device=key.device)
    for a in range(IN_PLANES):
        fa = (v << (8 * a)) % q                       # < 2^50
        for b in range(P7):
            pb = (fa >> (SHIFT * b)) & PMAX           # [L, J, K, d]
            planes[:, :, b, :, a, :] = pb.permute(0, 3, 1, 2)
    return planes.reshape(L, d, P7 * J, IN_PLANES * K).to(torch.float64)


def fold_corr(planes: torch.Tensor) -> torch.Tensor:
    """The -128-offset correction of ``fold_key`` planes: 128 * rowsum
    over the contraction axis, int64 [L, d, P7*J]."""
    return 128 * planes.sum(dim=3).to(torch.int64)


def folded(ring, key: torch.Tensor):
    """``(fold_key(key), fold_corr(...))``: what ``mod_mac`` takes."""
    planes = fold_key(ring, key)
    return planes, fold_corr(planes)


def key_slice(key_planes, planes=None, rows=None):
    """A folded key restricted to some of its primes (``planes``, an index
    tensor into L) and output rows (``rows``, into J): ``mod_mac`` with the
    slice, over a ring of those primes, gives those rows and primes of
    ``mod_mac`` with the whole key (the sharded commit splits both)."""
    kp, corr = key_planes
    if planes is not None:
        kp, corr = kp[planes], corr[planes]
    if rows is not None:
        J = kp.shape[2] // P7
        idx = (torch.arange(P7, device=rows.device)[:, None] * J
               + rows[None]).reshape(-1)
        kp, corr = kp[:, :, idx], corr[:, :, idx]
    return kp, corr


def mod_mac(ring, key_planes, x: torch.Tensor) -> torch.Tensor:
    """Exact (key . x mod q) with the key folded by ``fold_key``.

    key_planes: (planes, fold_corr(planes)); x residues int32
    [L, K, n, d].  Returns int32 [L, J, n, d], the value a
    Montgomery-product accumulation sum_k key[k] * x[k] * R^-1 mod q
    gives."""
    planes, corr = key_planes
    L, K, n, d = x.shape
    J = planes.shape[2] // P7
    xa = byte_planes(x.permute(0, 3, 1, 2), dim=2)    # [L, d, 4K, n]
    t = torch.matmul(planes, xa).to(torch.int64)      # [L, d, P7*J, n]
    t = t + corr[..., None]
    t = t.reshape(L, d, P7, J, n).permute(0, 3, 4, 2, 1)  # [L, J, n, P7, d]
    return recombine_mod_q(ring.q, t.reshape(L, J, n, P7 * d), d)
