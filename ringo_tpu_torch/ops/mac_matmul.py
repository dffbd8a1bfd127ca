"""Exact mod-q MAC contractions: the Ajtai products of the commitment.

    com[l, j, n, :] = sum_k key[l, j, k, :] * x[l, k, n, :] * R^-1  mod q_l

(R = 2^32), the value a Montgomery-product accumulation gives.  Both
routes use the same integers.  With key' = key * R^-1 mod q and the key
pieces F[(b, j), (a, k)] = ((2^8a * key' mod q) >> 7b) & 127,

* T_b = sum_{a, k} F[(b, j), (a, k)] * byte_a(x[k]), each < 255 * 127 * 4K
  < 2^31 for K <= MAX_K;
* y = sum_b 2^7b * T_b mod q, because sum_b 2^7b F[(b, j), (a, k)] =
  2^8a * key' mod q.

Both routes take the key as the residues key' (``folded``, 4 bytes a
residue, once per key).  On a CUDA tensor ``mod_mac`` launches the
hand-written kernel (csrc/mac.cu, ``mod_mac_cuda``): it makes the key's
pieces in shared memory, the bytes of 2^8a * key' mod q (four byte planes;
unsigned bytes need no 7-bit pieces), multiplies them by x's bytes on the
tensor cores (u8 x u8 -> s32, sums < 2^31 for K <= KERNEL_MAX_K), and
reduces sum_b 2^8b T_b mod q with mu = floor(2^64 / q) (``mac_consts``).
On a CPU tensor it runs ``mod_mac_plain``: the key's float64 planes
(``key_planes``), x split into byte planes offset by -128, one batched
``torch.matmul`` (every partial sum an integer below 2^53) and the
correction 128 * rowsum.  Both equal ``ringo_tpu.ops.mac_matmul.mod_mac``
bit for bit (tests/test_torch_mac_crt.py, tests/test_torch_mac_kernel.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend

P7 = 5          # 7-bit output planes: 5 * 7 = 35 bits cover values < 2^31
SHIFT = 7
PMAX = 127
IN_PLANES = 4   # byte input planes: 4 * 8 = 32 bits
MAX_K = 16384   # 255 * 127 * IN_PLANES * K < 2^31

# the kernel: byte planes, 255 * 255 * 4K < 2^31; tiles of 8 slots, 8 k a
# chunk, at most 16 key rows (4 * 16 A rows = 64) and one wgmma width of
# n columns a block
KERNEL_MAX_K = 8192
KC = 8
MAX_JT = 16
TILE_WIDTHS = (8, 16, 24, 32, 48, 64, 80)


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


def folded(ring, key: torch.Tensor) -> torch.Tensor:
    """Key residues int32 [L, J, K, d] -> key' = key * R^-1 mod q, int32
    and contiguous: what ``mod_mac`` takes, once per key.  K is bounded by
    the route of the key's device (``KERNEL_MAX_K`` on the card)."""
    limit = KERNEL_MAX_K if key.is_cuda else MAX_K
    if key.shape[2] > limit:
        raise ValueError(f"MAC contraction length {key.shape[2]} > {limit}")
    L = key.shape[0]
    v = key.to(torch.int64) * ring.rinv.reshape(L, 1, 1, 1)
    return (v % ring.q.reshape(L, 1, 1, 1)).to(torch.int32).contiguous()


def key_planes(ring, kres: torch.Tensor) -> torch.Tensor:
    """key' int32 [L, J, K, d] -> planes float64 [L, d, P7*J, IN_PLANES*K]
    with planes[l, :, b*J + j, a*K + k] = ((2^8a * key'[l,j,k,:] mod q_l)
    >> 7b) & 127."""
    L, J, K, d = kres.shape
    q = ring.q.reshape(L, 1, 1, 1)
    v = kres.to(torch.int64)
    planes = torch.empty((L, d, P7, J, IN_PLANES, K), dtype=torch.int64,
                         device=kres.device)
    for a in range(IN_PLANES):
        fa = (v << (8 * a)) % q                       # < 2^50
        for b in range(P7):
            pb = (fa >> (SHIFT * b)) & PMAX           # [L, J, K, d]
            planes[:, :, b, :, a, :] = pb.permute(0, 3, 1, 2)
    return planes.reshape(L, d, P7 * J, IN_PLANES * K).to(torch.float64)


def fold_key(ring, key: torch.Tensor) -> torch.Tensor:
    """Key residues int32 [L, J, K, d] -> the plain version's planes
    (``key_planes`` of ``folded``), the JAX package's int8 values and
    layout."""
    return key_planes(ring, folded(ring, key))


def fold_corr(planes: torch.Tensor) -> torch.Tensor:
    """The -128-offset correction of ``fold_key`` planes: 128 * rowsum
    over the contraction axis, int64 [L, d, P7*J]."""
    return 128 * planes.sum(dim=3).to(torch.int64)


def key_slice(key: torch.Tensor, planes=None, rows=None) -> torch.Tensor:
    """A folded key restricted to some of its primes (``planes``, an index
    tensor into L) and output rows (``rows``, into J): ``mod_mac`` with the
    slice, over a ring of those primes, gives those rows and primes of
    ``mod_mac`` with the whole key (the sharded commit splits both)."""
    if planes is not None:
        key = key[planes]
    if rows is not None:
        key = key[:, rows]
    return key.contiguous()


def mod_mac(ring, key, x: torch.Tensor) -> torch.Tensor:
    """Exact sum_k key[k] * x[k] * R^-1 mod q: ``key`` from ``folded``,
    x residues int32 [L, K, n, d] (any strides on the card).  Returns int32
    [L, J, n, d].  The kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if x.is_cuda:
        return mod_mac_cuda(ring, key, x)
    return mod_mac_plain(ring, key, x)


def mod_mac_plain(ring, key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel, on any device: key' from ``folded``
    into float64 planes (``key_planes``, ``fold_corr``), byte split,
    ``torch.matmul`` and integer recombine."""
    planes = key_planes(ring, key)
    L, K, n, d = x.shape
    J = key.shape[1]
    xa = byte_planes(x.permute(0, 3, 1, 2), dim=2)    # [L, d, 4K, n]
    t = torch.matmul(planes, xa).to(torch.int64)      # [L, d, P7*J, n]
    t = t + fold_corr(planes)[..., None]
    t = t.reshape(L, d, P7, J, n).permute(0, 3, 4, 2, 1)  # [L, J, n, P7, d]
    return recombine_mod_q(ring.q, t.reshape(L, J, n, P7 * d), d)


# ------------------------------------------------------------------ kernel

def mac_consts(primes) -> np.ndarray:
    """The kernel's constants per prime, uint64 [L, 8]: q, the reduction's
    mu = floor(2^64 / q), then (c, floor(c * 2^32 / q)) for
    c = 2^8, 2^16, 2^24 mod q, the Shoup pairs that make 2^8a * key' mod q."""
    out = np.zeros((len(primes), 8), dtype=np.uint64)
    for i, q in enumerate(int(p) for p in primes):
        if not 2 < q < 1 << 31:
            raise ValueError(f"MAC kernel: prime {q} not in (2, 2^31)")
        row = [q, (1 << 64) // q]
        for a in (1, 2, 3):
            c = (1 << (8 * a)) % q
            row += [c, (c << 32) // q]
        out[i] = row
    return out


def tile_width(n: int) -> int:
    """The kernel's tile of n columns (csrc/mac.cu ``tile_width``): the
    narrowest of ``TILE_WIDTHS`` that holds n, else 80 (several tiles)."""
    for w in TILE_WIDTHS:
        if n <= w:
            return w
    return TILE_WIDTHS[-1]


def tiles(J: int, n: int) -> tuple[int, int, int, int]:
    """(N, n tiles, key-row tiles, rows a key-row tile) of a launch."""
    N = tile_width(n)
    jt = -(-J // MAX_JT)
    return N, -(-n // N), jt, -(-J // jt)


_CONSTS: dict = {}


def _consts_on(ring, device) -> torch.Tensor:
    key = (tuple(int(p) for p in ring.primes), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.from_numpy(
            mac_consts(ring.primes).view(np.int64)).to(device)
    return t


def check_args(ring, key: torch.Tensor, x: torch.Tensor) -> None:
    """What the kernel takes: key' int32 [L, J, K, 256] contiguous, x int32
    [L, K, n, 256] with its last stride 1 and the others multiples of 4
    (16 bytes), K <= KERNEL_MAX_K, primes below 2^31."""
    backend.require(key, torch.int32, name="key")
    if x.dtype != torch.int32:
        raise TypeError(f"x: expected torch.int32, got {x.dtype}")
    if x.dim() != 4 or key.dim() != 4:
        raise ValueError("MAC kernel: expected key [L, J, K, d], x [L, K, n, d]")
    L, K, n, d = x.shape
    if key.shape[0] != L or key.shape[2] != K or key.shape[3] != d:
        raise ValueError(f"MAC kernel: key {tuple(key.shape)} does not "
                         f"match x {tuple(x.shape)}")
    if d != 256 or L != len(ring.primes):
        raise ValueError("MAC kernel: expected d = 256 and one prime a plane")
    if K > KERNEL_MAX_K:
        raise ValueError(f"MAC kernel: contraction length {K} > {KERNEL_MAX_K}")
    if x.stride(3) != 1 or any(x.stride(i) % 4 for i in range(3)) \
            or x.storage_offset() % 4:
        raise ValueError("MAC kernel: x needs its last stride 1 and the "
                         "others, and its offset, in multiples of 4")


def mod_mac_cuda(ring, key: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (csrc/mac.cu) on the card: key' int32 [L, J, K, 256]
    (``folded``), x int32 [L, K, n, 256] taken by its strides.  One
    launch."""
    check_args(ring, key, x)
    if not (x.is_cuda and key.is_cuda and x.device == key.device):
        raise ValueError("MAC kernel: key and x must lie on one card")
    L, K, n, d = x.shape
    J = key.shape[1]
    out = torch.empty((L, J, n, d), dtype=torch.int32, device=x.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    consts = _consts_on(ring, x.device)
    err = backend.lib().ringo_mac(
        key.data_ptr(), x.data_ptr(), consts.data_ptr(), out.data_ptr(),
        L, J, K, n, x.stride(0), x.stride(1), x.stride(2),
        backend.stream_ptr(x))
    backend.check(err, "mac")
    backend.LAUNCHES["mac"] += 1
    return out
