"""ChaCha20 keystream on the card: the commit path's entropy.

The commit draws about 8 bytes of uniform entropy per encode coefficient
from ChaCha20 (djb variant: 64-bit block counter = block index, nonce 0),
keyed from the host AES-CTR stream.  ``keystream_u32_batch`` runs the CUDA
kernel (csrc/chacha20.cu) on a CUDA key tensor and its plain version
``keystream_u32_plain`` on a CPU one.

Words are returned as their raw 32-bit patterns in ``int32``, in the
layout of ``ringo_tpu.csprng.chacha.keystream_u32``: out[..., b, w] = word
w of block b.  Consecutive word pairs are little-endian uint64 draws, so
``keystream_u64`` is a reinterpreting view.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend

CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_COLUMNS = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15)]
_DIAGONALS = [(0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)]
_M32 = 0xFFFFFFFF


def key_from_bytes(raw: bytes) -> torch.Tensor:
    """32 bytes -> int32[8] little-endian key words (raw bit patterns)."""
    if len(raw) != 32:
        raise ValueError("ChaCha20 key must be 32 bytes")
    return torch.from_numpy(np.frombuffer(raw, dtype="<i4").copy())


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding u32 values -> int32 raw bit patterns."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def _quarter(a, b, c, d):
    a = (a + b) & _M32
    d = _rotl(d ^ a, 16)
    c = (c + d) & _M32
    b = _rotl(b ^ c, 12)
    a = (a + b) & _M32
    d = _rotl(d ^ a, 8)
    c = (c + d) & _M32
    b = _rotl(b ^ c, 7)
    return a, b, c, d


def keystream_u32_plain(keys: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Plain version: keys int32 [T, 8] -> int32 [T, n_blocks, 16], the
    20 rounds in masked int64 lanes."""
    kk = keys.to(torch.int64) & _M32
    T = kk.shape[0]
    ones = torch.ones((T, n_blocks), dtype=torch.int64, device=keys.device)
    ctr = torch.arange(n_blocks, dtype=torch.int64, device=keys.device)
    state = [ones * c for c in CONSTANTS]
    state += [ones * kk[:, i:i + 1] for i in range(8)]
    state += [ones * ctr, ones * 0, ones * 0, ones * 0]
    x = list(state)
    for _ in range(10):
        for (a, b, c, d) in _COLUMNS + _DIAGONALS:
            x[a], x[b], x[c], x[d] = _quarter(x[a], x[b], x[c], x[d])
    out = torch.stack([(xi + si) & _M32 for xi, si in zip(x, state)], dim=-1)
    return _to_i32(out)


def keystream_u32_cuda(keys: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The CUDA kernel: keys int32 [T, 8] on the card -> int32
    [T, n_blocks, 16]; one launch for all T streams."""
    backend.require(keys, torch.int32, name="keys")
    if keys.dim() != 2 or keys.shape[1] != 8 or not keys.is_cuda:
        raise ValueError("keys: expected int32 [T, 8] on the card")
    if not 0 < n_blocks < (1 << 31):
        raise ValueError(f"n_blocks out of range: {n_blocks}")
    T = keys.shape[0]
    out = torch.empty((T, n_blocks, 16), dtype=torch.int32,
                      device=keys.device)
    err = backend.lib().ringo_chacha20(
        keys.data_ptr(), out.data_ptr(), T, n_blocks,
        backend.stream_ptr(keys))
    backend.check(err, "chacha20")
    backend.LAUNCHES["chacha"] += 1
    return out


def keystream_u32_batch(keys: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """T independent keystreams: int32 [T, 8] -> int32 [T, n_blocks, 16],
    each starting at block 0 (bit-identical to T single calls)."""
    if keys.is_cuda:
        return keystream_u32_cuda(keys.contiguous(), n_blocks)
    return keystream_u32_plain(keys, n_blocks)


def keystream_u32(key: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """One keystream: int32 [8] -> int32 [n_blocks, 16]."""
    return keystream_u32_batch(key.reshape(1, 8), n_blocks)[0]


def keystream_u64_batch(keys: torch.Tensor, count: int) -> torch.Tensor:
    """count uint64 draws per key as raw bits in int64 [T, count]: word
    pairs (lo, hi) of the keystream, read as one little-endian int64."""
    nb = -(-count // 8)
    w = keystream_u32_batch(keys, nb).reshape(keys.shape[0], nb * 16)
    return w.view(torch.int64)[:, :count]


def keystream_u64(key: torch.Tensor, count: int) -> torch.Tensor:
    return keystream_u64_batch(key.reshape(1, 8), count)[0]
