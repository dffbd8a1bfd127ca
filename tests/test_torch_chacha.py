"""The port's plain ChaCha20 keystream (int64 lanes, masked) against the
JAX package's numpy keystream, single and batched.  Exact equality."""

import numpy as np
import pytest
import torch

from ringo_tpu.csprng import chacha as ref
from ringo_tpu_torch.csprng import chacha


def _keys(seed, t):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (t, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_blocks", [1, 7, 8193])
def test_keystream_matches_reference(n_blocks):
    keys = _keys(n_blocks, 3)
    tk = torch.from_numpy(keys.view(np.int32))
    got = chacha.keystream_u32_batch(tk, n_blocks).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref.keystream_u32_batch(keys, n_blocks))
    np.testing.assert_array_equal(
        chacha.keystream_u32(tk[1], n_blocks).numpy().view(np.uint32),
        ref.keystream_u32(keys[1], n_blocks))


@pytest.mark.parametrize("count", [1, 8, 1001])
def test_u64_draws_match_reference(count):
    keys = _keys(count, 2)
    tk = torch.from_numpy(keys.view(np.int32))
    got = chacha.keystream_u64_batch(tk, count).numpy().view(np.uint64)
    for i in range(2):
        np.testing.assert_array_equal(got[i], ref.keystream_u64(keys[i], count))


def test_key_from_bytes_matches_reference():
    raw = bytes(range(100, 132))
    np.testing.assert_array_equal(
        chacha.key_from_bytes(raw).numpy().view(np.uint32),
        ref.key_from_bytes(raw))


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        chacha.keystream_u32_cuda(torch.zeros((1, 8), dtype=torch.int32), 4)
