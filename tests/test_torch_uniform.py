"""The port's AES-256-CTR UniformSampler (its own numpy AES, no crypto
package) against the JAX package's sampler (pyca cryptography), and its
AES against the FIPS-197 / SP 800-38A known answers.  Exact equality."""

import numpy as np
import pytest

import aesref
from ringo_tpu.csprng import UniformSampler as RefSampler
from ringo_tpu_torch.csprng import uniform


@pytest.mark.parametrize("seed", [b"Jindo!", b"ringo", b"\x00" * 32])
def test_stream_matches_reference(seed):
    a, b = RefSampler(seed), uniform.UniformSampler(seed)
    # draws that end inside, exactly at, and far across 8 KiB refills
    for n in (3, 8189, 8192, 9000, 3 * 8192 + 5, 77):
        np.testing.assert_array_equal(a._take_bytes(n), b._take_bytes(n))
    np.testing.assert_array_equal(a.sample_u64(1000), b.sample_u64(1000))
    # sample_n: the fast path, then n = 2^63 + 1, where about half the
    # draws are rejected and the stream rewinds and replays scalar by scalar
    np.testing.assert_array_equal(a.sample_n(33556993, 500),
                                  b.sample_n(33556993, 500))
    np.testing.assert_array_equal(a.sample_n((1 << 63) + 1, 40),
                                  b.sample_n((1 << 63) + 1, 40))
    np.testing.assert_array_equal(a.sample_float(300), b.sample_float(300))
    assert a.read(b"io.Reader bytes") == b.read(b"io.Reader bytes")
    np.testing.assert_array_equal(a.sample_u64(2000), b.sample_u64(2000))


def test_matches_from_spec_go_sampler():
    go = aesref.GoUniformSampler(b"Jindo!")
    s = uniform.UniformSampler(b"Jindo!")
    want = [go.sample() for _ in range(1100)]  # crosses one refill
    assert [int(x) for x in s.sample_u64(1100)] == want


def test_aes_known_answers():
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    k256 = bytes(range(32))
    assert uniform.aes256_encrypt_block(k256, pt) == bytes.fromhex(
        "8ea2b7ca516745bfeafc49904b496089")           # FIPS-197 C.3
    key = bytes.fromhex("603deb1015ca71be2b73aef0857d7781"
                        "1f352c073b6108d72d9810a30914dff4")
    iv = int.from_bytes(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"),
                        "big")
    ks = uniform.ctr_keystream(uniform.expand_key_256(key), iv, 0, 4)
    pt4 = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
    ct4 = bytes.fromhex(
        "601ec313775789a5b7a7f504bbf3d228f443e3ca4d62b59aca84e990cacaf5c5"
        "2b0930daa23de94ce87017ba2d84988ddfc9c58db67aada613c2dd08457941a6")
    assert (np.frombuffer(pt4, np.uint8) ^ ks).tobytes() == ct4  # SP 800-38A F.5.5
    # the same vector through the from-spec reference implementation
    assert aesref.CTR(key, iv.to_bytes(16, "big")).xor(pt4) == ct4


def test_counter_wraps_as_128_bit_integer():
    rk = uniform.expand_key_256(bytes(32))
    iv = (1 << 128) - 2
    ks = uniform.ctr_keystream(rk, iv, 0, 4)
    ctr = aesref.CTR(bytes(32), iv.to_bytes(16, "big"))
    assert ks.tobytes() == ctr.keystream(64)
