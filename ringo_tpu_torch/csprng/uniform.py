"""AES-256-CTR uniform sampler, bit-compatible with the reference
(math/csprng/uniform.go): seed -> SHA-384 -> AES-256 key || CTR IV; the
8 KiB buffer XORs each new keystream chunk over its previous contents, and
``sample`` consumes 8 little-endian bytes.

AES is the port's own numpy implementation (FIPS-197 with the usual four
32-bit T-tables), vectorised over every counter block of a request at
once, so the sampler needs no crypto package.  CTR is seekable, so a
snapshot is a byte offset: ``sample_n``'s rare rejection path rewinds to
it and replays in exact scalar order.  A large draw XORs its 8 KiB chunks
with one cumulative XOR, which is what the refill loop computes one chunk
at a time.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

BUF_SIZE = 8192
FLOAT_PREC = 52
_U64_MAX = (1 << 64) - 1
_CHUNK_BLOCKS = 1 << 16   # counter blocks per vectorised AES pass


# ------------------------------------------------------------------ AES

def _gf_tables():
    """exp/log tables of GF(2^8) with generator 3 (x^8+x^4+x^3+x+1)."""
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    return exp, log


def _build_tables():
    exp, log = _gf_tables()
    sbox = np.zeros(256, dtype=np.uint32)
    for a in range(256):
        b = exp[255 - log[a]] if a else 0
        s = b
        for r in range(1, 5):
            s ^= ((b << r) | (b >> (8 - r))) & 0xFF
        sbox[a] = s ^ 0x63

    def xt(v):  # multiply by 2 in GF(2^8)
        v <<= 1
        return (v ^ 0x11B) if v & 0x100 else v

    te0 = np.zeros(256, dtype=np.uint32)
    for a in range(256):
        s = int(sbox[a])
        s2 = xt(s)
        te0[a] = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s)
    ror = lambda t, r: ((t >> np.uint32(r)) | (t << np.uint32(32 - r)))
    return sbox, (te0, ror(te0, 8), ror(te0, 16), ror(te0, 24))


_SBOX, _TE = _build_tables()


def expand_key_256(key: bytes) -> np.ndarray:
    """FIPS-197 key expansion for AES-256: 60 big-endian round-key words."""
    if len(key) != 32:
        raise ValueError("AES-256 needs a 32-byte key")
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(8)]
    sb = [int(x) for x in _SBOX]
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = (sb[t >> 24] << 24) | (sb[(t >> 16) & 0xFF] << 16) \
                | (sb[(t >> 8) & 0xFF] << 8) | sb[t & 0xFF]
            t ^= rcon << 24
            rcon = ((rcon << 1) ^ (0x11B if rcon & 0x80 else 0)) & 0xFF
        elif i % 8 == 4:
            t = (sb[t >> 24] << 24) | (sb[(t >> 16) & 0xFF] << 16) \
                | (sb[(t >> 8) & 0xFF] << 8) | sb[t & 0xFF]
        w.append(w[i - 8] ^ t)
    return np.array(w, dtype=np.uint32)


def _bytes_of(s):
    """u32 array [n] -> its bytes MSB first as four uint8 views."""
    b = s.view(np.uint8).reshape(-1, 4)  # little-endian memory: [:, 3] = MSB
    return b[:, 3], b[:, 2], b[:, 1], b[:, 0]


def aes256_encrypt_words(rk: np.ndarray, s0, s1, s2, s3):
    """Encrypt n blocks given as four big-endian u32 column words each
    ([n] arrays); returns the four output words."""
    te0, te1, te2, te3 = _TE
    s = [s0 ^ rk[0], s1 ^ rk[1], s2 ^ rk[2], s3 ^ rk[3]]
    for r in range(1, 14):
        bs = [_bytes_of(np.ascontiguousarray(x)) for x in s]
        s = [te0[bs[c][0]] ^ te1[bs[(c + 1) % 4][1]]
             ^ te2[bs[(c + 2) % 4][2]] ^ te3[bs[(c + 3) % 4][3]] ^ rk[4 * r + c]
             for c in range(4)]
    bs = [_bytes_of(np.ascontiguousarray(x)) for x in s]
    return [((_SBOX[bs[c][0]] << np.uint32(24))
             | (_SBOX[bs[(c + 1) % 4][1]] << np.uint32(16))
             | (_SBOX[bs[(c + 2) % 4][2]] << np.uint32(8))
             | _SBOX[bs[(c + 3) % 4][3]]) ^ rk[56 + c]
            for c in range(4)]


def aes256_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One block (for known-answer tests)."""
    words = [np.array([int.from_bytes(block[4 * i:4 * i + 4], "big")],
                      dtype=np.uint32) for i in range(4)]
    out = aes256_encrypt_words(expand_key_256(key), *words)
    return b"".join(int(w[0]).to_bytes(4, "big") for w in out)


def ctr_keystream(rk: np.ndarray, iv: int, block0: int,
                  n_blocks: int) -> np.ndarray:
    """Keystream bytes of counter blocks iv+block0 .. iv+block0+n_blocks-1
    (the 16-byte counter increments as one big-endian integer)."""
    out = np.empty((n_blocks, 4), dtype=">u4")
    for c0 in range(0, n_blocks, _CHUNK_BLOCKS):
        m = min(_CHUNK_BLOCKS, n_blocks - c0)
        start = (iv + block0 + c0) % (1 << 128)
        hi = np.uint64(start >> 64)
        lo0 = np.uint64(start & _U64_MAX)
        lo = lo0 + np.arange(m, dtype=np.uint64)  # wraps mod 2^64
        hi = hi + (lo < lo0).astype(np.uint64)
        words = [(hi >> np.uint64(32)).astype(np.uint32),
                 (hi & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                 (lo >> np.uint64(32)).astype(np.uint32),
                 (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
        enc = aes256_encrypt_words(rk, *words)
        for c in range(4):
            out[c0:c0 + m, c] = enc[c]
    return out.view(np.uint8).reshape(-1)


# -------------------------------------------------------------- sampler

class UniformSampler:
    def __init__(self, seed: bytes | None = None):
        if seed is None:
            seed = os.urandom(32)
        r = hashlib.sha384(seed).digest()
        self._rk = expand_key_256(r[:32])
        self._iv = int.from_bytes(r[32:48], "big")
        self._consumed = 0  # keystream bytes consumed so far
        self._buf = np.zeros(BUF_SIZE, dtype=np.uint8)
        self._ptr = BUF_SIZE

    # -- keystream plumbing --------------------------------------------------

    def _keystream(self, n: int) -> np.ndarray:
        pos = self._consumed
        b0 = pos // 16
        b1 = -(-(pos + n) // 16)
        ks = ctr_keystream(self._rk, self._iv, b0, b1 - b0)
        self._consumed += n
        off = pos - 16 * b0
        return ks[off:off + n]

    def _snapshot(self):
        return (self._consumed, self._buf.copy(), self._ptr)

    def _restore(self, snap):
        consumed, buf, ptr = snap
        self._consumed = consumed
        self._buf = buf.copy()
        self._ptr = ptr

    def read(self, data: bytes) -> bytes:
        """io.Reader semantics: XOR keystream over ``data`` (bypasses the
        buffer, like the reference's Read)."""
        ks = self._keystream(len(data))
        return (np.frombuffer(data, dtype=np.uint8) ^ ks).tobytes()

    def _take_bytes(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint8)
        take = min(n, BUF_SIZE - self._ptr)
        out[:take] = self._buf[self._ptr:self._ptr + take]
        self._ptr += take
        rem = n - take
        if rem:
            # m refills at once: refill i leaves buf ^ ks_1 ^ ... ^ ks_i
            m = -(-rem // BUF_SIZE)
            ks = self._keystream(m * BUF_SIZE).reshape(m, BUF_SIZE).copy()
            ks[0] ^= self._buf
            np.bitwise_xor.accumulate(ks, axis=0, out=ks)
            out[take:] = ks.reshape(-1)[:rem]
            self._buf = ks[-1].copy()
            self._ptr = rem - (m - 1) * BUF_SIZE
        return out

    # -- sampling ------------------------------------------------------------

    def sample(self) -> int:
        return int(self.sample_u64(1)[0])

    def sample_u64(self, count: int) -> np.ndarray:
        return self._take_bytes(8 * count).view("<u8")

    def sample_n(self, n: int, count: int = 1) -> np.ndarray:
        """count uniform draws in [0, n), exact reference SampleN order."""
        n = int(n)
        bound = _U64_MAX - _U64_MAX % n
        snap = self._snapshot()
        block = self.sample_u64(count)
        if bool((block < np.uint64(bound)).all()):
            return block % np.uint64(n)
        # rare path: replay sequentially with per-value rejection
        self._restore(snap)
        out = np.empty(count, dtype=np.uint64)
        for i in range(count):
            r = self.sample()
            while r >= bound:
                r = self.sample()
            out[i] = r % n
        return out

    def sample_float(self, count: int = 1) -> np.ndarray:
        """Uniform floats in [0, 1) at 52-bit precision (reference
        SampleFloat)."""
        r = self.sample_u64(count) % np.uint64(1 << FLOAT_PREC)
        bits = r | np.uint64((1023 + FLOAT_PREC) << FLOAT_PREC)
        return bits.view(np.float64) / float(1 << FLOAT_PREC) - 1.0
