"""AES-256-CTR uniform sampler, bit-compatible with the reference
(math/csprng/uniform.go): seed -> SHA-384 -> AES-256 key || CTR IV; the
8 KiB buffer XORs each new keystream chunk over its previous contents, and
``sample`` consumes 8 little-endian bytes.

The keystream comes from the sampler's device: on a CUDA device from the
kernel csrc/aes256_ctr.cu (``ctr_keystream_cuda``), on the CPU from its
plain version ``ctr_keystream``, the port's own numpy AES (FIPS-197 with
the usual four 32-bit T-tables, vectorised over every counter block of a
request at once), so the sampler needs no crypto package.  A sampler keeps
a read-ahead window of keystream blocks on the host, so that the 8 KiB
refills of a CUDA sampler do not each pay a launch and a synchronising
copy.  CTR is seekable, so the window changes no byte, and a snapshot is a
byte offset: ``sample_n``'s rare rejection path rewinds to it and replays
in exact scalar order.  A large draw XORs its 8 KiB chunks with one
cumulative XOR over uint64 words, which is what the refill loop computes
one chunk at a time.

``read_ahead(nbytes)`` reads ahead on the sampler's device: the 8 KiB buffer
followed by the next refills folded behind it, on a CUDA device by the
kernel's fold entry (``fold_cuda``: keystream and cumulative XOR in one
launch, nothing copied to the host), on the CPU by the plain version
``fold_plain``.  A consumer on the card reads what it needs from it and
``commit(used)`` then advances the sampler exactly as ``_take_bytes`` of
``used`` bytes would (the Gaussian loop kernel draws so).
``sample_u64_device`` / ``sample_float_device`` draw the same values as
``sample_u64`` / ``sample_float`` through a read-ahead.  The 8 KiB buffer
then stays where the last draw left it and is copied across only when a
draw of the other kind follows.
"""

from __future__ import annotations

import hashlib
import os
import threading

import numpy as np
import torch

from .. import backend

BUF_SIZE = 8192
FLOAT_PREC = 52
_U64_MAX = (1 << 64) - 1
_CHUNK_BLOCKS = 1 << 16   # counter blocks per vectorised AES pass
_LAUNCH_BLOCKS = 1 << 22  # counter blocks per kernel launch (64 MiB)
_FOLD_CHUNKS = 1024       # 8 KiB chunks per fold launch (8 MiB)
# read-ahead window of a sampler, in counter blocks: 1 MiB on the card; on
# the CPU, where reading ahead saves nothing, one 8 KiB refill
WINDOW_BLOCKS = 1 << 16
PLAIN_WINDOW_BLOCKS = BUF_SIZE // 16


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


def ctr_blocks_cuda(rk: np.ndarray, iv: int, block0: int,
                    out: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel (csrc/aes256_ctr.cu), one launch: fills ``out``,
    uint8 [16 * n] on the card, with the keystream of counter blocks
    iv+block0 .. iv+block0+n-1, as ``ctr_keystream`` computes it."""
    backend.require(out, torch.uint8, name="out")
    if out.dim() != 1 or not out.is_cuda or out.numel() % 16:
        raise ValueError("out: expected uint8 [16 * n_blocks] on the card")
    n_blocks = out.numel() // 16
    if not 0 < n_blocks <= _LAUNCH_BLOCKS:
        raise ValueError(f"n_blocks out of range: {n_blocks}")
    args = _ctr_args(rk, iv + block0)
    err = backend.lib().ringo_aes256_ctr(
        args.ctypes.data, out.data_ptr(), n_blocks, backend.stream_ptr(out))
    backend.check(err, "aes256_ctr")
    backend.LAUNCHES["aes"] += 1
    return out


def _ctr_args(rk: np.ndarray, start: int) -> np.ndarray:
    """The kernel's uint32[64] arguments: round keys, then the counter
    ``start`` mod 2^128 as four big-endian words."""
    if rk.dtype != np.uint32 or rk.shape != (60,):
        raise ValueError("rk: expected the 60 uint32 words of expand_key_256")
    start %= 1 << 128
    return np.concatenate([rk, np.array(
        [(start >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0)], dtype=np.uint32)])


def fold_plain(carry: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
    """Plain version of the fold: carry uint8 [8192], ks uint8 [m * 8192]
    -> uint8 [m * 8192] whose chunk j is carry ^ ks_0 ^ ... ^ ks_j (m
    refills of ``_take_bytes``), as a doubling XOR-scan over uint64 words."""
    if ks.numel() % BUF_SIZE or carry.numel() != BUF_SIZE:
        raise ValueError("fold_plain: expected an 8 KiB carry and whole chunks")
    m = ks.numel() // BUF_SIZE
    w = ks.reshape(m, BUF_SIZE).clone().view(torch.int64)
    w[0] ^= carry.reshape(BUF_SIZE).clone().view(torch.int64)
    d = 1
    while d < m:
        w[d:] ^= w[:-d].clone()
        d *= 2
    return w.view(torch.uint8).reshape(-1)


def fold_cuda(rk: np.ndarray, iv: int, pos: int, carry: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """The kernel's fold (csrc/aes256_ctr.cu, ``ringo_aes256_ctr_fold``):
    fills ``out``, uint8 [m * 8192] on the card, with ``fold_plain(carry,
    ks)`` for ks the keystream from byte ``pos`` of the stream of counter
    ``iv`` on.  One launch per 8 MiB; a launch after the first takes the
    last chunk of the one before as its carry."""
    backend.require(carry, torch.uint8, (BUF_SIZE,), name="carry")
    backend.require(out, torch.uint8, name="out")
    if not (carry.is_cuda and out.is_cuda) or out.dim() != 1 \
            or out.numel() % BUF_SIZE or not out.numel():
        raise ValueError("fold_cuda: expected a carry and whole 8 KiB chunks "
                         "on the card")
    m = out.numel() // BUF_SIZE
    for c0 in range(0, m, _FOLD_CHUNKS):
        mm = min(_FOLD_CHUNKS, m - c0)
        at = pos + c0 * BUF_SIZE
        src = carry if c0 == 0 else out[(c0 - 1) * BUF_SIZE:c0 * BUF_SIZE]
        args = _ctr_args(rk, iv + at // 16)
        err = backend.lib().ringo_aes256_ctr_fold(
            args.ctypes.data, at % 16, src.data_ptr(),
            out[c0 * BUF_SIZE:].data_ptr(), mm, backend.stream_ptr(out))
        backend.check(err, "aes256_ctr_fold")
        backend.LAUNCHES["aes"] += 1
    return out


_STAGING = {}   # device -> pinned host buffer of the copies back
_STAGING_LOCK = threading.Lock()


def ctr_keystream_cuda(rk: np.ndarray, iv: int, block0: int, n_blocks: int,
                       device) -> np.ndarray:
    """``ctr_keystream`` computed by the kernel on the card ``device``:
    launches of at most 64 MiB, each copied to the host through one pinned
    staging buffer that the calls share."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"ctr_keystream_cuda: {device} is not a CUDA device")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    res = np.empty(16 * n_blocks, dtype=np.uint8)
    with _STAGING_LOCK:
        for c0 in range(0, n_blocks, _LAUNCH_BLOCKS):
            nbytes = 16 * min(_LAUNCH_BLOCKS, n_blocks - c0)
            stage = _STAGING.get(device)
            if stage is None or stage.numel() < nbytes:
                stage = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                _STAGING[device] = stage
            dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
            ctr_blocks_cuda(rk, iv, block0 + c0, dev)
            stage[:nbytes].copy_(dev, non_blocking=True)
            torch.cuda.current_stream(device).synchronize()
            res[16 * c0:16 * c0 + nbytes] = stage[:nbytes].numpy()
    return res


def keystream(rk: np.ndarray, iv: int, block0: int, n_blocks: int,
              device: torch.device) -> np.ndarray:
    """Keystream bytes of counter blocks iv+block0 .. +n_blocks-1: the
    kernel on a CUDA device, the plain version on the CPU."""
    if device.type == "cuda":
        return ctr_keystream_cuda(rk, iv, block0, n_blocks, device)
    if device.type == "cpu":
        return ctr_keystream(rk, iv, block0, n_blocks)
    raise ValueError(f"no AES-CTR keystream on {device}")


# -------------------------------------------------------------- sampler

class UniformSampler:
    def __init__(self, seed: bytes | None = None, *, device):
        """Draws its keystream on ``device``: a CUDA device runs the
        kernel, the CPU the plain version.  ``window`` counter blocks are
        read ahead: ``WINDOW_BLOCKS`` on the card, ``PLAIN_WINDOW_BLOCKS``
        on the CPU."""
        if seed is None:
            seed = os.urandom(32)
        r = hashlib.sha384(seed).digest()
        self._rk = expand_key_256(r[:32])
        self._iv = int.from_bytes(r[32:48], "big")
        self.device = torch.device(device)
        self.window = (WINDOW_BLOCKS if self.device.type == "cuda"
                       else PLAIN_WINDOW_BLOCKS)
        self._win = np.zeros(0, dtype=np.uint8)  # keystream of blocks [w0, w1)
        self._w0 = self._w1 = 0
        self._consumed = 0  # keystream bytes consumed so far
        self._buf = np.zeros(BUF_SIZE, dtype=np.uint8)
        self._ptr = BUF_SIZE
        self._ahead = None  # the last read_ahead: (ext, its start, its refills)

    # -- keystream plumbing --------------------------------------------------

    def _keystream(self, n: int) -> np.ndarray:
        """The next n keystream bytes (``_keystream_at`` the consumed
        position), consumed."""
        ks = self._keystream_at(self._consumed, n)
        self._consumed += n
        return ks

    def _keystream_at(self, pos: int, n: int) -> np.ndarray:
        """n keystream bytes from byte ``pos``, sliced from the read-ahead
        window; a request that leaves it refills it with ``window`` blocks
        from the first block the request needs, and one larger than the
        window is drawn on its own and not kept."""
        b0 = pos // 16
        b1 = -(-(pos + n) // 16)
        if not self._w0 <= b0 <= b1 <= self._w1:
            if b1 - b0 > self.window:
                ks = keystream(self._rk, self._iv, b0, b1 - b0, self.device)
                return ks[pos - 16 * b0:pos - 16 * b0 + n]
            self._win = keystream(self._rk, self._iv, b0, self.window,
                                  self.device)
            self._w0, self._w1 = b0, b0 + self.window
        off = pos - 16 * self._w0
        return self._win[off:off + n]

    def _host_buf(self) -> np.ndarray:
        """The 8 KiB buffer on the host (copied back after a device draw)."""
        if isinstance(self._buf, torch.Tensor):
            self._buf = self._buf.cpu().numpy()
        return self._buf

    def _device_buf(self) -> torch.Tensor:
        """The 8 KiB buffer on the sampler's device (copied over after a
        host draw)."""
        if not isinstance(self._buf, torch.Tensor):
            self._buf = torch.from_numpy(self._buf.copy()).to(self.device)
        return self._buf

    def _snapshot(self):
        return (self._consumed, self._buf.copy() if isinstance(
            self._buf, np.ndarray) else self._buf.clone(), self._ptr)

    def _restore(self, snap):
        consumed, buf, ptr = snap
        self._consumed = consumed
        self._buf = buf.copy() if isinstance(buf, np.ndarray) else buf.clone()
        self._ptr = ptr

    def read(self, data: bytes) -> bytes:
        """io.Reader semantics: XOR keystream over ``data`` (bypasses the
        buffer, like the reference's Read)."""
        ks = self._keystream(len(data))
        return (np.frombuffer(data, dtype=np.uint8) ^ ks).tobytes()

    def _take_bytes(self, n: int) -> np.ndarray:
        buf = self._host_buf()
        out = np.empty(n, dtype=np.uint8)
        take = min(n, BUF_SIZE - self._ptr)
        out[:take] = buf[self._ptr:self._ptr + take]
        self._ptr += take
        rem = n - take
        if rem:
            # m refills at once: refill i leaves buf ^ ks_1 ^ ... ^ ks_i,
            # a cumulative XOR over uint64 words
            m = -(-rem // BUF_SIZE)
            ks = self._keystream(m * BUF_SIZE).reshape(m, BUF_SIZE).copy()
            ks[0] ^= buf
            words = ks.view("<u8")
            np.bitwise_xor.accumulate(words, axis=0, out=words)
            out[take:] = ks.reshape(-1)[:rem]
            self._buf = ks[-1].copy()
            self._ptr = rem - (m - 1) * BUF_SIZE
        return out

    def read_ahead(self, nbytes: int):
        """Read-ahead of at least ``nbytes`` stream bytes on the sampler's
        device, for a consumer that decides on the card how many it takes:
        (ext, start, avail), ext uint8 on the device holding the 8 KiB
        buffer and then m refills folded behind it (``fold_cuda`` on the
        card, ``fold_plain`` over the host keystream on the CPU), plus 8
        bytes of padding; the next byte ``_take_bytes`` would return is
        ext[start], and ``avail`` bytes from it are read ahead.  Changes
        no state: ``commit(used)`` does.  (``window`` is the host
        read-ahead's size in counter blocks, another thing.)"""
        buf = self._device_buf()
        ptr = self._ptr
        m = max(0, -(-(nbytes - (BUF_SIZE - ptr)) // BUF_SIZE))
        ext = torch.empty((m + 1) * BUF_SIZE + 8, dtype=torch.uint8,
                          device=self.device)
        ext[:BUF_SIZE].copy_(buf)
        ext[-8:].zero_()
        if m and self.device.type == "cuda":
            fold_cuda(self._rk, self._iv, self._consumed, buf,
                      ext[BUF_SIZE:-8])
        elif m:
            ks = self._keystream_at(self._consumed, m * BUF_SIZE)
            ext[BUF_SIZE:-8] = fold_plain(buf, torch.from_numpy(ks.copy()))
        self._ahead = (ext, ptr, m)
        return ext, ptr, (m + 1) * BUF_SIZE - ptr

    def commit(self, used: int) -> None:
        """Take ``used`` bytes of the last ``read_ahead``: leaves the sampler
        as ``_take_bytes(used)`` would have left it (its buffer on the
        device)."""
        ext, ptr, m = self._ahead
        if ptr != self._ptr:
            raise RuntimeError("commit: the sampler moved since its read-ahead")
        self._ahead = None
        if ptr + used <= BUF_SIZE:
            self._ptr += used
            return
        rem = used - (BUF_SIZE - ptr)
        k = -(-rem // BUF_SIZE)
        if k > m:
            raise ValueError(f"commit: {used} bytes exceed the read-ahead")
        self._buf = ext[k * BUF_SIZE:(k + 1) * BUF_SIZE]
        self._ptr = rem - (k - 1) * BUF_SIZE
        self._consumed += k * BUF_SIZE

    def _take_bytes_device(self, n: int) -> torch.Tensor:
        """``_take_bytes`` as a uint8 [n] tensor on the sampler's device,
        to be read only (it shares memory with the buffer): a slice of the
        buffer, or of a ``read_ahead``, committed, when it needs refills."""
        if self._ptr + n <= BUF_SIZE:
            buf, ptr = self._device_buf(), self._ptr
            self._ptr += n
            return buf[ptr:ptr + n]
        ext, start, _ = self.read_ahead(n)
        self.commit(n)
        return ext[start:start + n]

    # -- sampling ------------------------------------------------------------

    def sample(self) -> int:
        return int(self.sample_u64(1)[0])

    def sample_u64(self, count: int) -> np.ndarray:
        return self._take_bytes(8 * count).view("<u8")

    def sample_u64_device(self, count: int) -> torch.Tensor:
        """``sample_u64`` on the sampler's device: the raw uint64 bits as
        int64 [count]."""
        b = self._take_bytes_device(8 * count)
        if b.storage_offset() % 8:     # an int64 view needs 8-byte alignment
            b = b.clone()
        return b.view(torch.int64)

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

    def sample_float_device(self, count: int = 1) -> torch.Tensor:
        """``sample_float`` on the sampler's device: float64 [count], the
        same bits mapped the same way (exact)."""
        return u64_to_unit_float(self.sample_u64_device(count))


def u64_to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """Raw uint64 draws (int64) -> floats in [0, 1) as ``sample_float``
    maps them: the low 52 bits OR the exponent 1075, over 2^52, minus 1."""
    bits = (u & ((1 << FLOAT_PREC) - 1)) | ((1023 + FLOAT_PREC) << FLOAT_PREC)
    return bits.view(torch.float64) / float(1 << FLOAT_PREC) - 1.0
