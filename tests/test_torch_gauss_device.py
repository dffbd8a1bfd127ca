"""The device half of the samplers on the CPU (the plain versions of the
AES fold and of the Gaussian wavefront) against the port's numpy samplers
and the JAX package's, at the same seeds.  Exact int64 equality.

* ``COSACSampler.sample_device`` at the commit's three sigma classes, bfv's
  4.79 and all of them mixed in one call; ``RoundedGaussianSampler.
  sample_device`` at the commit's mask-noise sigma; the Ziggurat's wedge and
  tail both reached;
* the same with a margin wide enough that thousands of lanes are decided by
  the host rule;
* the stream hand-off: device draws, host draws (``_take_bytes(32)``,
  ``sample_field_digits`` at ZP220, 28 bytes a value), device draws again,
  from an odd byte offset, equal to all-host draws;
* ``fold_plain`` against ``_take_bytes`` across chunk boundaries and
  against the uint64-word host fold, and a Python transcription of the
  fold kernel's segments and scans against ``fold_plain``;
* the CPU path launches no kernel and the CUDA wrappers refuse CPU tensors.

The Jindo commit at N = 2^10 through the device draws is held to the JAX
package's fixture by tests/test_torch_commit.py."""

import numpy as np
import pytest
import torch

from ringo_tpu.csprng import COSACSampler as RefCOSAC
from ringo_tpu.csprng import RoundedGaussianSampler as RefRounded
from ringo_tpu.csprng import UniformSampler as RefUniform
from ringo_tpu_torch import backend
from ringo_tpu_torch.csprng import gaussian, uniform
from ringo_tpu_torch.fields import ZP220
from ringo_tpu_torch.jindo.prover import sample_field_digits

# the commit's sigma classes at ZP255, N = 2^19 (blind, mask, mask blind),
# and bfv's twin-CDT sigma
BLIND, MASK, MASK_BLIND, BFV = 1154200.66, 1733.25, 417865273.07, 4.79
NOISE = 2451.10   # the mask column's noise
LANES = 64 * 256


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _centers(n: int, seed: int) -> np.ndarray:
    """Drift-centre-like centres: fractions around small integers."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-3.0, 3.0, n)


def _cosac_all(seed: bytes, c: np.ndarray, s):
    """(JAX package's, port's numpy, port's device on the CPU) samples and
    the two port samplers."""
    ref = RefCOSAC(seed).sample(c, s)
    host = gaussian.COSACSampler(seed, device="cpu")
    dev = gaussian.COSACSampler(seed, device="cpu")
    want = host.sample(c, s)
    got = dev.sample_device(torch.from_numpy(c), s if np.isscalar(s)
                            else torch.from_numpy(np.asarray(s)))
    return ref, want, got.numpy(), host, dev


def _same_state(a: uniform.UniformSampler, b: uniform.UniformSampler):
    assert (a._consumed, a._ptr) == (b._consumed, b._ptr)
    np.testing.assert_array_equal(a._host_buf(), b._host_buf())


CASES = {
    "blind": (BLIND, LANES),
    "mask": (MASK, LANES),
    "mask_blind": (MASK_BLIND, 256),
    "bfv": (BFV, LANES),
    "mixed": (None, LANES),
}


def _sigmas(name: str):
    sigma, n = CASES[name]
    if sigma is None:
        return np.repeat([BLIND, MASK, MASK_BLIND, BFV], n // 4), n
    return sigma, n


@pytest.mark.parametrize("margin", ["default", "wide"])
@pytest.mark.parametrize("name", tuple(CASES))
def test_cosac_device_matches_numpy(name, margin, monkeypatch):
    if margin == "wide":
        monkeypatch.setattr(gaussian, "MARGIN", 2.0 ** -3)
    settled = []
    settle = gaussian._settle
    monkeypatch.setattr(gaussian, "_settle", lambda dec, k, rule, *a, **kw: (
        settled.append(k), settle(dec, k, rule, *a, **kw))[1])
    s, n = _sigmas(name)
    c = _centers(n, len(name))
    ref, want, got, host, dev = _cosac_all(b"cosac " + name.encode(), c, s)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)
    _same_state(host.base, dev.base)
    _same_state(host.rounded.base, dev.rounded.base)
    if margin == "wide" and n > 256:
        assert sum(settled) > 100     # the host rule decided many lanes


def test_wavefront_reaches_wedge_and_tail(monkeypatch):
    ops = []
    step = gaussian.gauss_step
    monkeypatch.setattr(gaussian, "gauss_step",
                        lambda op, n, **kw: (ops.append(op), step(op, n, **kw))[1])
    s, n = _sigmas("mixed")
    ref, want, got, _, _ = _cosac_all(b"wedge and tail", _centers(n, 9), s)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, want)
    for op in (gaussian.ZIG, gaussian.WEDGE, gaussian.TAIL, gaussian.DIRECT,
               gaussian.COSAC):
        assert op in ops, gaussian.OPS[op]


@pytest.mark.parametrize("margin", ["default", "wide"])
def test_rounded_device_matches_numpy(margin, monkeypatch):
    if margin == "wide":
        monkeypatch.setattr(gaussian, "MARGIN", 2.0 ** -3)
    seed = b"noise mask"
    n = 10752
    ref = RefRounded(seed).sample(0.0, NOISE, n)
    host = gaussian.RoundedGaussianSampler(seed, device="cpu")
    dev = gaussian.RoundedGaussianSampler(seed, device="cpu")
    want = host.sample(0.0, NOISE, n)
    got = dev.sample_device(0.0, NOISE, n)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got.numpy(), want)
    # a centre and sigma per lane, as tensors
    c = _centers(n, 4)
    sd = np.linspace(1.0, 5.0, n)
    np.testing.assert_array_equal(
        dev.sample_device(torch.from_numpy(c), torch.from_numpy(sd), n).numpy(),
        host.sample(c, sd, n))
    _same_state(host.base, dev.base)
    with pytest.raises(ValueError):
        dev.sample_device(0.0, 0.0, 4)
    assert dev.sample_device(0.0, NOISE, 0).shape == (0,)
    assert gaussian.COSACSampler(seed, device="cpu").sample_device(
        torch.zeros(0, dtype=torch.float64), MASK).shape == (0,)


def _handoff(s: uniform.UniformSampler, device: bool):
    """Device draws (or their host twins), host draws, device draws."""
    u64 = s.sample_u64_device if device else s.sample_u64
    flt = s.sample_float_device if device else s.sample_float
    out = [s._take_bytes(3)]                      # an odd byte offset
    out.append(u64(1001))
    out.append(s._take_bytes(32))
    out.append(sample_field_digits(ZP220, 37, s).numpy())
    out.append(flt(3000))
    out.append(s._take_bytes(5))
    out.append(u64(2 * 1024 + 1))                  # across two refills
    out.append(sample_field_digits(ZP220, 300, s).numpy())
    out.append(flt(1))
    return [np.asarray(o.numpy() if isinstance(o, torch.Tensor) else o)
            for o in out]


def test_stream_handoff():
    seed = b"hand-off"
    host = uniform.UniformSampler(seed, device="cpu")
    dev = uniform.UniformSampler(seed, device="cpu")
    want, got = _handoff(host, False), _handoff(dev, True)
    for w, g in zip(want, got):
        if w.dtype == np.uint64:
            g = g.view(np.uint64)
        np.testing.assert_array_equal(g, w)
    _same_state(host, dev)
    ref = RefUniform(seed)
    ref._take_bytes(3)
    np.testing.assert_array_equal(ref.sample_u64(1001), want[1])


def _host_fold(carry: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """The refills' fold byte by byte: a uint8 cumulative XOR over chunks."""
    m = len(ks) // uniform.BUF_SIZE
    k = ks.reshape(m, uniform.BUF_SIZE).copy()
    k[0] ^= carry
    np.bitwise_xor.accumulate(k, axis=0, out=k)
    return k.reshape(-1)


def _fold_kernel_model(carry: np.ndarray, ks: np.ndarray) -> np.ndarray:
    """csrc/aes256_ctr.cu's fold kernel step by step: blocks of 4 columns x
    256 segments of ceil(m / 256) chunks, each thread's running XOR down its
    segment, the warp scan over lanes 4 apart, the warps' totals in order,
    the carry in front; the keystream's 16-byte columns taken as given."""
    m = len(ks) // uniform.BUF_SIZE
    cols = ks.view("<u8").reshape(m, 512, 2)
    seg = -(-m // 256)
    out = np.zeros_like(cols)
    car = carry.view("<u8").reshape(512, 2)
    for blk in range(128):
        acc = np.zeros((1024, 2), np.uint64)
        pre = np.zeros((1024, seg, 2), np.uint64)
        for t in range(1024):
            c, g = blk * 4 + t % 4, t // 4
            for k in range(seg):
                if g * seg + k < m:
                    acc[t] ^= cols[g * seg + k, c]
                pre[t, k] = acc[t]
        incl = acc.copy()
        for d in (4, 8, 16):
            prev = incl.copy()
            for t in range(1024):
                if t % 32 >= d:
                    incl[t] ^= prev[t - d]
        warp_tot = incl.reshape(32, 32, 2)[:, 28:]
        for t in range(1024):
            c, g, w = blk * 4 + t % 4, t // 4, t // 32
            p = car[c] ^ incl[t] ^ acc[t]
            for ww in range(w):
                p = p ^ warp_tot[ww, t % 4]
            for k in range(seg):
                if g * seg + k < m:
                    out[g * seg + k, c] = p ^ pre[t, k]
    return out.view(np.uint8).reshape(-1)


@pytest.mark.parametrize("m", [1, 3, 300, 1024])
def test_fold_plain(m):
    rng = np.random.default_rng(m)
    carry = rng.integers(0, 256, uniform.BUF_SIZE, dtype=np.uint8)
    ks = rng.integers(0, 256, m * uniform.BUF_SIZE, dtype=np.uint8)
    got = uniform.fold_plain(torch.from_numpy(carry), torch.from_numpy(ks))
    np.testing.assert_array_equal(got.numpy(), _host_fold(carry, ks))
    if m in (3, 300):
        np.testing.assert_array_equal(_fold_kernel_model(carry, ks), got.numpy())


@pytest.mark.parametrize("start", [0, 5, 8191])
def test_fold_matches_take_bytes(start):
    """The sampler's refills, drawn at once across chunk boundaries: the
    host's word-wide fold, the device draw's ``fold_plain`` and the JAX
    package's refill loop agree."""
    seed = b"fold %d" % start
    ref, host = RefUniform(seed), uniform.UniformSampler(seed, device="cpu")
    dev = uniform.UniformSampler(seed, device="cpu")
    for s in (ref, host, dev):
        s._take_bytes(start)
    n = 5 * uniform.BUF_SIZE + 77
    want = ref._take_bytes(n)
    np.testing.assert_array_equal(host._take_bytes(n), want)
    np.testing.assert_array_equal(dev._take_bytes_device(n).numpy(), want)
    _same_state(host, dev)


def test_cpu_path_launches_nothing_and_cuda_wrappers_refuse_the_cpu():
    before = dict(backend.LAUNCHES)
    s = gaussian.COSACSampler(b"no launch", device="cpu")
    s.sample_device(torch.zeros(512, dtype=torch.float64), MASK)
    assert backend.LAUNCHES == before
    r = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        gaussian.gauss_cuda(gaussian.ZIG, 8, r=r)
    with pytest.raises(ValueError):
        uniform.fold_cuda(np.zeros(60, np.uint32), 0, 0,
                          torch.zeros(uniform.BUF_SIZE, dtype=torch.uint8),
                          torch.empty(uniform.BUF_SIZE, dtype=torch.uint8))
