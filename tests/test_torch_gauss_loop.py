"""The Gaussian loop's plain version (``gauss_loop_plain``) through the
same host protocol as the card's (``_draw``: launch, state read, settle or
read further ahead, resume, commit), on the CPU, against the port's numpy
samplers and the JAX package's at the same seeds.  Exact int64 equality,
and both streams' state after the call.

* COSAC at the commit's three sigma classes, bfv's 4.79 and all of them
  mixed (tests/test_torch_gauss_device.py's CASES, 16,384 lanes), and the
  mask-noise rounded draw: at the default margin in one launch, at 2^-3
  with "flagged" resumes (the host rule on the same draws), and with
  read-aheads small enough that "window exhausted" resumes come several
  times a call;
* ``read_ahead`` + ``commit`` against ``_take_bytes``: nothing used,
  within the buffer, to its end, across refills, from odd offsets;
* a std_dev <= 0 raises before any stream moves;
* a Python transcription of the loop kernel's compaction (contiguous
  segments, chunk ranks from warp ballots, the blocks' prefix) keeps lane
  order at grid sizes from 1 to more blocks than lanes.
"""

import numpy as np
import pytest
import torch

from ringo_tpu.csprng import COSACSampler as RefCOSAC
from ringo_tpu.csprng import RoundedGaussianSampler as RefRounded
from ringo_tpu.csprng import UniformSampler as RefUniform
from ringo_tpu_torch.csprng import gaussian, uniform

BLIND, MASK, MASK_BLIND, BFV = 1154200.66, 1733.25, 417865273.07, 4.79
NOISE = 2451.10   # the mask column's noise
LANES = 64 * 256
CASES = {
    "blind": (BLIND, LANES),
    "mask": (MASK, LANES),
    "mask_blind": (MASK_BLIND, 256),
    "bfv": (BFV, LANES),
    "mixed": (None, LANES),
}
MODES = {   # (margin, read-ahead bytes of a stream)
    "default": (None, None),
    "flagged": (2.0 ** -3, None),
    "exhausted": (None, 4096),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mode(request, monkeypatch):
    margin, window = MODES[request.param]
    if margin is not None:
        monkeypatch.setattr(gaussian, "MARGIN", margin)
    if window is not None:   # every read-ahead of that size
        monkeypatch.setattr(gaussian, "LANE_BYTES",
                            {k: (0, 0) for k in gaussian.LANE_BYTES})
        monkeypatch.setattr(gaussian, "WINDOW_SLACK", window)
    return request.param


def _sigmas(name: str):
    sigma, n = CASES[name]
    if sigma is None:
        return np.repeat([BLIND, MASK, MASK_BLIND, BFV], n // 4), n
    return sigma, n


def _same_state(a: uniform.UniformSampler, b: uniform.UniformSampler):
    assert (a._consumed, a._ptr) == (b._consumed, b._ptr)
    np.testing.assert_array_equal(a._host_buf(), b._host_buf())


def _check_exits(mode: str, exhausted: int):
    """The last call's exits in ``mode``: none, some flagged, or at least
    ``exhausted`` read-aheads too short."""
    last = gaussian.LAST
    assert last["launches"] == len(last["exits"]) + 1
    if mode == "default":
        assert last["exits"] == []
    elif mode == "flagged":
        assert "flagged" in last["exits"]
    else:
        assert last["exits"].count("window exhausted") >= exhausted
    assert last["phases"] > 0
    assert all(u <= a for u, a in zip(last["used"], last["read_ahead"]))


@pytest.mark.parametrize("mode", tuple(MODES), indirect=True)
@pytest.mark.parametrize("name", tuple(CASES))
def test_cosac_loop_matches_numpy_and_jax(name, mode):
    s, n = _sigmas(name)
    c = np.random.default_rng(len(name)).uniform(-3.0, 3.0, n)
    seed = b"loop " + name.encode()
    ref = RefCOSAC(seed)
    host = gaussian.COSACSampler(seed, device="cpu")
    dev = gaussian.COSACSampler(seed, device="cpu")
    for smp in (ref.base, host.base, dev.base):   # draws from an odd offset
        smp._take_bytes(28 * 3 + 1)
    want = host.sample(c, s)
    np.testing.assert_array_equal(ref.sample(c, s), want)
    syncs = gaussian.SYNCS
    got = dev.sample_device(torch.from_numpy(c), s if np.isscalar(s)
                            else torch.from_numpy(np.asarray(s)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    _same_state(host.base, dev.base)
    _same_state(host.rounded.base, dev.rounded.base)
    _check_exits(mode, 3 if n > 256 else 1)
    settles = gaussian.LAST["exits"].count("flagged")
    assert gaussian.SYNCS - syncs == gaussian.LAST["launches"] + settles
    # the next draws of both streams continue alike
    np.testing.assert_array_equal(dev.base._take_bytes(40),
                                  host.base._take_bytes(40))
    np.testing.assert_array_equal(dev.rounded.base._take_bytes(8),
                                  host.rounded.base._take_bytes(8))


@pytest.mark.parametrize("mode", tuple(MODES), indirect=True)
def test_rounded_loop_matches_numpy_and_jax(mode):
    seed, n = b"loop noise", 10752
    ref = RefRounded(seed).sample(0.0, NOISE, n)
    host = gaussian.RoundedGaussianSampler(seed, device="cpu")
    dev = gaussian.RoundedGaussianSampler(seed, device="cpu")
    want = host.sample(0.0, NOISE, n)
    got = dev.sample_device(0.0, NOISE, n)
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got.numpy(), want)
    _same_state(host.base, dev.base)
    _check_exits(mode, 1)
    # a centre and sigma per lane, from an odd offset
    c = np.random.default_rng(5).uniform(-9.0, 9.0, n)
    sd = np.linspace(0.5, 40.0, n)
    host.base._take_bytes(13)
    dev.base._take_bytes(13)
    np.testing.assert_array_equal(
        dev.sample_device(torch.from_numpy(c), torch.from_numpy(sd), n).numpy(),
        host.sample(c, sd, n))
    _same_state(host.base, dev.base)


@pytest.mark.parametrize("bad", ["zero", "negative lane", "zero, no lanes"])
def test_std_dev_not_positive_raises_and_moves_nothing(bad):
    seed, n = b"loop bad sigma", 0 if bad == "zero, no lanes" else 3000
    dev = gaussian.RoundedGaussianSampler(seed, device="cpu")
    twin = gaussian.RoundedGaussianSampler(seed, device="cpu")
    for smp in (dev.base, twin.base):
        smp._take_bytes(8190)                 # two bytes left in the buffer
    sd = torch.full((n,), 3.0, dtype=torch.float64)
    if bad == "negative lane":
        sd[n - 7] = -1.0
    else:
        sd = 0.0
    with pytest.raises(ValueError):
        twin.sample(0.0, sd, n)
    with pytest.raises(ValueError):
        dev.sample_device(0.0, sd, n)
    _same_state(dev.base, twin.base)
    np.testing.assert_array_equal(
        dev.sample_device(0.0, 3.0, n).numpy(), twin.sample(0.0, 3.0, n))
    _same_state(dev.base, twin.base)


@pytest.mark.parametrize("start", [0, 3, 8191])
@pytest.mark.parametrize("used", ["none", "within", "to the end", "across"])
def test_read_ahead_and_commit_match_take_bytes(start, used):
    seed = b"ahead %d" % start
    ref, host = RefUniform(seed), uniform.UniformSampler(seed, device="cpu")
    dev = uniform.UniformSampler(seed, device="cpu")
    for s in (ref, host, dev):
        s._take_bytes(start)
    room = uniform.BUF_SIZE - start
    k = {"none": 0, "within": min(5, room), "to the end": room,
         "across": room + 3 * uniform.BUF_SIZE + 77}[used]
    ext, at, avail = dev.read_ahead(k + 1000)
    assert avail >= k + 1000 and ext.numel() >= at + avail + 8
    want = ref._take_bytes(k + 1000)
    np.testing.assert_array_equal(ext[at:at + k + 1000].numpy(), want)
    np.testing.assert_array_equal(host._take_bytes(k), want[:k])
    dev.commit(k)
    _same_state(host, dev)
    np.testing.assert_array_equal(dev._take_bytes(1000), want[k:])
    np.testing.assert_array_equal(host._take_bytes(1000), want[k:])


def test_commit_checks_its_read_ahead():
    s = uniform.UniformSampler(b"ahead checks", device="cpu")
    s.read_ahead(100)
    with pytest.raises(ValueError):
        s.commit(3 * uniform.BUF_SIZE)
    s.read_ahead(100)
    s._take_bytes(8)
    with pytest.raises(RuntimeError):
        s.commit(8)


def _compaction_model(pred: np.ndarray, grid: int, threads: int = 256):
    """csrc/gaussian.cu's compaction of the lanes where ``pred`` holds,
    step by step: block b takes the contiguous segment
    [b * seg, (b + 1) * seg), counts it, and after the barrier ranks each
    chunk of ``threads`` lanes by its warps' ballots and the warps' totals,
    behind the counts of the blocks before it."""
    L = len(pred)
    seg = -(-L // grid)
    bounds = [(min(L, b * seg), min(L, b * seg + seg)) for b in range(grid)]
    counts = [int(pred[lo:hi].sum()) for lo, hi in bounds]
    out = np.full(int(pred.sum()), -1)
    for b, (lo, hi) in enumerate(bounds):
        r0 = sum(counts[:b])
        for base in range(lo, hi, threads):
            ks = base + np.arange(threads)
            p = (ks < hi) & pred[np.minimum(ks, L - 1)]
            warps = p.reshape(-1, 32)
            for t in np.nonzero(p)[0]:
                w, lane = divmod(int(t), 32)
                out[r0 + warps[:w].sum() + warps[w, :lane].sum()] = ks[t]
            r0 += int(p.sum())
    return out


@pytest.mark.parametrize("lanes,grid", [(1, 1), (5000, 1), (5000, 7),
                                        (147712, 264), (100, 264)])
def test_compaction_keeps_lane_order(lanes, grid):
    pred = np.random.default_rng(lanes + grid).random(lanes) < 0.4
    np.testing.assert_array_equal(_compaction_model(pred, grid),
                                  np.nonzero(pred)[0])
