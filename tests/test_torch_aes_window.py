"""The read-ahead window of the port's UniformSampler against the JAX
package's sampler (pyca cryptography, one keystream call per refill):
request sequences that fall inside, at the edge of and across the window,
draws larger than it, rewinds into and before it, sample_n's rejection
replay, read, and a counter that wraps at 2^128, each at windows of 1
block, 513 blocks and the card's default.  Exact equality.  Then: every
owner of a sampler hands it its own device, a sampler without a device is
an error, and the kernel's wrappers refuse the CPU."""

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from ringo_tpu.csprng import UniformSampler as RefSampler
from ringo_tpu_torch.csprng import uniform

WINDOWS = (1, 513, uniform.WINDOW_BLOCKS)
BIG = (1 << 63) + 1   # about half the u64 draws are rejected
OWNER_DEVICE = torch.device("cpu", 0)


def _edges(s, W):
    """Reads that end inside the window, exactly at its last byte and one
    byte past it, then one larger than the window, then refills."""
    return [s.read(bytes(5)), s.read(bytes(16 * W - 8)), s.read(bytes(3)),
            s.read(bytes(1)), s.read(bytes(16 * W + 7)),
            s._take_bytes(20000), s.sample_u64(3000)]


def _larger(s, W):
    return [s._take_bytes(32 * W + 3 * 8192 + 5), s.sample_u64(100),
            s._take_bytes(7)]


def _rewind_inside(s, W):
    out = [s._take_bytes(100)]
    snap = s._snapshot()
    out.append(s._take_bytes(8200))
    s._restore(snap)
    return out + [s._take_bytes(9000), s.sample_float(500)]


def _rewind_before(s, W):
    out = [s._take_bytes(10)]
    snap = s._snapshot()
    out += [s.read(bytes(48 * W + 11)), s._take_bytes(2 * 8192)]
    s._restore(snap)
    return out + [s._take_bytes(3 * 8192 + 1), s.read(bytes(33))]


def _replay(s, W):
    return [s.sample_n(BIG, 40), s.sample_n(33556993, 500),
            s.sample_n(BIG, 1100), s.sample_u64(9)]


def _wrap(s, W):
    return [s._take_bytes(3 * 8192 + 7), s.read(b"io.Reader bytes" * 3),
            s.sample_u64(100)]


SEQUENCES = dict(edges=_edges, larger=_larger, rewind_inside=_rewind_inside,
                 rewind_before=_rewind_before, replay=_replay, wrap=_wrap)


def _set_iv(ref, port, iv: int):
    """Both samplers on counter ``iv`` (the JAX one rebuilt as its own
    ``_restore`` rebuilds it)."""
    ref._iv = iv.to_bytes(16, "big")
    ref._enc = Cipher(algorithms.AES(ref._key), modes.CTR(ref._iv)).encryptor()
    port._iv = iv


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", tuple(SEQUENCES))
def test_window_matches_reference(name, window):
    ref = RefSampler(b"window " + name.encode())
    port = uniform.UniformSampler(b"window " + name.encode(), device="cpu")
    port.window = window
    if name == "wrap":
        _set_iv(ref, port, (1 << 128) - 2)
    for a, b in zip(SEQUENCES[name](ref, window),
                    SEQUENCES[name](port, window)):
        if isinstance(a, bytes):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
    assert port._consumed == ref._consumed


def test_default_window_by_device():
    assert uniform.UniformSampler(b"s", device="cpu").window == \
        uniform.PLAIN_WINDOW_BLOCKS
    assert uniform.UniformSampler(b"s", device="cuda").window == \
        uniform.WINDOW_BLOCKS   # built without touching the card


def test_sampler_without_device_is_an_error():
    from ringo_tpu_torch.csprng import gaussian

    with pytest.raises(TypeError):
        uniform.UniformSampler(b"s")
    with pytest.raises(TypeError):
        gaussian.RoundedGaussianSampler(b"s")
    with pytest.raises(TypeError):
        gaussian.COSACSampler(b"s")
    with pytest.raises(TypeError):
        gaussian.TwinCDTGaussianSampler(4.79, b"s")


def test_every_owner_hands_its_device(monkeypatch):
    """Each owner of a sampler gives it its own device (cpu:0, which a
    hard-coded "cpu" would not equal): the Jindo prover (uniform and
    rounded), the encoder's COSAC (and its rounded sampler), the commit
    key's CRS expansion, the Buckler prover and BGV."""
    from ringo_tpu_torch import buckler, jindo
    from ringo_tpu_torch.fields import ZP220, ZP255
    from ringo_tpu_torch.jindo import entities
    from ringo_tpu_torch.rings.bigring import CyclicRing
    from ringo_tpu_torch.schemes import BGV, BGVParams

    crs_samplers = []

    def noting(*args, **kw):
        crs_samplers.append(uniform.UniformSampler(*args, **kw))
        return crs_samplers[-1]

    monkeypatch.setattr(entities, "UniformSampler", noting)
    params = jindo.new_parameters(ZP255, 1 << 10, 1)
    prv = jindo.Prover(params, b"crs", seed=b"s", device=OWNER_DEVICE)
    ring = CyclicRing(ZP220, 16, device=OWNER_DEVICE)
    bk = buckler.Prover(params, ring, None, None, prv, [], [], seed=b"s")
    bgv = BGV(BGVParams(6, [40, 40], 17, device=OWNER_DEVICE), seed=b"s")
    owned = dict(jindo_uniform=prv.uniform, jindo_rounded=prv.rounded.base,
                 cosac=prv.ecd.cosac.base,
                 cosac_rounded=prv.ecd.cosac.rounded.base,
                 commit_key=crs_samplers[0], buckler=bk.uniform,
                 bgv_uniform=bgv.uniform, bgv_gauss=bgv.gauss.base)
    assert len(crs_samplers) == 1
    for name, s in owned.items():
        assert s.device == OWNER_DEVICE, name


def test_cuda_wrappers_refuse_the_cpu():
    rk = uniform.expand_key_256(bytes(32))
    with pytest.raises(ValueError):
        uniform.ctr_blocks_cuda(rk, 0, 0, torch.empty(64, dtype=torch.uint8))
    with pytest.raises(ValueError):
        uniform.ctr_keystream_cuda(rk, 0, 0, 4, "cpu")
    with pytest.raises(TypeError):
        uniform.ctr_blocks_cuda(rk, 0, 0, torch.empty(16, dtype=torch.int32))
    with pytest.raises(ValueError):
        uniform.keystream(rk, 0, 0, 4, torch.device("meta"))


def test_refills_share_one_window(monkeypatch):
    """A sampler with the card's window serves 100 refills of 8 KiB from
    one keystream call; with one refill's window, from one call each."""
    calls = []
    real = uniform.keystream

    def counting(rk, iv, block0, n_blocks, device):
        calls.append(n_blocks)
        return real(rk, iv, block0, n_blocks, device)

    monkeypatch.setattr(uniform, "keystream", counting)
    for window, want in ((uniform.WINDOW_BLOCKS, [uniform.WINDOW_BLOCKS]),
                         (512, [512] * 100)):
        calls.clear()
        s = uniform.UniformSampler(b"refills", device="cpu")
        s.window = window
        for _ in range(100):
            s._take_bytes(8192)
        assert calls == want
