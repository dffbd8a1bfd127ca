"""The host side of the port's evaluation proof against the JAX package:
the SHAKE128 oracle, the statement binding, challenge encodings over both
rings, the evaluation vectors, and the encoder's plain encode and decode
(the reference on its numpy path).  Exact equality."""

import numpy as np
import pytest
import torch

from ringo_tpu import jindo
from ringo_tpu.fields import ZP255
from ringo_tpu.jindo import challenge as ref_chal
from ringo_tpu.utils.transcript import Shake128Stream as RefStream
import ringo_tpu_torch.jindo as tj
from ringo_tpu_torch.fields import ZP255 as PORT_ZP255
from ringo_tpu_torch.jindo import challenge
from ringo_tpu_torch.rings.rns import RnsRing
from ringo_tpu_torch.utils.transcript import Shake128Stream

X = 98765432123456789 ** 3


@pytest.fixture(scope="module", params=[1, 3], ids=["t1", "t3"])
def params(request):
    t = request.param
    return (jindo.new_parameters(ZP255, 1 << 8, t),
            tj.new_parameters(PORT_ZP255, 1 << 8, t))


def test_stream_semantics_match():
    a, b = RefStream(), Shake128Stream()
    for s in (a, b):
        s.write(b"abc")
        s.write(b"")
        s.write(bytes(range(200)))
    assert a.read(5) == b.read(5)
    assert a.read(300) == b.read(300)       # continues, past one block
    assert a.read(0) == b.read(0) == b""
    with pytest.raises(RuntimeError):
        b.write(b"late")
    a.reset(), b.reset()
    b.write(b"again")
    a.write(b"again")
    assert a.read(16) == b.read(16)


def test_read_challenges_is_the_sequence_of_reads():
    a, b = RefStream(), Shake128Stream()
    a.write(b"seed"), b.write(b"seed")
    assert challenge.read_challenges(b, 7) == [a.read(16) for _ in range(7)]
    assert b.read(3) == a.read(3)


class _Raw:
    def __init__(self, data):
        self.data = data

    def raw_bytes(self):
        return self.data


def test_bind_statement_replays_the_reference_order(params):
    ref_p, p = params
    ck, coms = _Raw(b"crs-bytes"), [_Raw(bytes([i]) * 40) for i in range(p.batch)]
    oracle, batch_bytes = challenge.bind_statement(p, ck, coms, X)

    def absorb(o):   # ringo_tpu/jindo/prover.py, evaluate
        o.write(b"crs-bytes")
        for c in coms:
            o.write(c.raw_bytes())
        o.write(ZP255.marshal(X))

    want = RefStream()
    absorb(want)
    if p.batch == 1:
        assert batch_bytes is None
    else:
        wb = [want.read(16) for _ in range(p.batch)]
        assert batch_bytes == wb
        want.reset()
        absorb(want)
        want.write(b"".join(wb))
    assert oracle.read(64) == want.read(64)


@pytest.mark.parametrize("which", ["ring_q", "ring_q_out"])
def test_encode_challenges_match(params, which):
    ref_p, p = params
    rng = np.random.default_rng(5)
    chals = [rng.bytes(16) for _ in range(5)] + [b"\0" * 16, b"\xff" * 16]
    want = ref_chal.encode_challenges(ref_p, getattr(ref_p, which), chals)
    got = challenge.encode_challenges(p, getattr(p, which), chals)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(RnsRing.to_planes(got).numpy(), want)


def test_left_and_right_vec_match(params):
    ref_p, p = params
    for x in (0, 1, X, ZP255.p - 1, ZP255.p + 5):
        assert challenge.left_vec(p, x) == ref_chal.left_vec(ref_p, x)
        assert challenge.right_vec(p, x) == ref_chal.right_vec(ref_p, x)


def test_encode_scalars_and_encode_match(params):
    ref_p, p = params
    ints = [0, 1, ZP255.p - 1, X % ZP255.p, 60272, ZP255.p + 3]
    want = jindo.Encoder(ref_p).encode_scalars(ints)
    ecd = tj.Encoder(p)
    got = ecd.encode_scalars(ints)
    np.testing.assert_array_equal(RnsRing.to_planes(got).numpy(), want)
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1 << 16, (ZP255.w, 3, 2, p.slots), dtype=np.uint32)
    vals[-1] %= np.uint32(ZP255.p_digits[-1])
    want = jindo.Encoder(ref_p).encode(vals)
    got = ecd.encode(torch.from_numpy(vals.astype(np.int64)))
    np.testing.assert_array_equal(RnsRing.to_planes(got).numpy(), want)


def test_decode_matches_and_inverts_encode(params):
    ref_p, p = params
    ring = p.ring_q
    rng = np.random.default_rng(11)
    # a challenge polynomial (small signed coefficients) and a wide one
    small = challenge.encode_challenges(p, ring, [rng.bytes(16)])[:, 0]
    wide = torch.from_numpy(np.stack(
        [rng.integers(0, q, p.degree) for q in ring.primes]).astype(np.int32))
    ecd, ref_ecd = tj.Encoder(p), jindo.Encoder(ref_p)
    for poly in (ring.intt_imform(small), wide):
        want = ref_ecd.decode(np.asarray(RnsRing.to_planes(poly).numpy(),
                                         dtype=np.uint32))
        assert ecd.decode(poly) == [int(v) for v in want]
    vals = [5, ZP255.p - 7] + [int(v) for v in rng.integers(0, 1 << 62, p.slots - 2)]
    digits = torch.zeros((ZP255.w, p.slots), dtype=torch.int64)
    for i, v in enumerate(vals):
        digits[:, i] = torch.tensor(PORT_ZP255.to_digits_int(v))
    assert ecd.decode(ring.intt_imform(ecd.encode(digits))) == vals
