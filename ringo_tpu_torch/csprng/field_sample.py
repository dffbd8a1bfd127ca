"""Uniform field elements and raw bytes of a ``UniformSampler``'s stream,
drawn on the sampler's device: one launch of csrc/field_sample.cu a call
on the card.

``draw_segments(spec, sampler, segments)`` draws a list of segments one
after another, each ``("field", n)`` (n uniform elements of ``spec``'s
field in [0, p) as digit planes int64 [w, n]: goff's MustSetRandom, a
top-bit-masked rejection loop) or ``("bytes", k)`` (k raw bytes, uint8
[k]: the Jindo commit's ChaCha20 keys).  The values and the sampler's
state afterwards equal those of the host loop that takes each round's
``2 w m`` bytes with ``_take_bytes`` (the JAX package's
``ringo_tpu/jindo/prover.py`` ``sample_field_digits``, then
``_take_bytes(k)``): in round r the m lanes still needed, in lane order,
each take 2w stream bytes as w little-endian u16 digits, the top one
masked; a candidate below p is accepted, the rest are drawn again in the
next round.

Every call follows one protocol on the card and on the CPU
(``draw_segments``): read ahead on the sampler's device
(``UniformSampler.read_ahead``), run the loop (``field_sample``: the kernel
``field_sample_cuda`` on a CUDA sampler, its plain version
``field_sample_plain`` on the CPU), read its state (one host sync a launch,
``SYNCS``), and when the read-ahead ran short (status WANT) commit the
bytes used, read further ahead and run again from that state; at the end
``commit`` the bytes used.  The results stay on the sampler's device.
``LAST`` holds the last call's launches, exits (``mid_segment_exits``: those
inside a field segment after a round of it), rounds, chunks and bytes;
``CALLS`` and ``EXITS`` count calls and exits.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend
from ..fields import limb

FIELD, RAW = 0, 1            # segment kinds (csrc/field_sample.cu)
KINDS = {"field": FIELD, "bytes": RAW}
DONE, WANT = 0, 1            # statuses: done, read-ahead short
# slots of the loop's int64 state (csrc/field_sample.cu S_*)
(S_STATUS, S_SEG, S_M, S_FRESH, S_PP, S_OFF, S_WANT, S_ROUNDS, S_CHUNKS,
 S_LEN) = range(10)
MAX_W = 64                   # digits the kernel takes (ZP880 has 55)
# slots of the kernel's int64 arguments (csrc/field_sample.cu A_*)
(A_OUT, A_STRIDE, A_RAW, A_WIN, A_START, A_AVAIL, A_NEED, A_NMAX, A_SEGS,
 A_NSEG, A_W, A_TOP_MASK, A_ST_OUT, A_SCRATCH, A_SCRATCH_CAP, A_P) = range(16)
A_ST = A_P + MAX_W
A_LEN = A_ST + S_LEN
THREADS = 1024               # candidates a chunk of the host loop (S_CHUNKS)
CLUSTER = 8                  # blocks of the kernel's launch (one cluster)
# a read-ahead holds the expected stream bytes of what is left to draw
# (2w bytes a candidate over the acceptance p / 2^bits) times SLACK, plus
# WINDOW_SLACK bytes
SLACK = 1.25
WINDOW_SLACK = 1 << 16

SYNCS = 0              # host syncs: one state read a launch
CALLS = EXITS = 0      # draw_segments calls that launched, and their exits
LAST = {}              # the last call: segments, launches, exits, rounds, bytes


class _Draw:
    """One ``draw_segments`` call: the segment table (int64 [nseg, 3]:
    kind, count, output base), the outputs (``out`` int64 [w, field
    lanes], ``raw`` uint8 [raw bytes]), the ping-pong need list (int32
    [2, nmax]), the read-ahead ``win`` and ``st``, the state (numpy int64
    [S_LEN]) that the kernel or its plain version advances; on the card
    ``scratch``, the kernel's int32 area for reject flags past its shared
    tile (``launch_args``)."""

    def __init__(self, spec, sampler, segments):
        self.spec, self.smp = spec, sampler
        self.dev = dev = sampler.device
        w = spec.w
        tab = np.zeros((len(segments), 3), dtype=np.int64)
        n_field = n_raw = nmax = 0
        for i, (kind, count) in enumerate(segments):
            if kind not in KINDS or int(count) < 0:
                raise ValueError(f"segment {i}: {(kind, count)!r}")
            count = int(count)
            if KINDS[kind] == FIELD:
                tab[i] = (FIELD, count, n_field)
                n_field += count
                nmax = max(nmax, count)
            else:
                tab[i] = (RAW, count, n_raw)
                n_raw += count
        self.tab = tab
        self.work = n_field + n_raw > 0
        self.out = torch.empty((w, n_field), dtype=torch.int64, device=dev)
        self.raw = torch.empty(n_raw, dtype=torch.uint8, device=dev)
        self.need = torch.empty((2, nmax), dtype=torch.int32, device=dev)
        self.top_mask = (1 << (spec.bits - 16 * (w - 1))) - 1
        self.accept = spec.p / float(1 << spec.bits)
        self.st = np.zeros(S_LEN, dtype=np.int64)
        self.st[S_M] = -1
        self.win = None
        self.used = self.ahead = 0
        self.pd = self.segs_dev = self.st_dev = self.st_pin = None   # lazily
        self.scratch = None

    def budget(self) -> int:
        """Bytes to read ahead for what is left from the state on."""
        seg, m = int(self.st[S_SEG]), int(self.st[S_M])
        lanes = raw = 0
        for k in range(seg, len(self.tab)):
            kind, count, _ = self.tab[k]
            if kind == RAW:
                raw += int(count)
            else:
                lanes += m if k == seg and m >= 0 else int(count)
        field = 2 * self.spec.w * lanes / self.accept
        return int(SLACK * field) + raw + WINDOW_SLACK

    def open(self, nbytes: int) -> None:
        self.win = self.smp.read_ahead(nbytes)
        self.ahead += self.win[2]

    def take(self) -> None:
        """Commit the bytes read so far; the offset goes to 0."""
        off = int(self.st[S_OFF])
        self.smp.commit(off)
        self.used += off
        self.st[S_OFF] = 0

    def results(self) -> list:
        return [self.out[:, b:b + c] if kind == FIELD else self.raw[b:b + c]
                for kind, c, b in self.tab.tolist()]


def draw_segments(spec, sampler, segments) -> list:
    """Draw ``segments`` (each ``("field", n)`` or ``("bytes", k)``) one
    after another from ``sampler``'s stream, exactly as the host loop
    would; returns, per segment, digit planes int64 [w, n] or bytes uint8
    [k] on the sampler's device (views of one output each).  One launch
    and one host sync on the card, unless the read-ahead runs short."""
    global SYNCS, CALLS, EXITS
    D = _Draw(spec, sampler, segments)
    if not D.work:
        return D.results()
    CALLS += 1
    launches = exits = mid = 0
    D.open(D.budget())
    while True:
        field_sample(D)
        launches += 1
        if D.st_pin is not None:
            torch.cuda.current_stream(D.dev).synchronize()
            D.st[:] = D.st_pin.numpy()
        SYNCS += 1
        if int(D.st[S_STATUS]) == DONE:
            break
        exits += 1
        EXITS += 1
        mid += int(D.st[S_M]) > 0 and not int(D.st[S_FRESH])
        want = int(D.st[S_WANT])
        D.take()
        D.open(want + D.budget())
    D.take()
    LAST.clear()
    LAST.update(segments=len(segments), lanes=D.out.shape[1],
                raw=D.raw.numel(), launches=launches, exits=exits,
                mid_segment_exits=mid,
                rounds=int(D.st[S_ROUNDS]), chunks=int(D.st[S_CHUNKS]),
                used=D.used, read_ahead=D.ahead)
    return D.results()


def field_sample(D: _Draw) -> None:
    """Run the loop from ``D.st`` until the call is done or its read-ahead
    runs short: the kernel when the sampler lies on the card, the plain
    version on the CPU."""
    if D.dev.type == "cuda":
        field_sample_cuda(D)
    else:
        field_sample_plain(D)


def field_sample_plain(D: _Draw) -> None:
    """Plain version of the kernel (csrc/field_sample.cu states the loop):
    the same rounds over D's tensors on their device, the same read-ahead
    offsets, the same exit before a round or a byte copy that passes the
    read-ahead, and the same resume at the segment, need list and half of
    the ping-pong list that ``D.st`` holds; advances ``D.st``."""
    st = D.st
    ext, start, avail = D.win
    w, dev = D.spec.w, D.out.device
    nb = 2 * w
    if D.pd is None:
        D.pd = torch.from_numpy(D.spec.p_digits.astype(np.int64)).reshape(
            w, 1).to(dev)
    seg, m, off = int(st[S_SEG]), int(st[S_M]), int(st[S_OFF])
    fresh, pp = int(st[S_FRESH]), int(st[S_PP])
    rounds, chunks = int(st[S_ROUNDS]), int(st[S_CHUNKS])
    status, want = DONE, 0
    while seg < len(D.tab):
        kind, cnt, base = (int(x) for x in D.tab[seg])
        if kind == RAW:
            if off + cnt > avail:
                status, want = WANT, cnt
                break
            D.raw[base:base + cnt] = ext[start + off:start + off + cnt]
            off += cnt
            seg += 1
            continue
        if m < 0:
            m, fresh = cnt, 1
        while m > 0:
            nbytes = nb * m
            if off + nbytes > avail:
                status, want = WANT, nbytes
                break
            b = ext[start + off:start + off + nbytes].to(torch.int64)
            b = b.reshape(m, w, 2)
            cand = (b[..., 0] | (b[..., 1] << 8)).T.contiguous()    # [w, m]
            cand[-1] &= D.top_mask
            lanes = (torch.arange(m, dtype=torch.int32, device=dev) if fresh
                     else D.need[pp, :m])
            ok = ~limb.geq_plain(cand, D.pd)
            D.out[:, base + lanes[ok].long()] = cand[:, ok]
            rej = lanes[~ok]
            D.need[pp ^ 1, :rej.numel()] = rej
            chunks += -(-m // THREADS)
            off += nbytes
            m, fresh, pp = rej.numel(), 0, pp ^ 1
            rounds += 1
        if status == WANT:
            break
        seg, m = seg + 1, -1
    st[S_STATUS], st[S_SEG], st[S_M], st[S_FRESH] = status, seg, m, fresh
    st[S_PP], st[S_OFF], st[S_WANT] = pp, off, want
    st[S_ROUNDS], st[S_CHUNKS] = rounds, chunks


def field_sample_cuda(D: _Draw) -> None:
    """One launch of the kernel (csrc/field_sample.cu,
    ``ringo_field_sample``) over D's tensors on one card, from the state
    ``D.st``; the state it ends in is copied to a pinned host buffer
    (``D.st_pin``) that the caller reads after a sync."""
    ext = D.win[0]
    ts = dict(out=(D.out, torch.int64), raw=(D.raw, torch.uint8),
              need=(D.need, torch.int32), read_ahead=(ext, torch.uint8))
    for name, (t, dt) in ts.items():
        backend.require(t, dt, name=name)
        if not t.is_cuda or t.device != ext.device:
            raise ValueError(f"field_sample: {name} is not on the call's card")
    a = launch_args(D)
    err = backend.lib().ringo_field_sample(a.ctypes.data,
                                           backend.stream_ptr(D.out))
    backend.check(err, "field_sample")
    backend.LAUNCHES["field"] += 1
    D.st_pin.copy_(D.st_dev, non_blocking=True)


def scratch_ints(cap: int) -> int:
    """int32 elements of the kernel's scratch area for ``cap`` candidates:
    a block's reject bits of two segments, counts and rejects, kCluster
    blocks."""
    return CLUSTER * (3 * (cap // 32) + cap)


def launch_args(D: _Draw) -> np.ndarray:
    """The kernel's int64 arguments (A_*) for a launch from ``D.st`` on D's
    card tensors: pointers, sizes, p's digits, the scratch area (allocated
    or grown here) and the state."""
    ext, start, avail = D.win
    w = D.spec.w
    if not 0 < w <= MAX_W:
        raise ValueError(f"field_sample: {w} digits (at most {MAX_W})")
    if not 0 <= start <= start + avail <= ext.numel():
        raise ValueError("field_sample: the read-ahead's range")
    dev = ext.device
    if D.st_dev is None:
        D.segs_dev = torch.from_numpy(D.tab).to(dev, non_blocking=True)
        D.st_dev = torch.empty(S_LEN, dtype=torch.int64, device=dev)
        D.st_pin = torch.empty(S_LEN, dtype=torch.int64, pin_memory=True)
    a = np.zeros(A_LEN, dtype=np.int64)
    a[A_OUT], a[A_STRIDE] = D.out.data_ptr(), D.out.shape[1]
    a[A_RAW], a[A_WIN] = D.raw.data_ptr(), ext.data_ptr()
    a[A_START], a[A_AVAIL] = start, avail
    a[A_NEED], a[A_NMAX] = D.need.data_ptr(), D.need.shape[1]
    a[A_SEGS], a[A_NSEG] = D.segs_dev.data_ptr(), len(D.tab)
    a[A_W], a[A_TOP_MASK] = w, D.top_mask
    a[A_ST_OUT] = D.st_dev.data_ptr()
    # the kernel's flags past its shared tile, an area a block: every
    # readable candidate
    cap = (avail // (2 * w) + 63) // 32 * 32
    if D.scratch is None or D.scratch.numel() < scratch_ints(cap):
        D.scratch = torch.empty(scratch_ints(cap), dtype=torch.int32, device=dev)
    a[A_SCRATCH], a[A_SCRATCH_CAP] = D.scratch.data_ptr(), cap
    a[A_P:A_P + w] = D.spec.p_digits
    a[A_ST:] = D.st
    return a
