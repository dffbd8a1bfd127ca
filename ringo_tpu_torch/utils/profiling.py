"""Span registry: named phases of a commit, an evaluation, a verification
or a prove, counted and timed on the host clock.

* ``span(name)`` marks a phase: it always opens
  ``torch.profiler.record_function(name)``, so a ``torch.profiler`` trace
  carries the name (ringo_tpu_torch/profile_commit.py reads them), and,
  when the registry is enabled, adds one call and its wall seconds to
  ``name``.  ``RINGO_TRACE=1`` in the environment enables it at import;
  ``enable()`` switches it at run time.  Disabled, a span costs one flag
  test beside the ``record_function``.
* ``report()`` is ``{name: (count, total_seconds)}``; ``reset()`` empties
  it; ``print_report()`` prints it.
* ``device_trace(path)`` wraps ``torch.profiler.profile`` (CPU and, where
  there is a card, CUDA activity) and writes a Chrome trace to ``path``.

The span times are host-clock times: a span around device work that does
not synchronise measures the enqueue, not the kernels.  The names are the
JAX package's where the phase is the same (``jindo.commit.*``,
``jindo.evaluate.*``, ``jindo.verify.*``, ``buckler.prove.*``,
``buckler.verify.*``).  The port's own copy of
``ringo_tpu.utils.profiling``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import record_function

RINGO_TRACE = "RINGO_TRACE"

_ENABLED = bool(os.environ.get(RINGO_TRACE))
_SPANS: dict[str, list] = defaultdict(lambda: [0, 0.0])


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def span(name: str):
    with record_function(name):
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = _SPANS[name]
            rec[0] += 1
            rec[1] += time.perf_counter() - t0


def report() -> dict[str, tuple[int, float]]:
    return {k: (v[0], v[1]) for k, v in sorted(_SPANS.items())}


def reset() -> None:
    _SPANS.clear()


def print_report() -> None:
    for name, (count, total) in report().items():
        print(f"{name:40s} {count:6d}x  {total:8.3f}s  "
              f"({total / max(count, 1) * 1e3:7.1f} ms avg)")


@contextlib.contextmanager
def device_trace(path: str):
    """Trace the block with ``torch.profiler`` and write a Chrome trace to
    ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
