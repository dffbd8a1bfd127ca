"""Device choice, the hand-written CUDA kernel library, and launch counts.

Entry points take an explicit ``device``; ``resolve_device(None)`` means
the card and raises when CUDA is absent.  Nothing falls back to the CPU on
its own: a wrapper takes its kernel's plain PyTorch version only because
the tensor it was handed lies on the CPU.

The kernels live in ``csrc/*.cu`` with a plain C interface.  At first use
each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one shared library under
``build/`` beside the package, loaded with ``ctypes``.  Every C entry
point returns ``cudaGetLastError()``; :func:`check` raises on anything
but 0.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else, so a run can show that the main path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

KERNELS = ("ntt", "chacha", "twin")
LAUNCHES = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raises if CUDA is absent.  An explicit device
    is taken as given (the tests pass ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to "
                "run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


# --------------------------------------------------------- kernel library

_LIB = None
_LIB_LOCK = threading.Lock()

# C signatures: one letter per argument, "p" = pointer (ctypes.c_void_p,
# or the pointer is cut to 32 bits), "i" = int; every function returns
# its cudaError_t as int.
_SIGNATURES = {
    "ringo_ntt_mform": "pppppiip",
    "ringo_chacha20": "ppiip",
    "ringo_twin_search": "ppppppiip",
}
_CT = {"p": ctypes.c_void_p, "i": ctypes.c_int}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def build(verbose: bool = False) -> str:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into ``build/libringo_kernels_<hash>.so``; returns its path.
    The hash covers the sources and flags, so an edit rebuilds."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libringo_kernels_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    failed = []
    for src, pr in zip(srcs, procs):
        out, _ = pr.communicate()
        text = out.decode(errors="replace")
        if pr.returncode != 0:
            failed.append(f"{src}:\n{text}")
        elif verbose and text:
            print(text, flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so + f".tmp{os.getpid()}"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout.decode())
    os.replace(tmp, so)
    return so


def lib():
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build())
            for name, sig in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = [_CT[c] for c in sig]
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, dtype: torch.dtype, shape=None,
            name: str = "tensor") -> None:
    """Wrapper-side argument check: dtype, optional shape, contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
