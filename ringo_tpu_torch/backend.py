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
but 0.  ptxas reports each kernel's registers, stack frame and spills
(``-Xptxas -v``) into a log kept beside the library
(:func:`kernel_resources`).

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else, so a run can show that the main path went through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

KERNELS = ("ntt", "chacha", "twin", "aes", "bigfield", "gauss", "field",
           "mac")
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
# or the pointer is cut to 32 bits), "i" = int, "l" = long long; every
# function returns its cudaError_t as int.
_SIGNATURES = {
    "ringo_ntt_mform": "pppppiip",
    "ringo_chacha20": "ppiip",
    "ringo_twin_search": "ppppppiip",
    "ringo_aes256_ctr": "ppip",
    "ringo_aes256_ctr_fold": "pippip",
    "ringo_bigfield": "ippppppppp",
    "ringo_gauss": "ipp",
    "ringo_gauss_loop": "pp",
    "ringo_field_sample": "pp",
    "ringo_mac": "ppppiiiilllp",
}
_CT = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _library_path() -> str:
    """``build/libringo_kernels_<hash>.so``: the hash covers the sources
    and flags, so an edit rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libringo_kernels_{h.hexdigest()[:16]}.so")


def _ptxas_log(so: str) -> str:
    """The compilers' log kept beside the library ``so``."""
    return so[:-len(".so")] + ".ptxas"


def build(verbose: bool = False) -> str:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into the library of :func:`_library_path`; returns its path.  The
    compilers' output (ptxas's ``-v`` report among it) goes to the
    library's ``.ptxas`` log, and to stdout where ``verbose``, with each
    source's compile time.  A library without its log is built again."""
    srcs = _sources()
    so = _library_path()
    if os.path.exists(so) and os.path.exists(_ptxas_log(so)):
        return so
    tag = os.path.basename(so)[len("libringo_kernels_"):-len(".so")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0, objs, procs = time.perf_counter(), [], []
    for src in srcs:
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs, secs = {}, {}

    def wait(src, pr):   # each source's output and own compile time
        outs[src] = pr.communicate()[0]
        secs[src] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=sp) for sp in zip(srcs, procs)]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed, log = [], []
    for src, pr in zip(srcs, procs):
        text = outs[src].decode(errors="replace")
        log.append(text)
        if pr.returncode != 0:
            failed.append(f"{src}:\n{text}")
        elif verbose and text:
            print(text, flush=True)
    if verbose:
        print("nvcc seconds: " + ", ".join(
            f"{os.path.basename(src)} {secs[src]:.1f}" for src in srcs),
            flush=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    with open(_ptxas_log(so), "w") as f:
        f.write("\n".join(log))
    tmp = so + f".tmp{os.getpid()}"
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout.decode())
    os.replace(tmp, so)
    return so


def parse_ptxas(text: str) -> dict:
    """ptxas ``-v`` output -> {mangled kernel name: dict(registers,
    stack, spill_stores, spill_loads, lmem)}, bytes a thread (``stack``:
    the stack frame, local memory that spills and local arrays take;
    ``lmem``: where ptxas prints it, else 0), for every entry function."""
    out: dict = {}
    entry = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = dict(registers=None, stack=0, spill_stores=0,
                              spill_loads=0, lmem=0)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props in out:
            out[props].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["registers"] = int(m.group(1))
            lm = re.search(r"(\d+) bytes lmem", line)
            out[entry]["lmem"] = int(lm.group(1)) if lm else 0
    return out


def kernel_resources() -> dict:
    """:func:`parse_ptxas` of the built library's log (built first where
    missing)."""
    with open(_ptxas_log(build())) as f:
        return parse_ptxas(f.read())


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
    """The current CUDA stream of ``t``'s device, as the raw pointer the
    kernels launch on (the same stream ``torch.cuda.current_stream``
    names, read without building a Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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
