"""Build and load the port's hand-written CUDA sources (``csrc/<name>.cu``),
and the helpers their Python wrappers share.

Each source has a plain C interface: ``nvcc`` compiles it for sm_90a into a
shared library in the git-ignored ``_build/`` at first use (rebuilt when the
source is newer), and ``ctypes`` loads it.  ``build`` starts one ``nvcc``
per stale source, all at once, so a cold start costs the slowest compile,
not their sum.  Nothing here runs at import time: the CPU tests import every
module on a host with no ``nvcc``."""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(PKG, "_build")
SOURCES = ("sparse_conv", "detect_ops")

_LOCK = threading.Lock()
_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (needed to build the csrc/*.cu kernels)")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}_sm90a.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    so = library_path(name)
    if not os.path.exists(so):
        return True
    headers = [os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(p)
                                      for p in [source_path(name), *headers])


def build(names=SOURCES) -> dict:
    """Compile every stale source of ``names``, one ``nvcc`` each, started
    together.  Returns {name: {"seconds", "ptxas"}} (ptxas: the compiler's
    register/shared-memory report, empty when the library was up to date).
    Raises if any compile fails, after stopping the others."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {n: {"seconds": 0.0, "ptxas": ""} for n in names}
    running = {}
    for name in names:
        if not _stale(name):
            continue
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", tmp, source_path(name),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    try:
        for name, (proc, tmp, t0) in running.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on csrc/{name}.cu ({proc.returncode}):\n{err}")
            os.replace(tmp, library_path(name))
            out[name] = {"seconds": time.perf_counter() - t0, "ptxas": err}
    finally:
        for proc, _, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` (built first if stale), with each
    C entry's argtypes set from ``signatures`` and an int return code."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def check(rc: int, name: str) -> None:
    """Raise on a launch's ``cudaGetLastError()`` code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream(t=None) -> int:
    """The current CUDA stream (of ``t``'s device, else of the current
    device) as the int a ``c_void_p`` argument takes (ints and None pass
    straight through ctypes, with no object to build).
    ``torch._C._cuda_getCurrentRawStream`` is the getter torch's own
    compiled kernels launch with: ``torch.cuda.current_stream()`` would
    build a ``Stream`` object first, several µs of a launch's host cost."""
    device = torch.cuda.current_device() if t is None else t.get_device()
    return torch._C._cuda_getCurrentRawStream(device)


def ptr(t):
    return None if t is None else t.data_ptr()


INDEX_LIMIT = 2 ** 31


def check_index_space(name: str, **sizes) -> None:
    """Raise unless every index space (the element count of a table or a
    map the kernel addresses) is below 2^31: the row kernels compute their
    offsets in 32-bit ints."""
    for what, n in sizes.items():
        if n >= INDEX_LIMIT:
            raise ValueError(f"{name}: {what} spans {n} elements, 2^31 or more "
                             "(the kernel's offsets are 32-bit)")


def use_plain(x: torch.Tensor) -> bool:
    """A wrapper takes its plain-torch twin for a CPU tensor, and only then;
    on a CUDA tensor it launches its kernel or raises."""
    return x.is_cpu


def require(t, name, dtype, ndim):
    """Raise unless ``t`` (None passes) is a contiguous ``ndim``-d CUDA
    tensor of ``dtype``: what a kernel that reads raw pointers takes."""
    if t is None or (t.is_cuda and t.dtype == dtype and t.dim() == ndim
                     and t.is_contiguous()):
        return  # the common case first: a launch's host cost
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {ndim}-d tensor, got "
            f"{tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
