"""ctypes loader for the native kernel-map library.

Compiles the repository's ``native/kernel_maps.cpp`` (shared with the JAX
package, not copied) on first use (g++ -O3, ~1 s) into the package's
git-ignored ``_build/`` directory and exposes typed wrappers.  Everything
degrades to the numpy implementation in ``topology.py`` when a compiler is
unavailable or ``PC_TPU_NO_NATIVE=1`` is set.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "kernel_maps.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")


def _build() -> str | None:
    import platform

    os.makedirs(BUILD_DIR, exist_ok=True)
    # no -march=native so one artifact per ISA family is safe (the hash
    # join is memory-bound, -O3 suffices).
    so = os.path.join(BUILD_DIR, f"kernel_maps_{platform.machine()}.so")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(_SRC):
        return so
    # Unique temp per process: concurrent cold starts must not interleave
    # writes into one .tmp (os.replace publishes atomically).
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib():
    """The loaded library or None (fallback to numpy)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("PC_TPU_NO_NATIVE") == "1" or not os.path.exists(_SRC):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            # corrupt artifact (e.g. from an old race): rebuild once fresh
            try:
                os.unlink(so)
            except OSError:
                return None
            so = _build()
            if so is None:
                return None
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.pc_encode_keys.argtypes = [i32p, ctypes.c_int64, i64p, i64p, i64p]
        lib.pc_downsample.argtypes = [
            i32p, ctypes.c_int64, i64p, i64p, i32p, i32p
        ]
        lib.pc_downsample.restype = ctypes.c_int64
        lib.pc_query_map.argtypes = [
            i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int32, i32p,
        ]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def query_map(keys: np.ndarray, base: np.ndarray, off_keys: np.ndarray,
              pad: int) -> np.ndarray:
    """Cross-level variant of same_level_map: probe ``base + off`` against a
    hash of ``keys``.  Returns [K, len(base)] int32 (missing -> pad)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native kernel-map library is unavailable")
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    base = np.ascontiguousarray(base, dtype=np.int64)
    off_keys = np.ascontiguousarray(off_keys, dtype=np.int64)
    out = np.empty((len(off_keys), len(base)), dtype=np.int32)
    lib.pc_query_map(
        _ptr(keys, ctypes.c_int64), len(keys), _ptr(base, ctypes.c_int64),
        len(base), _ptr(off_keys, ctypes.c_int64), len(off_keys),
        pad, _ptr(out, ctypes.c_int32),
    )
    return out


def downsample(coords: np.ndarray, lo: np.ndarray, stride: np.ndarray):
    """Native variant of topology._downsample's unique/parent core (3D only:
    the C side hardcodes 4 coordinate columns; child offsets stay numpy).
    ``lo``/``stride`` must come from the HashSpec of the HALVED coords.
    Returns (coarse [nc, 4], parent [n])."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native kernel-map library is unavailable")
    coords = np.ascontiguousarray(coords, dtype=np.int32)
    n = len(coords)
    parent = np.empty(n, dtype=np.int32)
    coarse = np.empty((n, 4), dtype=np.int32)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    stride = np.ascontiguousarray(stride, dtype=np.int64)
    nc = lib.pc_downsample(
        _ptr(coords, ctypes.c_int32), n, _ptr(lo, ctypes.c_int64),
        _ptr(stride, ctypes.c_int64), _ptr(parent, ctypes.c_int32),
        _ptr(coarse, ctypes.c_int32),
    )
    return coarse[:nc].copy(), parent
