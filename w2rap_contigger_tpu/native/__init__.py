"""Native (C++) runtime components.

The reference's runtime layer is C++ (IO, containers, thread pools —
SURVEY §1 L0/L1/L4); this build keeps the compute path in
JAX/XLA and implements the host runtime's hot IO in C++ with a
plain C ABI loaded via ctypes (pybind11 is not available in this
environment). Modules build on demand with g++ and cache the shared
library next to the sources; every native entry point has a pure-Python
fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIBS: dict = {}


def _build(name: str, sources, libs=()) -> str:
    so_path = os.path.join(_DIR, f"lib{name}.so")
    src_paths = [os.path.join(_DIR, s) for s in sources]
    if os.path.exists(so_path) and all(
            os.path.getmtime(so_path) >= os.path.getmtime(s)
            for s in src_paths):
        return so_path
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           *src_paths, "-o", so_path, *[f"-l{l}" for l in libs]]
    subprocess.run(cmd, check=True, capture_output=True)
    return so_path


def load(name: str, sources, libs=()):
    """Build (if stale) and dlopen a native module; returns the CDLL or
    None when no toolchain / build failure (callers fall back)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        try:
            lib = ctypes.CDLL(_build(name, sources, libs))
        except Exception:
            lib = None
        _LIBS[name] = lib
        return lib
