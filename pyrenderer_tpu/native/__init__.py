"""Native host-side components (C++ via ctypes).

The reference's "native" layers are Numba/Taichi JIT kernels (SURVEY §2 —
no hand-written C++ anywhere); its CPU SAH BVH builder
(reference accelerators/bvh.py) is pure Python and rebuilds recursively per
scene. Here the builder is real C++ (bvh_builder.cpp), compiled on demand
with the system g++ into a cached shared library and bound with ctypes —
Python fallback (accel/bvh.py build_lbvh) is always available, so the
native path is an optimization, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "bvh_builder.cpp")
_LIB_NAME = "libbvh_builder.so"
_lib = None
_lib_tried = False


def _cache_dir() -> str:
    """Build directory: $PYRENDERER_TPU_CACHE, else `.native_build` at the
    root of the checkout (listed in .gitignore)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    d = os.environ.get("PYRENDERER_TPU_CACHE") or os.path.join(
        root, ".native_build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> Optional[str]:
    out = os.path.join(_cache_dir(), _LIB_NAME)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(_SRC):
        return out
    # build under a private name, then rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def load_library():
    """Returns the ctypes lib or None if native build is unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = _compile()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.build_sah_bvh.restype = ctypes.c_int32
        lib.build_sah_bvh.argtypes = [
            f32p, f32p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            i32p, f32p, f32p, i32p, i32p, i32p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def build_sah_bvh_native(tri_min, tri_max, leaf_size: int = 4):
    """SAH build via the C++ library. Returns dict of flat arrays or None
    when the native library can't be built/loaded."""
    lib = load_library()
    if lib is None:
        return None
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    t = tri_min.shape[0]
    max_nodes = 4 * t + 1
    order = np.empty(t, np.int32)
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    escape = np.empty(max_nodes, np.int32)
    n = lib.build_sah_bvh(
        tri_min, tri_max, t, leaf_size, max_nodes,
        order, bmin, bmax, first, count, escape,
    )
    if n < 0:
        return None
    return dict(
        order=order,
        bbox_min=bmin[:n],
        bbox_max=bmax[:n],
        first=first[:n],
        count=count[:n],
        escape=escape[:n],
    )
