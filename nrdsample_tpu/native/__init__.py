"""Native C++ helpers, loaded via ctypes (pybind11 not available in this image).

Components:
  * bvh_builder.cpp — binned-SAH BVH order builder (scene/bvh.py fallback)
  * gltf_decode.cpp — glTF accessor decode + normal accumulation (the cgltf
    role; scene/gltf.py numpy fallback)

Each is compiled on first use with g++ into a cached shared object; callers
fall back to numpy when compilation is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIBS: dict = {}


def _load(name: str) -> ctypes.CDLL | None:
    """Compile (if stale) and dlopen native/<name>.cpp; None on failure."""
    if name in _LIBS:
        return _LIBS[name]
    _LIBS[name] = None
    src = os.path.join(os.path.dirname(__file__), f"{name}.cpp")
    # built inside the checkout (build/ is git-ignored), never under $HOME
    cache_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "build", "native",
    )
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"lib{name}.so")
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(src):
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", so_path + ".tmp",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(so_path + ".tmp", so_path)
        except Exception:
            return None
    try:
        _LIBS[name] = ctypes.CDLL(so_path)
    except OSError:
        return None
    return _LIBS[name]


_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def get_lib() -> ctypes.CDLL | None:
    """The BVH builder library (kept under its historical name)."""
    lib = _load("bvh_builder")
    if lib is not None and not getattr(lib, "_sig_done", False):
        lib.build_bvh_order.restype = ctypes.c_int
        lib.build_bvh_order.argtypes = [_f32p, _f32p, ctypes.c_int64,
                                        ctypes.c_int, _i64p]
        lib._sig_done = True
    return lib


def build_order(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int = 8):
    """Native BVH order build. Returns (order int64 (n,), depth) or None when
    the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    n = len(tri_min)
    order = np.empty(n, np.int64)
    depth = lib.build_bvh_order(
        tri_min.ctypes.data_as(_f32p),
        tri_max.ctypes.data_as(_f32p),
        n,
        leaf_size,
        order.ctypes.data_as(_i64p),
    )
    if depth < 0:
        return None
    return order, depth


def _gltf_lib() -> ctypes.CDLL | None:
    lib = _load("gltf_decode")
    if lib is not None and not getattr(lib, "_sig_done", False):
        common = [_u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                  ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.gltf_decode_f32.restype = ctypes.c_int
        lib.gltf_decode_f32.argtypes = common + [_f32p]
        lib.gltf_decode_i64.restype = ctypes.c_int
        lib.gltf_decode_i64.argtypes = common + [_i64p]
        lib.gltf_accumulate_normals.restype = ctypes.c_int
        lib.gltf_accumulate_normals.argtypes = [
            _f32p, ctypes.c_int64, _i64p, ctypes.c_int64, _f32p,
        ]
        lib._sig_done = True
    return lib


def decode_accessor(buf: bytes, offset: int, stride: int, count: int,
                    ncomp: int, comp_type: int, as_index: bool = False):
    """Native strided accessor decode -> (count, ncomp) float32 (or int64 when
    as_index). Returns None when the native lib is unavailable or args are
    rejected (caller falls back to numpy)."""
    lib = _gltf_lib()
    if lib is None:
        return None
    raw = np.frombuffer(buf, np.uint8)
    if as_index:
        out = np.empty((count, ncomp), np.int64)
        rc = lib.gltf_decode_i64(
            raw.ctypes.data_as(_u8p), raw.size, offset, stride, count, ncomp,
            comp_type, out.ctypes.data_as(_i64p),
        )
    else:
        out = np.empty((count, ncomp), np.float32)
        rc = lib.gltf_decode_f32(
            raw.ctypes.data_as(_u8p), raw.size, offset, stride, count, ncomp,
            comp_type, out.ctypes.data_as(_f32p),
        )
    return out if rc == 0 else None


def accumulate_normals(verts: np.ndarray, idx: np.ndarray):
    """Native area-weighted normal accumulation; (nv, 3) float32 UNnormalized
    sums, or None when the native lib is unavailable."""
    lib = _gltf_lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(verts), 3), np.float32)
    rc = lib.gltf_accumulate_normals(
        verts.ctypes.data_as(_f32p), len(verts),
        idx.ctypes.data_as(_i64p), len(idx),
        out.ctypes.data_as(_f32p),
    )
    return out if rc == 0 else None
