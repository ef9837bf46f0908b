"""ctypes loader for the native C++ runtime library (libtinyrt.so).

The reference's native layer is its Metal stack (accel-structure build,
shader pipeline, buffer marshalling). The equivalents that belong on the
*host* side live here: the BVH flattening/build (the analog of
MetalAccelerationStructure build+compact, accelstructure.rs:90-135) and PNG
encoding (the analog of the `image` crate). Device compute is XLA/Pallas.

Python fallbacks exist for every entry point; `available()` gates the fast
path. Build with: `python -m tinyraytracer_tpu.native.build` (or make -C
tinyraytracer_tpu/native).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_HERE, "libtinyrt.so")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tinyrt_bvh_build.restype = ctypes.c_int
        lib.tinyrt_bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # prim bbox min (N,3)
            ctypes.POINTER(ctypes.c_float),  # prim bbox max (N,3)
            ctypes.c_int,                    # N
            ctypes.POINTER(ctypes.c_float),  # out node bbox min (2N-1,3)
            ctypes.POINTER(ctypes.c_float),  # out node bbox max (2N-1,3)
            ctypes.POINTER(ctypes.c_int),    # out hit link  (2N-1,)
            ctypes.POINTER(ctypes.c_int),    # out miss link (2N-1,)
            ctypes.POINTER(ctypes.c_int),    # out leaf prim (2N-1,)
        ]
        lib.tinyrt_write_png.restype = ctypes.c_int
        lib.tinyrt_write_png.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def bvh_build(bb_min: np.ndarray, bb_max: np.ndarray):
    """Build a threaded (hit-link/miss-link) BVH over primitive AABBs.

    Returns (node_min (2N-1,3), node_max, hit_link, miss_link, leaf_prim)
    in depth-first order; leaf_prim is -1 for inner nodes. Raises if the
    native library is unavailable (callers use ops.bvh's Python builder as
    the fallback)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    n = bb_min.shape[0]
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    m = 2 * n - 1
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    hit_link = np.empty((m,), np.int32)
    miss_link = np.empty((m,), np.int32)
    leaf_prim = np.empty((m,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = lib.tinyrt_bvh_build(
        bb_min.ctypes.data_as(fp),
        bb_max.ctypes.data_as(fp),
        n,
        node_min.ctypes.data_as(fp),
        node_max.ctypes.data_as(fp),
        hit_link.ctypes.data_as(ip),
        miss_link.ctypes.data_as(ip),
        leaf_prim.ctypes.data_as(ip),
    )
    if rc != 0:
        raise RuntimeError(f"tinyrt_bvh_build failed: {rc}")
    return node_min, node_max, hit_link, miss_link, leaf_prim


def write_png(path: str, rgb: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3
    rc = lib.tinyrt_write_png(
        path.encode(),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        w,
        h,
    )
    if rc != 0:
        raise RuntimeError(f"tinyrt_write_png failed: {rc}")
