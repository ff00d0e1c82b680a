"""ctypes bindings for the native host runtime (imageio.cpp).

The device computes linear radiance; these are the host-side finishing ops —
tonemap/quantize, multi-shard mean, TGA encode/decode — implemented in C++
(the counterpart of the reference's C++ host runtime: common.h:80-122 TGA,
rayweek1.cpp:765-775 quantization, :809-813 reduction). Falls back to numpy /
scene.tga if the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        from rays1bench.runtime.build import build
        lib = ctypes.CDLL(build())
    except Exception:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rt_tonemap_u8.argtypes = [f32p, u8p, ctypes.c_int64]
    lib.rt_accumulate_mean.argtypes = [ctypes.POINTER(f32p), ctypes.c_int,
                                       f32p, ctypes.c_int64]
    lib.rt_tga_write_rgb24.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, u8p]
    lib.rt_tga_write_rgb24.restype = ctypes.c_int
    lib.rt_tga_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.rt_tga_probe.restype = ctypes.c_int
    lib.rt_tga_read_rgb24.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                      ctypes.c_int]
    lib.rt_tga_read_rgb24.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def tonemap_u8(linear: np.ndarray) -> np.ndarray:
    """clamp -> sqrt gamma -> *255.99 quantize, elementwise (reference
    rayweek1.cpp:765-775)."""
    linear = np.ascontiguousarray(linear, dtype=np.float32)
    lib = _load()
    if lib is None:
        g = np.sqrt(np.clip(linear, 0.0, 1.0))
        return (g * 255.99).astype(np.uint8)
    out = np.empty(linear.shape, np.uint8)
    lib.rt_tonemap_u8(
        linear.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        linear.size)
    return out


def accumulate_mean(shards: List[np.ndarray]) -> np.ndarray:
    """Mean of per-shard radiance buffers (host-side shard assembly)."""
    shards = [np.ascontiguousarray(s, dtype=np.float32) for s in shards]
    lib = _load()
    if lib is None:
        return np.mean(shards, axis=0).astype(np.float32)
    out = np.empty(shards[0].shape, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    ptrs = (f32p * len(shards))(*[s.ctypes.data_as(f32p) for s in shards])
    lib.rt_accumulate_mean(ptrs, len(shards),
                           out.ctypes.data_as(f32p), out.size)
    return out


def tga_write_rgb24(path: str, image_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB (row 0 = bottom) as uncompressed 24-bit TGA,
    byte-compatible with the reference writer (common.h:86-122)."""
    image_u8 = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, _ = image_u8.shape
    lib = _load()
    if lib is None:
        from rays1bench.scene import tga
        return tga.write_rgb24(path, image_u8)
    rc = lib.rt_tga_write_rgb24(
        path.encode(), w, h,
        image_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise IOError(f"rt_tga_write_rgb24 failed ({rc}) for {path}")


def tga_read_rgb24(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        from rays1bench.scene import tga
        return tga.read_rgb24(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.rt_tga_probe(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"rt_tga_probe failed ({rc}) for {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.rt_tga_read_rgb24(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w.value, h.value)
    if rc != 0:
        raise IOError(f"rt_tga_read_rgb24 failed ({rc}) for {path}")
    return out
