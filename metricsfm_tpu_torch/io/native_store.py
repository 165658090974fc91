"""ctypes bindings for the native feature-store runtime (native/).

Counterpart of metricsfm_tpu/io/native_store.py: the same library and
record layout, so both packages read each other's .msf records.
Auto-builds `native/libmsf_native.so` with make on first use and falls back
to the pure-Python .npz store when a toolchain is unavailable.  The native
path matters for production ingestion: raw fixed-layout records + a
std::thread batch loader replace per-file npz compression (the reference's
runtime IO is native C++ for the same reason — database.cc binary files).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmsf_native.so"))
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                           check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.msf_write_features.restype = ctypes.c_int
        lib.msf_read_header.restype = ctypes.c_int
        lib.msf_read_features.restype = ctypes.c_int
        lib.msf_load_desc_batch.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def write_features(path: str, xy, desc, mask, sigma, angle,
                   width: int, height: int, focal: float) -> bool:
    lib = _load()
    if lib is None:
        return False
    xy = np.ascontiguousarray(xy, np.float32)
    desc = np.ascontiguousarray(desc, np.float32)
    sigma = np.ascontiguousarray(sigma, np.float32)
    angle = np.ascontiguousarray(angle, np.float32)
    mask = np.ascontiguousarray(mask, np.uint8)
    n, d = desc.shape
    rc = lib.msf_write_features(
        path.encode(), ctypes.c_uint32(n), ctypes.c_uint32(d),
        ctypes.c_uint32(width), ctypes.c_uint32(height),
        ctypes.c_float(focal),
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sigma.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        angle.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return rc == 0


def read_features(path: str):
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_uint32()
    d = ctypes.c_uint32()
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    f = ctypes.c_float()
    if lib.msf_read_header(path.encode(), ctypes.byref(n), ctypes.byref(d),
                           ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(f)) != 0:
        return None
    n, d = n.value, d.value
    xy = np.empty((n, 2), np.float32)
    sigma = np.empty(n, np.float32)
    angle = np.empty(n, np.float32)
    mask = np.empty(n, np.uint8)
    desc = np.empty((n, d), np.float32)
    rc = lib.msf_read_features(
        path.encode(),
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sigma.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        angle.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        desc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return {"xy": xy, "sigma": sigma, "angle": angle,
            "mask": mask.astype(bool), "desc": desc,
            "width": w.value, "height": h.value, "focal": f.value}


def load_desc_batch(paths: List[str], n_kps: int, desc_dim: int = 128,
                    n_threads: int = 8):
    """Threaded packed read of many records -> (B, n_kps, D) + masks."""
    lib = _load()
    if lib is None:
        return None
    B = len(paths)
    out_desc = np.zeros((B, n_kps, desc_dim), np.float32)
    out_mask = np.zeros((B, n_kps), np.uint8)
    arr = (ctypes.c_char_p * B)(*[p.encode() for p in paths])
    n_ok = lib.msf_load_desc_batch(
        arr, ctypes.c_int(B), ctypes.c_uint32(n_kps),
        ctypes.c_uint32(desc_dim),
        out_desc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(n_threads))
    return out_desc, out_mask.astype(bool), n_ok
