"""ctypes bindings for the native input fast path (native/fastpath.cpp).

Loads native/libepfastpath.so when present (``make -C native``); every entry
point has a numpy fallback so the framework works without the build step.
"""
from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = Path(__file__).resolve().parents[2] / "native" / "libepfastpath.so"
    if not so.exists():
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.normalize_u8_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.hflip_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int]
        lib.resize_bicubic_crop_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def normalize_u8(img: np.ndarray, mean: np.ndarray, std: np.ndarray
                 ) -> np.ndarray:
    """(H, W, 3) uint8 -> normalized float32, single fused pass."""
    lib = _load()
    img = np.ascontiguousarray(img)
    if lib is None:
        return (img.astype(np.float32) / 255.0 - mean) / std
    out = np.empty(img.shape, np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    lib.normalize_u8_to_f32(_u8ptr(img), _fptr(out),
                            ctypes.c_int64(img.shape[0] * img.shape[1]),
                            _fptr(m), _fptr(s))
    return out


def hflip_u8(img: np.ndarray) -> np.ndarray:
    lib = _load()
    img = np.ascontiguousarray(img)
    if lib is None:
        return np.ascontiguousarray(img[:, ::-1])
    out = np.empty_like(img)
    lib.hflip_u8(_u8ptr(img), _u8ptr(out), img.shape[0], img.shape[1])
    return out


def resize_bicubic_crop_u8(img: np.ndarray, box, size: int) -> np.ndarray:
    """Crop box (top, left, h, w) of a (H, W, 3) uint8 image, bicubic-resized
    to (size, size, 3). Returns None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img)
    top, left, bh, bw = box
    out = np.empty((size, size, 3), np.uint8)
    lib.resize_bicubic_crop_u8(
        _u8ptr(img), img.shape[0], img.shape[1],
        ctypes.c_float(top), ctypes.c_float(left),
        ctypes.c_float(bh), ctypes.c_float(bw),
        _u8ptr(out), size, size)
    return out
