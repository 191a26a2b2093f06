"""ctypes bindings for the native host data path (native/stereoio.cpp).

The reference's host layer is C++ (OpenCV I/O); this is the
stack's equivalent: a zero-dependency C++ codec/evaluator compiled to
``native/libstereoio.so``.  The library is built on demand with ``make``
(g++ is in the image); every entry point has a pure-Python fallback in
utils/io.py / utils/evaluate.py, so the package works without a toolchain.

Use ``available()`` to check, or just call the functions — they raise
RuntimeError with a build hint when the library is missing and autobuild
fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libstereoio.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(
        os.path.join(_NATIVE_DIR, "Makefile")
    ):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.sio_pnm_header.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 3
    lib.sio_read_pnm.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.sio_write_pgm.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.sio_pfm_header.argtypes = lib.sio_pnm_header.argtypes
    lib.sio_read_pfm.argtypes = lib.sio_read_pnm.argtypes
    lib.sio_png_header.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 4
    lib.sio_read_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    for name in ("sio_write_png_gray8", "sio_write_png_rgb8",
                 "sio_write_png_gray16"):
        getattr(lib, name).argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
    lib.sio_bad_delta.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_float,
    ]
    lib.sio_bad_delta.restype = ctypes.c_double
    lib.sio_epe.argtypes = lib.sio_bad_delta.argtypes[:4]
    lib.sio_epe.restype = ctypes.c_double
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native stereoio library unavailable; run `make -C native` "
            "(pure-Python fallbacks live in utils.io / utils.evaluate)"
        )
    return lib


def read_pnm(path: str) -> np.ndarray:
    """Native PNM decode -> float32 (H,W) or (H,W,3) on the [0,255] grid."""
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.sio_pnm_header(path.encode(), ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(c))
    if rc:
        raise IOError(f"sio_pnm_header({path}) -> {rc}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.sio_read_pnm(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise IOError(f"sio_read_pnm({path}) -> {rc}")
    return out[..., 0] if c.value == 1 else out


def read_pfm(path: str) -> np.ndarray:
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.sio_pfm_header(path.encode(), ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(c))
    if rc:
        raise IOError(f"sio_pfm_header({path}) -> {rc}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.sio_read_pfm(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise IOError(f"sio_read_pfm({path}) -> {rc}")
    return out[..., 0] if c.value == 1 else out


def read_png(path: str) -> np.ndarray:
    """Native PNG decode (8/16-bit gray/RGB, alpha dropped) -> float32.

    8-bit samples come back on [0,255]; 16-bit on the raw [0,65535] grid
    (KITTI-convention scaling is the caller's job — same contract as PNM).
    """
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    bd = ctypes.c_int()
    rc = lib.sio_png_header(path.encode(), ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(c), ctypes.byref(bd))
    if rc:
        raise IOError(f"sio_png_header({path}) -> {rc}")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.sio_read_png(path.encode(), out.ctypes.data_as(ctypes.c_void_p))
    if rc:
        raise IOError(f"sio_read_png({path}) -> {rc}")
    return out[..., 0] if c.value == 1 else out


def write_png(path: str, img: np.ndarray, bit_depth: int = 8) -> None:
    """Native PNG encode: float32 (H,W) gray (8- or 16-bit) or (H,W,3) RGB."""
    lib = _require()
    arr = np.ascontiguousarray(img, dtype=np.float32)
    if arr.ndim == 3 and arr.shape[2] == 3:
        if bit_depth != 8:
            raise ValueError("RGB PNG encode supports bit_depth=8 only")
        fn = lib.sio_write_png_rgb8
    elif arr.ndim == 2:
        fn = lib.sio_write_png_gray16 if bit_depth == 16 else lib.sio_write_png_gray8
    else:
        raise ValueError(f"unsupported image shape {arr.shape}")
    rc = fn(path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
            arr.shape[0], arr.shape[1])
    if rc:
        raise IOError(f"png encode({path}) -> {rc}")


def write_pgm(path: str, img: np.ndarray) -> None:
    lib = _require()
    arr = np.ascontiguousarray(img, dtype=np.float32)
    rc = lib.sio_write_pgm(
        path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
        arr.shape[0], arr.shape[1],
    )
    if rc:
        raise IOError(f"sio_write_pgm({path}) -> {rc}")


def bad_delta(
    a: np.ndarray, b: np.ndarray, delta: float, valid: Optional[np.ndarray] = None
) -> float:
    lib = _require()
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    v = None
    vp = None
    if valid is not None:
        v = np.ascontiguousarray(valid, np.uint8)
        vp = v.ctypes.data_as(ctypes.c_void_p)
    return float(
        lib.sio_bad_delta(
            a.ctypes.data_as(ctypes.c_void_p),
            b.ctypes.data_as(ctypes.c_void_p),
            vp, a.size, delta,
        )
    )


def epe(a: np.ndarray, b: np.ndarray, valid: Optional[np.ndarray] = None) -> float:
    lib = _require()
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    vp = None
    if valid is not None:
        v = np.ascontiguousarray(valid, np.uint8)
        vp = v.ctypes.data_as(ctypes.c_void_p)
    return float(
        lib.sio_epe(
            a.ctypes.data_as(ctypes.c_void_p),
            b.ctypes.data_as(ctypes.c_void_p),
            vp, a.size,
        )
    )
