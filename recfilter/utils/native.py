"""ctypes binding to the native host library (``native/recfilter_host.cpp``).

Loads ``librecfilter_host.so`` if present (``make -C native``); every entry
point has a numpy twin in :mod:`recfilter.coeffs` / :mod:`iir` that serves
as fallback and test oracle. ``available()`` reports whether the native path
is active; :func:`build` compiles it on demand with the in-tree Makefile.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "librecfilter_host.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False

_D = ctypes.POINTER(ctypes.c_double)


def _sig(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _sig(lib.rf_impulse_matrix,
             [ctypes.c_double, _D, ctypes.c_int, ctypes.c_int, ctypes.c_int, _D])
        _sig(lib.rf_state_matrix, [_D, ctypes.c_int, ctypes.c_int, _D])
        _sig(lib.rf_tail_weight_matrix, [_D, ctypes.c_int, ctypes.c_int, _D])
        _sig(lib.rf_carry_chain_matrix,
             [_D, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _D])
        _sig(lib.rf_gaussian_weights, [ctypes.c_double, ctypes.c_int, _D])
        _sig(lib.rf_overlap_feedback,
             [_D, ctypes.c_int, _D, ctypes.c_int, _D])
        _U8 = ctypes.POINTER(ctypes.c_ubyte)
        _I = ctypes.POINTER(ctypes.c_int)
        lib.rf_ppm_read.argtypes = [ctypes.c_char_p, _I, _I, _I, _U8]
        lib.rf_ppm_read.restype = ctypes.c_int
        lib.rf_ppm_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8
        ]
        lib.rf_ppm_write.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def build() -> bool:
    """Compile the native library in-tree; returns success."""
    global _tried
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    _tried = False
    return available()


def _as_c(arr: np.ndarray):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(_D)


def impulse_matrix(feedfwd, feedback, tile_width, clamp_border=False):
    lib = _load()
    assert lib is not None
    fb, fb_p = _as_c(np.asarray(feedback))
    T = int(tile_width)
    out = np.zeros((T, T), dtype=np.float64)
    lib.rf_impulse_matrix(
        float(feedfwd), fb_p, len(fb), T, int(bool(clamp_border)),
        out.ctypes.data_as(_D),
    )
    return out


def state_matrix(feedback, tile_width):
    lib = _load()
    assert lib is not None
    fb, fb_p = _as_c(np.asarray(feedback))
    T = int(tile_width)
    out = np.zeros((T, len(fb)), dtype=np.float64)
    lib.rf_state_matrix(fb_p, len(fb), T, out.ctypes.data_as(_D))
    return out


def tail_weight_matrix(feedback, tile_width):
    lib = _load()
    assert lib is not None
    fb, fb_p = _as_c(np.asarray(feedback))
    k = len(fb)
    out = np.zeros((k, k), dtype=np.float64)
    lib.rf_tail_weight_matrix(fb_p, k, int(tile_width), out.ctypes.data_as(_D))
    return out


def carry_chain_matrix(feedback, tile_width, num_tiles, prev=True):
    lib = _load()
    assert lib is not None
    fb, fb_p = _as_c(np.asarray(feedback))
    k = len(fb)
    n = int(num_tiles)
    out = np.zeros((n * k, n * k), dtype=np.float64)
    lib.rf_carry_chain_matrix(
        fb_p, k, int(tile_width), n, int(bool(prev)), out.ctypes.data_as(_D)
    )
    return out


def gaussian_weights(sigma, order):
    lib = _load()
    assert lib is not None
    out = np.zeros(order + 1, dtype=np.float64)
    lib.rf_gaussian_weights(float(sigma), int(order), out.ctypes.data_as(_D))
    return list(out)


def overlap_feedback_coeff(a, b):
    lib = _load()
    assert lib is not None
    a_arr, a_p = _as_c(np.asarray(a, dtype=np.float64))
    b_arr, b_p = _as_c(np.asarray(b, dtype=np.float64))
    out = np.zeros(len(a_arr) + len(b_arr), dtype=np.float64)
    lib.rf_overlap_feedback(
        a_p, len(a_arr), b_p, len(b_arr), out.ctypes.data_as(_D)
    )
    return list(out)


def ppm_read(path: str) -> np.ndarray:
    """Native binary PPM/PGM reader (``demo/image_io.h`` analog)."""
    lib = _load()
    assert lib is not None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.rf_ppm_read(path.encode(), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c), None)
    if rc:
        raise IOError(f"rf_ppm_read({path}) header failed with code {rc}")
    buf = np.empty(w.value * h.value * c.value, dtype=np.uint8)
    rc = lib.rf_ppm_read(
        path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc:
        raise IOError(f"rf_ppm_read({path}) failed with code {rc}")
    img = buf.reshape(h.value, w.value, c.value)
    return img[:, :, 0] if c.value == 1 else img


def ppm_write(path: str, image: np.ndarray) -> None:
    """Native binary PPM/PGM writer."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    rc = lib.rf_ppm_write(
        path.encode(), w, h, c,
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc:
        raise IOError(f"rf_ppm_write({path}) failed with code {rc}")
