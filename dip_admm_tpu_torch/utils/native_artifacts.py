"""ctypes binding of the async artifact writer (``native/artifact_writer.cpp``).

Fire-and-forget float32 ``.npy`` and 8-bit grayscale PNG writes on a
background C++ thread pool, so the runner's per-node images overlap the
next run instead of waiting for each file. Callers check
:func:`available` and write with numpy otherwise; :func:`flush` must run
before the files are read back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from dip_admm_tpu_torch.utils import _native

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _native.load("artifact_writer")
        lib.aw_init.argtypes = [ctypes.c_int]
        lib.aw_submit_npy.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ]
        lib.aw_submit_png_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ]
        lib.aw_flush.argtypes = []
        lib.aw_init(2)
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except _native.NativeUnavailable:
        return False


def save_npy(path: str, arr: np.ndarray) -> None:
    """Queue a float32 ``.npy`` write (numpy's format)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    shape = (ctypes.c_long * a.ndim)(*a.shape)
    rc = _load().aw_submit_npy(
        path.encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        shape, ctypes.c_int(a.ndim))
    if rc != 0:
        raise RuntimeError(f"aw_submit_npy failed for {path}")


def save_png_gray(path: str, img: np.ndarray) -> None:
    """Queue an 8-bit grayscale PNG of a 2-D array, scaled from its min
    to its max."""
    a = np.ascontiguousarray(img, dtype=np.float32)
    if a.ndim != 2:
        raise ValueError(f"save_png_gray: a 2-D image, not {a.shape}")
    rc = _load().aw_submit_png_gray(
        path.encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(a.shape[0]), ctypes.c_int(a.shape[1]),
        ctypes.c_float(float(a.min())), ctypes.c_float(float(a.max())))
    if rc != 0:
        raise RuntimeError(f"aw_submit_png_gray failed for {path}")


def flush() -> None:
    """Block until every queued write is on disk."""
    _load().aw_flush()
