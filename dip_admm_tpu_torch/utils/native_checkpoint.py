"""ctypes binding of the async checkpoint packer
(``native/checkpoint_packer.cpp``).

:func:`pack_npz` queues a multi-array ``.npz`` write (a stored zip that
``np.load`` reads, zip64 past 4 GiB) on a background C++ thread, so a
checkpoint overlaps the next segment of the solve. The packer writes a
temporary file and renames it into place, so a failed write leaves the
previous checkpoint intact. Callers check :func:`available` and write with
numpy otherwise; :func:`flush` must run before the file is read back.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from dip_admm_tpu_torch.utils import _native

# numpy dtype -> the packer's dtype code.
_DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.bool_): 4,
    np.dtype(np.uint8): 5,
}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _native.load("checkpoint_packer")
        lib.cp_init.argtypes = [ctypes.c_int]
        lib.cp_begin.restype = ctypes.c_longlong
        lib.cp_add.argtypes = [
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int,
        ]
        lib.cp_commit.argtypes = [ctypes.c_longlong, ctypes.c_char_p]
        lib.cp_abort.argtypes = [ctypes.c_longlong]
        lib.cp_flush.argtypes = []
        lib.cp_init(1)
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except _native.NativeUnavailable:
        return False


def _canonical(arr) -> np.ndarray:
    """A C-contiguous little-endian array of a dtype the packer takes
    (anything else as float32); 0-d arrays stay 0-d."""
    a = np.asarray(arr)
    if a.dtype not in _DTYPE_CODES:
        a = a.astype(np.float32)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return np.ascontiguousarray(a) if a.ndim > 0 else a


def pack_npz(path: str, arrays: dict) -> None:
    """Queue an ``.npz`` write of ``arrays`` (name -> array)."""
    lib = _load()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    handle = lib.cp_begin()
    try:
        for name, arr in arrays.items():
            a = _canonical(arr)
            shape = (ctypes.c_long * max(a.ndim, 1))(*(a.shape or (0,)))
            rc = lib.cp_add(handle, name.encode(), _DTYPE_CODES[a.dtype],
                            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            shape, ctypes.c_int(a.ndim))
            if rc != 0:
                raise RuntimeError(f"cp_add failed for {name!r} (rc={rc})")
        rc = lib.cp_commit(handle, path.encode())
        handle = None
        if rc != 0:
            raise RuntimeError(f"cp_commit failed for {path} (rc={rc})")
    finally:
        if handle is not None:
            lib.cp_abort(handle)


def flush() -> None:
    """Block until every queued write is on disk; raise if any failed (the
    previous checkpoint file then stays in place)."""
    n_failed = _load().cp_flush()
    if n_failed:
        raise RuntimeError(f"{n_failed} async checkpoint write(s) failed; "
                           "the previous checkpoint file was left in place")
