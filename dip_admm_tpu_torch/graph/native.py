"""ctypes binding of the native per-pixel graph builder
(``native/pixel_graphs.cpp``, knn and mst over all pixels in an OpenMP
loop), with the JAX package's ``build_pixel_masks_native`` signature and
mask semantics (the same tie-breaking as ``graph/topology.py``: the first
index wins).

A host path: it reads q from host memory and returns host masks, for very
large pixel counts or a process without a card; the torch builder
(``topology.build_pixel_masks``) stays the default. The library is built
by ``utils/_native.py`` at first use into ``build/native/``, never next to
the source; nothing is built at import time.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dip_admm_tpu_torch.utils import _native

_STRATEGIES = {"knn": 0, "mst": 1}
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _native.load("pixel_graphs")
        lib.build_pixel_masks.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.build_pixel_masks.restype = None
        lib.pixel_graphs_num_threads.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the builder builds here (g++ with OpenMP)."""
    try:
        _load()
        return True
    except _native.NativeUnavailable:
        return False


def num_threads() -> int:
    """The OpenMP threads the builder runs on."""
    return _load().pixel_graphs_num_threads()


def build_pixel_masks_native(q, strategy: str = "knn", k: int = 2
                             ) -> np.ndarray:
    """keep [P, P, n] bool from the weights q [P, P, n] (numpy, or a
    tensor on any device) under ``strategy`` "knn" or "mst": q is
    symmetrized and its diagonal zeroed as the torch builder does, then the
    C++ core runs over every pixel."""
    strat = _STRATEGIES.get(strategy)
    if strat is None:
        raise ValueError("the native builder runs 'knn' and 'mst', not "
                         f"{strategy!r}")
    lib = _load()
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    q = np.asarray(q, dtype=np.float32)
    P, n = q.shape[0], q.shape[2]
    q_sym = 0.5 * (q + q.transpose(1, 0, 2))
    q_sym[np.arange(P), np.arange(P), :] = 0.0
    qp = np.ascontiguousarray(np.moveaxis(q_sym, -1, 0))  # [n, P, P]
    out = np.zeros((n, P, P), dtype=np.uint8)
    lib.build_pixel_masks(
        qp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ctypes.c_int64(n),
        ctypes.c_int(P), ctypes.c_int(strat), ctypes.c_int(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    keep = np.moveaxis(out.astype(bool), 0, -1)  # [P, P, n]
    return keep | keep.transpose(1, 0, 2)
