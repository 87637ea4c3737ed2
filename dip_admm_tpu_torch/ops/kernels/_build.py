"""Build and load the CUDA kernels of ``dip_admm_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, at its first use, and
loaded with ctypes. The library goes to ``build/kernels/`` beside the
package, named after a hash of its source and flags, so an edited source
never loads a stale build. Nothing is built at import time, and a failed
build or load raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from dip_admm_tpu_torch.utils import profiling

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# argtypes of every C entry point, by library.
SIGNATURES = {
    "shear_sum": {
        "dip_skew_fwd": [_P] * 10 + [_I] * 11 + [_P],
        "dip_skew_fwd_scratch": [_I] * 8,
        "dip_skew_t": [_P] * 10 + [_I] * 11 + [_P],
        "dip_skew_t_scratch": [_I] * 7,
        "dip_eval_fwd": [_P] * 9 + [_I] * 8 + [_P],
        "dip_eval_t": [_P] * 9 + [_I] * 8 + [_P],
        "dip_shear_scratch": [_I] * 4,
        "dip_shear_fwd": [_P] * 11 + [_I] * 9 + [_P],
        "dip_shear_t": [_P] * 11 + [_I] * 9 + [_P],
    },
    "filter_mxu": {
        "dip_mxu_fwd": [_P] * 6 + [_I] * 8 + [_P],
        "dip_mxu_t": [_P] * 6 + [_I] * 8 + [_P],
    },
    "filter_sum": {
        "dip_sel_fwd": [_P] * 7 + [_I] * 8 + [_P],
        "dip_sel_t": [_P] * 7 + [_I] * 9 + [_P],
        "dip_grp_fwd": [_P] * 6 + [_I] * 10 + [_P],
        "dip_grp_t": [_P] * 6 + [_I] * 11 + [_P],
    },
    "hat_eval": {
        "dip_hat_fwd": [_P] * 4 + [_I] * 5 + [_P],
        "dip_hat_t": [_P] * 4 + [_I] * 5 + [_P],
    },
    "consensus": {
        "dip_consensus": [_P] * 9 + [_I] * 4 + [_P],
        "dip_consensus_sharded": [_P] * 11 + [_I] * 4 + [_P],
        "dip_consensus_clusters": [_I] * 2,
    },
    "cv_step": {
        "dip_cv_grad": [_P] * 7 + [_D, _I, _P, _I, _I, _I, _P],
        "dip_cv_update": [_P] * 5 + [_D, _I, _P, _D, _I, _P, _D, _I]
        + [_P] * 3 + [_I, _I, _I, _P],
    },
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists.
    Returns {"path", "built", "seconds"}; ``seconds`` is nvcc's wall time,
    None when the library was already built."""
    out = library_path(name)
    if out.exists():
        return {"path": str(out), "built": False, "seconds": None}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    profiling.count("kernels.nvcc")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "built": True, "seconds": seconds}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with profiling.span("kernels.load", lib=name) as sp:
        built = build(name)
        sp.attrs["built"] = built["built"]
        lib = ctypes.CDLL(built["path"])
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib
