"""Build and load the host C++ helpers of ``native/`` (the async artifact
writer, the checkpoint packer and the per-pixel graph builder).

Each ``native/<name>.cpp`` is compiled with the host's ``g++`` (zlib and
pthreads) at its first use into ``build/native/`` beside the package,
named after a hash of its source and flags, so an edited source never
loads a stale build, and only what was built here is loaded. Nothing is
built at import time. A missing compiler or zlib raises
:class:`NativeUnavailable`; the callers then write with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = _ROOT / "native"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")
# Flags of one helper beyond GXX_FLAGS (the graph builder's OpenMP loop).
EXTRA_FLAGS = {"pixel_graphs": ("-fopenmp",)}

_lock = threading.Lock()
_loaded: dict = {}
_failed: dict = {}  # name -> the NativeUnavailable of its one build try


class NativeUnavailable(RuntimeError):
    pass


def _flags(name: str) -> tuple:
    return GXX_FLAGS + EXTRA_FLAGS.get(name, ())


def lib_path(name: str) -> Path:
    """Where the build of ``native/<name>.cpp`` goes (hash of source and
    flags in the name)."""
    src = (SRC_DIR / f"{name}.cpp").read_bytes()
    key = hashlib.sha1(src + " ".join(_flags(name) + LIBS).encode()
                       ).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``native/<name>.cpp``, built on first use
    (a temporary file renamed into place, so processes that build at once
    never load half a library). A failed build is not tried again."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        if name in _failed:
            raise _failed[name]
        src = SRC_DIR / f"{name}.cpp"
        if not src.exists():
            raise NativeUnavailable(f"source not found: {src}")
        out = lib_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = ["g++", *_flags(name), str(src), "-o", tmp, *LIBS]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                os.unlink(tmp)
                detail = getattr(e, "stderr", "") or str(e)
                _failed[name] = NativeUnavailable(
                    f"g++ build of {src.name} failed: {detail}")
                raise _failed[name] from e
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib
