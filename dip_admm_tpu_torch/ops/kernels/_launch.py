"""The launch path of every kernel wrapper, and the checks they share.

At the sizes where a kernel takes a few microseconds of device time, most of
a wrapper's call is host work on the card's host: the checks of its inputs,
the allocation of its outputs, the library's lookup and the ctypes call
(``PERF.md`` §6 has the split). Two helpers take the repeated parts out of
each call:

- :class:`Entry`, a C entry point of a kernel library bound at its first
  call, so later calls skip ``_build.load`` and the attribute lookup. A
  launch raises on a nonzero return (a refused launch); a query (a scratch
  buffer's size, a cluster count) returns the entry's value;
- :class:`Checked`, a wrapper's checks memoized by the metadata of its
  arguments: the shape, strides, dtype and device of each tensor, and any
  other argument as it is. A signature seen before skips the checks and
  returns what they returned (dimensions, row pitches, scratch sizes). A
  new one runs them in full, so a bad input raises on its first call as on
  any later one, and only a signature whose checks passed is remembered,
  at most ``MEMO_LIMIT`` signatures a wrapper. Nothing that depends on a
  tensor's address (alignment, storage) may go into a memoized check: it
  would hold for the signature and not for the next tensor. Such tests are
  a :class:`Checked`'s ``every_call`` part, run on every call.

:func:`counters` gives a wrapper module its ``launch_counts`` and
``reset_launch_counts``.
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _build

# The signatures a memo keeps; past it, the memo starts again empty.
MEMO_LIMIT = 64


def _raise_if(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


class Entry:
    """The C entry ``fn`` of kernel library ``library``, bound at its first
    call. A launch names its wrapper in ``what`` and raises on a nonzero
    return; a query (``what`` None) returns the entry's value."""

    def __init__(self, library: str, fn: str, what: str | None = None):
        self.library, self.fn, self.what = library, fn, what
        self._c = None

    def __call__(self, *args):
        c = self._c
        if c is None:
            c = self._c = getattr(_build.load(self.library), self.fn)
        rc = c(*args)
        if self.what is None:
            return rc
        _raise_if(rc, self.what)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    return x


class Checked:
    """``check(*args)`` memoized by the arguments' metadata, then
    ``every_call(*args)``, where given, on every call (see the module
    docstring)."""

    def __init__(self, check, every_call=None):
        self._check = check
        self._every_call = every_call
        self._seen: dict = {}

    def __call__(self, *args):
        key = tuple(map(_meta, args))
        try:
            out = self._seen[key]
        except KeyError:
            out = self._check(*args)
            if len(self._seen) >= MEMO_LIMIT:
                self._seen.clear()
            self._seen[key] = out
        if self._every_call is not None:
            self._every_call(*args)
        return out

    def __len__(self) -> int:
        return len(self._seen)


def counters(*wrappers, **named):
    """``(launch_counts, reset_launch_counts)`` of a wrapper module: each of
    ``wrappers`` counts its launches in its attribute ``launches``, under
    its own name; ``named`` maps a further key to a (wrapper, attribute)
    pair. Every counter starts at 0."""
    where = {w.__name__: (w, "launches") for w in wrappers}
    where.update(named)

    def launch_counts() -> dict:
        return {k: getattr(w, a) for k, (w, a) in where.items()}

    def reset_launch_counts() -> None:
        for w, a in where.values():
            setattr(w, a, 0)

    reset_launch_counts()
    return launch_counts, reset_launch_counts


def _stream() -> int:
    """The current CUDA stream of the current device, as an int. The raw
    query skips the ``torch.cuda.Stream`` object that ``current_stream()``
    builds (about 6 us of host time per launch on an H100 host)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:  # the card's path first: it costs one attribute read
        return False
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check(name: str, tensors: dict, device, table_dtype, strided=()):
    """Device, type and contiguity of a kernel's tensors; those named in
    ``strided`` are exempt from contiguity (their caller checks their
    strides)."""
    if table_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported table dtype {table_dtype}")
    for k, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {k} is on {t.device}, expected {device}")
        if k not in strided and not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    for k, t in tensors.items():
        if k == "plane":
            if t.dtype != torch.int32:
                raise TypeError(f"{name}: {k} must be int32, got {t.dtype}")
        elif k in ("WtT", "Wt", "Dre", "Dim", "DreT", "DimT", "Wd", "Hre",
                   "Him", "Hre_g", "Him_g", "Hre_t", "Him_t"):
            if t.dtype != table_dtype:
                raise TypeError(
                    f"{name}: {k} is {t.dtype}, the tables are {table_dtype}"
                )
        elif t.dtype != torch.float32:
            raise TypeError(f"{name}: {k} must be float32, got {t.dtype}")


def _shape(name, t, shape, what):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _batches(name: str, PB: int, PT: int) -> None:
    if PT < 1 or PB % PT:
        raise ValueError(f"{name}: image batch {PB} is not a multiple of the "
                         f"table batch {PT}")
