"""A lean launch path for the kernel wrappers.

At the sizes where a kernel takes a few microseconds of device time, most of
a wrapper's call is host work on the card's host: the checks of its inputs,
the allocation of its outputs, the library's lookup and the ctypes call
(``PERF.md`` §6 has the split). Two helpers take the repeated parts out of
each call:

- :class:`Entry`, a C entry point of a kernel library bound at its first
  call, so later calls skip ``_build.load`` and the attribute lookup, and
  raising on a nonzero return (a refused launch);
- :class:`Checked`, a wrapper's checks memoized by the metadata of its
  arguments: the shape, strides, dtype and device of each tensor, and any
  other argument as it is. A signature seen before skips the checks and
  returns what they returned. A new one runs them in full, so a bad input
  raises on its first call as on any later one, and only a signature whose
  checks passed is remembered, at most ``MEMO_LIMIT`` signatures a
  wrapper. Nothing that depends on a tensor's address (alignment,
  storage) may go into a memoized check: it would hold for the signature
  and not for the next tensor. The kernels of this path branch on
  alignment themselves; a wrapper whose checks test alignment keeps those
  tests out of the memo, run on every call.

Used by K5 (``consensus.py``), K17/K18 (``hat_eval.py``) and the fused
Condat-Vu step (``cv_step.py``).
"""

from __future__ import annotations

import torch

from dip_admm_tpu_torch.ops.kernels import _build
from dip_admm_tpu_torch.ops.kernels.shear_sum import _raise_if

# The signatures a memo keeps; past it, the memo starts again empty.
MEMO_LIMIT = 64


class Entry:
    """The C entry ``fn`` of kernel library ``library``, bound at its first
    call; ``what`` names the wrapper in the error a refused launch raises."""

    def __init__(self, library: str, fn: str, what: str):
        self.library, self.fn, self.what = library, fn, what
        self._c = None

    def __call__(self, *args) -> None:
        c = self._c
        if c is None:
            c = self._c = getattr(_build.load(self.library), self.fn)
        _raise_if(c(*args), self.what)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    return x


class Checked:
    """``check(*args)`` memoized by the arguments' metadata (see the module
    docstring)."""

    def __init__(self, check):
        self._check = check
        self._seen: dict = {}

    def __call__(self, *args):
        key = tuple(map(_meta, args))
        try:
            return self._seen[key]
        except KeyError:
            pass
        out = self._check(*args)
        if len(self._seen) >= MEMO_LIMIT:
            self._seen.clear()
        self._seen[key] = out
        return out

    def __len__(self) -> int:
        return len(self._seen)
