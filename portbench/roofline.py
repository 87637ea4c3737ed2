"""The least time the card could take for a kernel's work, from the
published peaks of ``peaks.json`` (found by the longest key that starts
the device's name): bytes over the HBM bandwidth, or float32 operations
over the CUDA cores' rate plus bfloat16 operations over the tensor cores',
whichever is larger."""

from __future__ import annotations

import json

from portbench.spec import HERE


def peaks(device_name: str) -> dict | None:
    with open(HERE / "peaks.json") as f:
        table = json.load(f)
    keys = [k for k in table if device_name.startswith(k)]
    return table[max(keys, key=len)] if keys else None


def bound_ms(nbytes: float, f32: float, bf16: float, pk: dict):
    """(ms, "bytes" or "operations")."""
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    t_ops = f32 / pk["f32_flops_per_s"] + bf16 / pk["bf16_flops_per_s"]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(x) -> int:
    """Bytes of every tensor in ``x`` (a tensor, or nested tuples)."""
    if isinstance(x, (tuple, list)):
        return sum(nbytes(a) for a in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0
