"""Loading the JAX package's problem bundle (``save_problem`` .npz).

The bundle holds ``__cfg__`` (the ProblemConfig as JSON bytes),
``__mode__``, the problem arrays, and the projector tables flattened with
"/" under ``__tbl__/`` (stored as they are) and ``__tbl16__/`` (bfloat16
stored as uint16 bit patterns, since numpy's zip format cannot hold
bfloat16). Loading it is how the JAX package's problem state crosses over
to the port.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from dip_admm_tpu_torch.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu_torch.data.loader import Problem, build_tables

_TBL = "__tbl__/"
_TBL16 = "__tbl16__/"


def _known(cls, d: dict) -> dict:
    """Drop keys that are not dataclass fields (bundles from other
    versions stay loadable)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def cfg_from_json(s: str) -> ProblemConfig:
    d = json.loads(s)
    return ProblemConfig(
        geometry=GeometryConfig(**_known(GeometryConfig, d["geometry"])),
        graph=GraphConfig(**_known(GraphConfig, d["graph"])),
        admm=AdmmConfig(**{
            **_known(AdmmConfig, d["admm"]),
            "node": NodeSolverConfig(**_known(NodeSolverConfig, d["admm"]["node"])),
        }),
        **_known(ProblemConfig, {k: v for k, v in d.items()
                                 if k not in ("geometry", "graph", "admm")}),
    )


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


_MODES = ("fft_skew", "fft_shear", "fft_mxu")  # parallel beam only
_ANY_BEAM = ("dense", "joseph")


def load_problem(path: str, device: torch.device | str) -> Problem:
    """Read a JAX ``save_problem`` bundle onto ``device``. Bundles of modes
    ``dense`` (its operator stack, the bundle's top-level ``A``) and
    ``joseph`` (its tap tables rebuilt from the angles), parallel or fan
    beam, and parallel-beam bundles of ``fft_skew``, ``fft_shear`` and
    ``fft_mxu`` are supported; the fft ones keep only the tap layout their
    mode reads (d-major ``WtT`` for ``fft_skew``, derived from a t-major
    ``Wt`` if the bundle has only that; t-major ``Wt`` for
    ``fft_shear``)."""
    device = torch.device(device)
    with np.load(path) as z:
        cfg = cfg_from_json(bytes(z["__cfg__"]).decode())
        mode = bytes(z["__mode__"]).decode()
        if not (mode in _ANY_BEAM
                or (mode in _MODES and not cfg.geometry.fan_beam)):
            raise NotImplementedError(
                f"bundle mode {mode!r} (fan_beam={cfg.geometry.fan_beam}) is "
                f"not ported yet (only {_ANY_BEAM} and parallel {_MODES})"
            )

        def t(a):
            return torch.as_tensor(np.array(a), device=device)

        flat = {}
        for k in z.files:
            if k.startswith(_TBL):
                flat[k[len(_TBL):]] = t(z[k])
            elif k.startswith(_TBL16):
                bits = torch.as_tensor(np.array(z[k]).view(np.int16))
                flat[k[len(_TBL16):]] = bits.view(torch.bfloat16).to(device)
        angles, valid = t(z["angles"]), t(z["angle_valid"])
        if mode == "dense":
            tables = {"A": t(z["A"])}
        elif flat:
            tables = _unflatten(flat)
            if mode == "fft_skew" and "WtT" not in tables:
                # bundles that carry only the t-major Wt
                tables["WtT"] = tables["Wt"].permute(0, 1, 3, 2, 4).contiguous()
            tables.pop("Wt" if mode == "fft_skew" else "WtT", None)
            for key in ("plane", "posfull", "invposfull", "pfirst"):
                if key in tables:
                    tables[key] = tables[key].to(torch.int32)
        else:
            tables = build_tables(cfg, angles, valid, mode)
        return Problem(
            cfg=cfg, mode=mode, angles=angles, angle_valid=valid,
            b=t(z["b"]), W=t(z["W"]), Q=t(z["Q"]), keep=t(z["keep"]),
            adj=t(z["adj"]), x_true=t(z["x_true"]), opnorm=t(z["opnorm"]),
            fft_tables=tables,
        )
