"""Problem bundles and run checkpoints, in the JAX package's formats.

A problem bundle (``save_problem``/``load_problem``) is one uncompressed
``.npz``: ``__cfg__`` (the ProblemConfig as JSON bytes), ``__mode__``, the
problem arrays (``angles``, ``angle_valid``, ``b``, ``W``, ``Q``, ``keep``,
``adj``, ``x_true``, ``opnorm``, and ``A`` for mode ``dense``), and the fft
modes' projector tables flattened with "/" under ``__tbl__/`` (stored as
they are) and ``__tbl16__/`` (bfloat16 stored as 16-bit patterns, since
numpy's zip format cannot hold bfloat16). Each package loads the other's
bundles.

A checkpoint (``save_checkpoint``/``load_checkpoint``) is an ``.npz`` of
the loop state (``x``, ``ux``, ``uy``, ``ua``, ``xp``, ``tk``, ``Z``,
``Y``, ``k``, ``stop``, ``rho_scale``) and the history (``hist_<name>``):
``run_admm(state=..., hist=...)`` continues from it where the run stopped,
in either package. ``save_checkpoint_async`` queues the same payload on
the native packer's thread (``utils/native_checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from dip_admm_tpu_torch.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu_torch.core.admm import HISTORY_FIELDS, AdmmState
from dip_admm_tpu_torch.core.node_solver import NodeState
from dip_admm_tpu_torch.data.loader import Problem, build_tables
from dip_admm_tpu_torch.ops.kernels.filter_sum import pitched_zeros
from dip_admm_tpu_torch.utils import native_checkpoint

_TBL = "__tbl__/"
_TBL16 = "__tbl16__/"


def _known(cls, d: dict) -> dict:
    """Drop keys that are not dataclass fields (bundles from other
    versions stay loadable)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def cfg_to_json(cfg: ProblemConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg))


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


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (a pitched view comes out dense)."""
    return x.detach().cpu().contiguous().numpy()


def save_problem(problem: Problem, path: str,
                 include_tables: bool = True) -> None:
    """Write ``problem`` as a bundle that either package loads (see the
    module docstring). ``include_tables`` also stores the fft modes'
    projector tables, so that a load skips their build; ``dense`` keeps its
    operator stack as the top-level ``A`` and ``joseph`` its angles only
    (its tap tables are rebuilt on load), as the JAX package does."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {k: getattr(problem, k) for k in (
        "angles", "angle_valid", "b", "W", "Q", "keep", "adj", "x_true",
        "opnorm")}
    if problem.mode == "dense":
        arrays["A"] = problem.A
    out = {k: _numpy(v) for k, v in arrays.items()}
    if include_tables and problem.mode.startswith("fft"):
        tables = _jax_layout(problem.fft_tables, problem.mode)
        for k, v in _flatten(tables).items():
            if v.dtype == torch.bfloat16:
                out[_TBL16 + k] = _numpy(v.view(torch.int16)).view(np.uint16)
            else:
                out[_TBL + k] = _numpy(v)
    np.savez(
        path,
        __cfg__=np.frombuffer(cfg_to_json(problem.cfg).encode(), np.uint8),
        __mode__=np.frombuffer(problem.mode.encode(), np.uint8),
        **out,
    )


def _jax_layout(tables: dict, mode: str) -> dict:
    """Projector tables as the JAX package lays them out: a fan-beam
    mode-``fft`` set, kept once under ``"shared"`` in the port
    (``radon_fan.precompute_fan_nodes``), repeated over the nodes as JAX's
    vmap builds it; every other set as it is."""
    if mode == "fft" and "shared" in tables:
        P = tables["fan_valid"].shape[0]
        return {**{k: v.expand(P, *v.shape[1:])
                   for k, v in tables["shared"].items()},
                "fan_valid": tables["fan_valid"]}
    return tables


_INT_KEYS = ("plane", "posfull", "invposfull", "pfirst")
# Tables the K11-K14 kernels stream in pitched rows (Cre/Cim: pitched F
# rows), as the port's own fft_pallas and fft_grouped builds lay them out.
_PITCHED = ("Hre", "Him", "Hre_g", "Him_g", "Ere", "Eim")
_PITCHED_ROWS = ("Cre", "Cim")


def _port_layout(tables: dict, mode: str) -> dict:
    """A bundle's tables as the port's projectors read them: the one tap
    layout of ``fft_skew`` (d-major ``WtT``, derived from a t-major ``Wt``
    if the bundle has only that) and of ``fft_shear`` (``Wt``), int32 index
    tables, and pitched storage for the ``fft_pallas`` and ``fft_grouped``
    streams. Fan bundles keep their parallel stage under ``shared/par``;
    a fan mode-``fft`` bundle (one table set a node, all equal but the row
    mask) keeps its first node's under ``"shared"``
    (``radon_fan.precompute_fan_nodes``)."""
    if mode == "fft" and "rebin_re" in tables:
        fan_valid = tables.pop("fan_valid")
        return {"shared": {k: v[:1].clone() for k, v in tables.items()},
                "fan_valid": fan_valid}
    for t in (tables, tables.get("shared", {}).get("par")):
        if not isinstance(t, dict):
            continue
        if mode == "fft_skew" and "Wt" in t and "WtT" not in t:
            t["WtT"] = t["Wt"].permute(0, 1, 3, 2, 4).contiguous()
        if mode in ("fft_skew", "fft_shear"):
            t.pop("Wt" if mode == "fft_skew" else "WtT", None)
        for key in _INT_KEYS:
            if key in t:
                t[key] = t[key].to(torch.int32)
        if mode in ("fft_pallas", "fft_grouped"):
            for key, dim in ([(k, -1) for k in _PITCHED]
                             + [(k, -2) for k in _PITCHED_ROWS]):
                if key in t:
                    v = t[key]
                    t[key] = pitched_zeros(v.shape, v.dtype, v.device,
                                           dim=dim).copy_(v)
    return tables


_MODES = ("fft", "fft_skew", "fft_grouped")  # parallel and fan beam
_PARALLEL_MODES = ("fft_shear", "fft_mxu", "fft_pallas")
_ANY_BEAM = ("dense", "joseph")


def load_problem(path: str, device: torch.device | str = "cuda") -> Problem:
    """Read a bundle of either package onto ``device``. Bundles of modes
    ``dense`` (its operator stack, the bundle's top-level ``A``),
    ``joseph`` (its tap tables rebuilt from the angles), ``fft``,
    ``fft_skew`` and ``fft_grouped``, parallel or fan beam, and
    parallel-beam bundles of
    ``fft_shear``, ``fft_mxu`` and ``fft_pallas`` are supported, their
    tables in the port's layout (:func:`_port_layout`); an fft bundle
    without tables has them built."""
    device = torch.device(device)
    with np.load(path) as z:
        cfg = cfg_from_json(bytes(z["__cfg__"]).decode())
        mode = bytes(z["__mode__"]).decode()
        fan = cfg.geometry.fan_beam
        if not (mode in _ANY_BEAM + _MODES
                or (mode in _PARALLEL_MODES and not fan)):
            raise NotImplementedError(
                f"bundle mode {mode!r} (fan_beam={fan}): {mode} supports "
                "parallel beam only" if mode in _PARALLEL_MODES
                else f"bundle mode {mode!r} is unknown")

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
            tables = _port_layout(_unflatten(flat), mode)
        else:
            tables = build_tables(cfg, angles, valid, mode)
        return Problem(
            cfg=cfg, mode=mode, angles=angles, angle_valid=valid,
            b=t(z["b"]), W=t(z["W"]), Q=t(z["Q"]), keep=t(z["keep"]),
            adj=t(z["adj"]), x_true=t(z["x_true"]), opnorm=t(z["opnorm"]),
            fft_tables=tables,
        )


def _checkpoint_payload(state: AdmmState, hist: dict) -> dict:
    nd = state.node
    return {
        **{k: _numpy(getattr(nd, k)) for k in NodeState._fields},
        "Z": _numpy(state.Z),
        "Y": _numpy(state.Y),
        "k": np.asarray(state.k, np.int32),
        "stop": np.asarray(state.stop, np.bool_),
        "rho_scale": _numpy(torch.as_tensor(state.rho_scale)),
        **{f"hist_{k}": _numpy(v) for k, v in hist.items()},
    }


def _save_npz(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **payload)


def save_checkpoint(path: str, state: AdmmState, hist: dict) -> None:
    """Write the loop state and history to ``path`` (compressed ``.npz``)."""
    _save_npz(path, _checkpoint_payload(state, hist))


_said_numpy = False


def checkpoint_writer() -> str:
    """"native" where the packer builds (g++ and zlib), else "numpy"."""
    return "native" if native_checkpoint.available() else "numpy"


def save_checkpoint_async(path: str, state: AdmmState, hist: dict) -> None:
    """Queue :func:`save_checkpoint`'s payload on the native packer's
    thread (a stored zip, written to a temporary file and renamed), so the
    loop does not wait for it; call :func:`flush_checkpoints` before
    reading it. Without the packer it writes with numpy at once, and says
    so once on stderr."""
    global _said_numpy
    payload = _checkpoint_payload(state, hist)
    if checkpoint_writer() == "native":
        native_checkpoint.pack_npz(path, payload)
        return
    if not _said_numpy:
        print("checkpoints: the native packer does not build here (g++ or "
              "zlib missing); writing them with numpy", file=sys.stderr)
        _said_numpy = True
    _save_npz(path, payload)


def flush_checkpoints() -> None:
    """Block until the queued :func:`save_checkpoint_async` writes are on
    disk (raises if one failed)."""
    if checkpoint_writer() == "native":
        native_checkpoint.flush()


def _upgrade_history(hist: dict) -> dict:
    """Add the history fields a checkpoint lacks (written before a field
    existed), NaN as for iterations not reached."""
    T = hist["primal"].shape[0]
    P = hist["g_norm"].shape[1]
    ref = hist["primal"]
    for name, per_node in HISTORY_FIELDS:
        if name not in hist:
            hist[name] = torch.full((T, P) if per_node else (T,),
                                    float("nan"), dtype=ref.dtype,
                                    device=ref.device)
    return hist


def load_checkpoint(path: str, device: torch.device | str = "cuda"
                    ) -> tuple[AdmmState, dict]:
    """A checkpoint of either package as the port's (state, history) on
    ``device``. Fields added after a checkpoint was written take their
    neutral values: ``xp`` zeros, ``tk`` inf (a fresh step), ``rho_scale``
    1 (fixed rho), missing history fields NaN."""
    device = torch.device(device)
    with np.load(path) as z:
        def t(k):
            return torch.as_tensor(np.array(z[k]), device=device)

        x = t("x")
        node = NodeState(
            x=x, ux=t("ux"), uy=t("uy"), ua=t("ua"),
            xp=t("xp") if "xp" in z.files else torch.zeros_like(x),
            tk=t("tk") if "tk" in z.files else torch.full(
                (x.shape[0],), float("inf"), dtype=x.dtype, device=device),
        )
        state = AdmmState(
            node=node, Z=t("Z"), Y=t("Y"), k=int(z["k"]),
            stop=bool(z["stop"]),
            rho_scale=t("rho_scale") if "rho_scale" in z.files
            else torch.tensor(1.0, dtype=x.dtype, device=device),
        )
        hist = {k[len("hist_"):]: t(k) for k in z.files
                if k.startswith("hist_")}
    return state, _upgrade_history(hist)
