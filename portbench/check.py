"""What decides ``correct``: the plain reference (``reference/``) works
out, from the same seed-made inputs (phantom, noise, power-method and
Lanczos starts), its own operator (parallel or fan beam, as the
configuration's geometry states), sinograms, column norms, graph,
preconditioner and reconstruction of each sampled reconstruction of the
window, and the program's outputs are held to it:

- ``x_gap``: the widest relative gap ||x - x_ref|| / ||x_ref|| of a
  node's image, over the lanes and nodes of the samples;
- ``z_gap``: the widest relative gap of a lane's consensus variables Z
  (every node pair's z_ij) against the reference's;
- ``psnr_gap``: the widest gap, in dB, of a lane's mean-over-nodes PSNR
  from the reference's.

A cell compares the numbers its ``limits/<cell>.json`` names, each with
the limit set from the program's readings and the lower-precision
control's; the others are reported beside them. A number that is not
finite fails."""

from __future__ import annotations

import math

import torch

from portbench import inputs
from portbench.reference.fan import FanProjector
from portbench.reference.projector import Projector
from portbench.reference.recon import psnr, reconstruct

NUMBERS = ("x_gap", "z_gap", "psnr_gap")


def recipe(conf: dict, mix: dict) -> dict:
    r = mix["recipe"]
    return {**conf["admm"], "relax_alpha": r["relax_alpha"],
            "max_iters": r["max_iters"], "node": r["node"]}


def projector(conf: dict, device, tap_dtype=None,
              operand_dtype=None) -> Projector:
    """The reference operator of the configuration's geometry: the fan
    beam's (``reference/fan.py``) where it states ``fan_beam``, else the
    parallel beam's (``reference/projector.py``)."""
    g = conf["geometry"]
    if conf["graph"]["strategy"] != "knn" \
            or conf["graph"]["q_mode"] != "arithmetic" \
            or conf["admm"]["z_fusion"] != "midpoint":
        raise ValueError("the reference runs knn graphs, arithmetic Q and "
                         "midpoint fusion only")
    args = (g["N"], g["num_nodes"], g.get("angles_total"),
            g.get("det_pixels"), g.get("det_width_factor", 1.0))
    kw = {"device": device, "tap_dtype": tap_dtype,
          "operand_dtype": operand_dtype}
    if g.get("fan_beam"):
        return FanProjector(*args, g["src_radius"], g["det_radius"], **kw)
    return Projector(*args, **kw)


def truth(conf: dict, mix: dict, lane: int, device):
    """(x_true [n] of lane ``lane``, its PSNR data range)."""
    ph = inputs.phantom(conf["phantom"], conf["geometry"]["N"])
    s = float(mix["scales"][lane])
    x = torch.as_tensor(ph, dtype=torch.float32, device=device).reshape(-1)
    return s * x, s * float(ph.max())


def reference_run(proj: Projector, conf: dict, mix: dict, seed: int, r: int,
                  lane: int, state_dtype=None):
    """The reference's reconstruction of lane ``lane`` of reconstruction
    ``r``: (x [P, n], Z [P, P, n]); ``state_dtype`` as in
    ``recon.reconstruct``."""
    dev = proj.row_valid.device
    N, P, n = proj.N, proj.P, proj.n
    x_true, _ = truth(conf, mix, lane, dev)
    b = proj.fwd(x_true.expand(P, n)) + conf["noise_level"] \
        * proj.row_valid * inputs.noise(seed, r, lane, (P, proj.m), dev)
    x, Z, _ = reconstruct(
        proj, b, recipe(conf, mix),
        lanczos_v0=inputs.normal((n,), seed, inputs.LANCZOS_V0, device=dev),
        opnorm_v0=inputs.normal((P, n), seed, inputs.OPNORM_V0, device=dev),
        graph_k=conf["graph"]["k"], state_dtype=state_dtype)
    return x, Z


def gaps(x, Z, x_ref, Z_ref, x_true, data_range) -> dict:
    """The numbers of one lane: x [P, n] and Z [P, P, n] against the
    reference's."""
    xg = torch.linalg.norm(x - x_ref, dim=-1) / torch.linalg.norm(
        x_ref, dim=-1)
    zg = torch.linalg.norm(Z - Z_ref) / torch.linalg.norm(Z_ref)
    pg = psnr(x, x_true, data_range).mean() - psnr(
        x_ref, x_true, data_range).mean()
    return {"x_gap": float(xg.max()), "z_gap": float(zg),
            "psnr_gap": abs(float(pg))}


def compare(samples: list, conf: dict, mix: dict, seed: int, device) -> dict:
    """The widest of each number over ``samples`` (each {"r", "x" [B, P,
    n], "Z" [B, P, P, n]} of the program)."""
    proj = projector(conf, device)
    worst = {k: 0.0 for k in NUMBERS}
    for smp in samples:
        for lane in range(smp["x"].shape[0]):
            x_ref, Z_ref = reference_run(proj, conf, mix, seed, smp["r"], lane)
            got = gaps(smp["x"][lane].to(device), smp["Z"][lane].to(device),
                       x_ref, Z_ref, *truth(conf, mix, lane, device))
            for k, v in got.items():
                worst[k] = v if not math.isfinite(v) else max(worst[k], v)
    return worst


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name: each finite and at most its limit."""
    out, ok = {}, True
    for k, spec in limits["numbers"].items():
        v = numbers[k]
        out[k] = {"value": v, "limit": spec["limit"]}
        ok = ok and math.isfinite(v) and v <= spec["limit"]
    return ok, out
