"""The system under test, ``dip_admm_tpu_torch``, driven as its users drive
it: a problem from ``data.loader.build_problem``, then reconstructions by
``core.admm.run_admm`` (one slice a call) or ``run_admm_batched`` (a
batch of slices a call). The benchmark takes from the program only these
entries, its kernel libraries, its launch counters and its kernel
wrappers' names; the inputs are made here from the seed.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from portbench import inputs
from portbench.reference.recon import psnr

PORT = "dip_admm_tpu_torch"
KERNEL_MODULES = ("shear_sum", "consensus", "filter_sum", "hat_eval",
                  "filter_mxu")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_kernels(names) -> float:
    """Build (nvcc, on a checkout's first run) and load the kernel
    libraries ``names``; the seconds it took."""
    from dip_admm_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    if names:
        with ThreadPoolExecutor(len(names)) as ex:
            list(ex.map(_build.build, names))
        for name in names:
            _build.load(name)
    return time.perf_counter() - t0


def _kernel_modules():
    import importlib

    return [importlib.import_module(f"{PORT}.ops.kernels.{m}")
            for m in KERNEL_MODULES]


def launch_counts() -> dict:
    """The program's counters of kernel wrapper calls that launched."""
    out = {}
    for m in _kernel_modules():
        out.update(m.launch_counts())
    return out


def reset_launch_counts() -> None:
    for m in _kernel_modules():
        m.reset_launch_counts()


def port_config(conf: dict, mix: dict, max_iters: int | None = None):
    """The program's ``ProblemConfig`` for a configuration and a mix's
    recipe, every knob stated."""
    from dip_admm_tpu_torch.config import (
        AdmmConfig, GeometryConfig, GraphConfig, NodeSolverConfig,
        ProblemConfig,
    )

    r = mix["recipe"]
    node = NodeSolverConfig(**r["node"])
    admm = AdmmConfig(**conf["admm"], relax_alpha=r["relax_alpha"],
                      max_iters=r["max_iters"] if max_iters is None
                      else max_iters, node=node)
    return ProblemConfig(
        geometry=GeometryConfig(**conf["geometry"]),
        graph=GraphConfig(**conf["graph"]), admm=admm,
        noise_level=conf["noise_level"], phantom="shepp", dtype=conf["dtype"],
        fft_table_dtype=conf["fft_table_dtype"])


class Program:
    """One cell's problem on the device and its reconstructions."""

    def __init__(self, conf: dict, mix: dict, seed: int, device):
        from dip_admm_tpu_torch.data import loader

        self.seed, self.device = seed, device
        self.cfg = port_config(conf, mix)
        self.scales = [float(s) for s in mix["scales"]]
        self.batched = bool(mix["batched"])
        geo = self.cfg.geometry
        self.P, self.n = geo.num_nodes, geo.n
        self.phantom = inputs.phantom(conf["phantom"], geo.N)
        v0 = inputs.normal((self.P, self.n), seed, inputs.OPNORM_V0,
                           device=device)
        self.lanczos_v0 = inputs.normal((self.n,), seed, inputs.LANCZOS_V0,
                                        device=device)
        m = max(geo.angles_per_node()) * geo.n_det
        sync(device)
        t0 = time.perf_counter()
        self.problem = loader.build_problem(
            self.cfg, device, mode=conf["mode"],
            noise=inputs.noise(seed, 0, 0, (self.P, m), device),
            opnorm_v0=v0, phantom_array=self.phantom)
        sync(device)
        self.build_s = time.perf_counter() - t0
        pb = self.problem
        self.x_true = pb.x_true
        self.clean = pb.forward(pb.x_true.expand(self.P, self.n))
        self.row_valid = pb.angle_valid.repeat_interleave(
            geo.n_det, dim=1).to(self.clean.dtype)

    def sinograms(self, r: int) -> torch.Tensor:
        """b [B, P, m] of reconstruction ``r``: lane j measures the
        phantom scaled by scales[j], with its own noise."""
        sigma = self.cfg.noise_level
        return torch.stack([
            s * self.clean + sigma * self.row_valid * inputs.noise(
                self.seed, r, j, self.clean.shape, self.device)
            for j, s in enumerate(self.scales)])

    def reconstruct(self, r: int, admm_cfg=None) -> dict:
        """Reconstruction ``r`` through the program's entry: {"x" [B, P, n],
        "Z", "Y" [B, P, P, n], "outers" (image-outers, a tensor),
        "psnr" [B] (mean over nodes, on the device)}."""
        from dip_admm_tpu_torch.core import admm

        cfg = self.cfg.admm if admm_cfg is None else admm_cfg
        b = self.sinograms(r)
        xt = torch.stack([s * self.x_true for s in self.scales])
        if self.batched:
            res = admm.run_admm_batched(self.problem, b, xt, cfg,
                                        lanczos_v0=self.lanczos_v0)
            x, Z, Y = res.x, res.state.Z, res.state.Y
            outers = torch.as_tensor(res.n_iters).sum()
        else:
            p = dataclasses.replace(self.problem, b=b[0], x_true=xt[0])
            res = admm.run_admm(p, cfg, lanczos_v0=self.lanczos_v0)
            x, Z, Y = res.x[None], res.state.Z[None], res.state.Y[None]
            outers = torch.tensor(res.n_iters)
        rng = torch.tensor([s * float(self.phantom.max())
                            for s in self.scales])
        ps = torch.stack([psnr(x[j], xt[j], float(rng[j])).mean()
                          for j in range(len(self.scales))])
        return {"r": r, "x": x, "Z": Z, "Y": Y, "outers": outers, "psnr": ps}

    def apply_pair(self, imgs: torch.Tensor) -> torch.Tensor:
        """One forward and adjoint of the projector on [K, n] images, K a
        multiple of P (image k on node k % P), as the node solver applies
        it."""
        return self.problem.adjoint(self.problem.forward(imgs))


def capture_calls(wrappers: dict, fn) -> list:
    """Run ``fn()`` with the program's kernel wrappers ``{name: function}``
    recorded: every call as (name, args, kwargs, output). Each reference
    to a wrapper in the program's modules but its own is replaced while
    ``fn`` runs, and restored after."""
    calls: list = []
    patched = []

    def spy(name, f):
        def call(*args, **kwargs):
            out = f(*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return call

    by_id = {id(f): (name, f) for name, f in wrappers.items()}
    for mod in list(sys.modules.values()):
        mname = getattr(mod, "__name__", "")
        if mname.split(".")[0] != PORT:
            continue
        for attr, val in list(vars(mod).items()):
            if id(val) in by_id and by_id[id(val)][1].__module__ != mname:
                name, f = by_id[id(val)]
                setattr(mod, attr, spy(name, f))
                patched.append((mod, attr, val))
    try:
        fn()
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)
    return calls
