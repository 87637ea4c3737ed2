#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dip_admm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers:

1. build    - compiles ``dip_admm_tpu_torch/csrc/shear_sum.cu`` with nvcc
              (sm_90a) and prints the card's name and power limit.
2. kernels  - at the 256^2/8 bench shapes, with the port's own bf16 tables
              and seeded inputs on the card, runs each of the four projector
              kernels and its plain PyTorch version, checks the error
              (<= 2e-3 of the output's max) and times both (median of 20
              runs after warm-up, CUDA events).
3. adjoint  - <Ax, y> = <x, A^T y> through the kernels with f32 tables at
              256^2/8, relative error <= 1e-5.
4. main     - builds the bench problem with the port's loader on the card
              (Shepp-Logan 256^2, 8 nodes, 768 angles, knn k=2, bf16 tables)
              and runs 20 outers of the <=200-inner Condat-Vu parity
              contract through ``run_admm``; every kernel must launch in
              the outers, the residuals must be finite and the mean PSNR
              within 0.5 dB of the JAX package's 30.51 dB. It prints the
              launches of the build and of the outers apart.

Then a JSON line with each kernel's route, source, launches on the main
path (build and outers together), error and times; the ``nvidia-smi``
name/power-limit line; and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or when any phase
fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

REF_PSNR = 30.51  # JAX package, 20 outers of the cv parity contract, 256^2/8
PSNR_TOL = 0.5
KERNEL_RTOL = 2e-3
ADJOINT_TOL = 1e-5
TIMED_RUNS = 20
SOURCE = "dip_admm_tpu_torch/csrc/shear_sum.cu"
REPLACES = {
    "skew_sum_planes": "dip_admm_tpu/ops/pallas/shear_sum.py:983",
    "skew_sum_planes_t": "dip_admm_tpu/ops/pallas/shear_sum.py:1002",
    "eval_shear": "dip_admm_tpu/ops/pallas/shear_sum.py:490",
    "eval_shear_t": "dip_admm_tpu/ops/pallas/shear_sum.py:511",
}


def _bench_cfg(table_dtype: str):
    from dip_admm_tpu_torch.config import (
        AdmmConfig, GeometryConfig, GraphConfig, NodeSolverConfig,
        ProblemConfig,
    )

    return ProblemConfig(
        geometry=GeometryConfig(N=256, num_nodes=8),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=20,
            eps_pri=0.0, eps_dual=0.0,  # never stop early
            # The fused consensus kernel is not ported yet: the consensus
            # runs as torch ops, a configuration the JAX package supports.
            use_pallas=False,
            node=NodeSolverConfig(max_inner=200, check_every=25),
        ),
        noise_level=0.005, noise_seed=0, phantom="shepp",
        fft_table_dtype=table_dtype,
    )


def _time_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _tables(torch, cfg, dev):
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon

    a, v, _ = radon.node_angles(cfg.geometry)
    angles = torch.as_tensor(a, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(v, device=dev)
    return loader.build_fft_tables(cfg, angles, valid)


def phase_build(torch) -> None:
    from dip_admm_tpu_torch.ops.kernels import _build

    info = _build.build("shear_sum")
    _build.load("shear_sum")
    nvcc = "cached" if info["seconds"] is None else f"{info['seconds']:.3f}"
    print(f"build: nvcc_s={nvcc}", flush=True)


def phase_kernels(torch, dev, failures) -> dict:
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    t = _tables(torch, _bench_cfg("bfloat16"), dev)
    sh = t["shared"]
    P, NB, D2, Tp, nb = t["WtT"].shape
    N, F, D = NB * nb, t["SEre"].shape[-1], t["Wd"].shape[1] * t["Wd"].shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.randn((P, N, N), generator=gen, device=dev)
    rows2 = torch.stack([img, img.transpose(1, 2)], dim=1).contiguous()
    g_re = torch.randn((P, Tp, F), generator=gen, device=dev)
    g_im = torch.randn((P, Tp, F), generator=gen, device=dev)
    ob = torch.randn((P, Tp, D), generator=gen, device=dev)
    cases = {
        "skew_sum_planes": (ss.skew_sum_planes, ss.skew_sum_planes_ref, (
            rows2, t["WtT"], t["SEre"], t["SEim"], sh["Dre"], sh["Dim"],
            t["plane"])),
        "skew_sum_planes_t": (ss.skew_sum_planes_t, ss.skew_sum_planes_t_ref, (
            g_re, g_im, t["WtT"], t["SEre"], t["SEim"], sh["DreT"],
            sh["DimT"], t["plane"])),
        "eval_shear": (ss.eval_shear, ss.eval_shear_ref, (
            g_re, g_im, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"],
            sh["PhiDim"])),
        "eval_shear_t": (ss.eval_shear_t, ss.eval_shear_t_ref, (
            ob, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"])),
    }
    out = {}
    for name, (kern, ref, args) in cases.items():
        got, want = kern(*args), ref(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        rel = err / scale if scale > 0 else math.inf
        ms = _time_ms(torch, lambda: kern(*args))
        plain_ms = _time_ms(torch, lambda: ref(*args))
        ok = finite and rel <= KERNEL_RTOL
        if not ok:
            failures.append(f"kernel {name}: rel err {rel} (finite={finite})")
        out[name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms)
        print(f"kernels: {name} shape={tuple(got[0].shape)} max_abs_err={err} "
              f"max_rel_err={rel} ms={ms} plain_ms={plain_ms} "
              f"ok={ok}", flush=True)

    from dip_admm_tpu_torch.ops import radon_fft

    geo = _bench_cfg("bfloat16").geometry
    x = img

    def pair():
        return radon_fft.backproject_nodes_skew(
            geo, radon_fft.project_nodes_skew(geo, x, t), t)

    pair_ms = _time_ms(torch, pair)
    print(f"kernels: apply_pair_ms={pair_ms} (project + backproject, bf16 "
          f"tables, P={P} N={N} Tp={Tp} F={F})", flush=True)
    out["apply_pair_ms"] = pair_ms
    del t
    torch.cuda.empty_cache()
    return out


def phase_adjoint(torch, dev, failures) -> None:
    from dip_admm_tpu_torch.ops import radon_fft

    cfg = _bench_cfg("float32")
    geo = cfg.geometry
    t = _tables(torch, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    P, N, T = geo.num_nodes, geo.N, max(geo.angles_per_node())
    x = torch.randn((P, N, N), generator=gen, device=dev)
    y = torch.randn((P, T, geo.n_det), generator=gen, device=dev)
    Ax = radon_fft.project_nodes_skew(geo, x, t)
    Aty = radon_fft.backproject_nodes_skew(geo, y, t)
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    rel = abs(lhs - rhs) / float(torch.linalg.norm(Ax.double())
                                 * torch.linalg.norm(y.double()))
    ok = math.isfinite(rel) and rel <= ADJOINT_TOL
    if not ok:
        failures.append(f"adjoint: rel {rel}")
    print(f"adjoint: rel_err={rel} lhs={lhs} rhs={rhs} ok={ok}", flush=True)
    del t
    torch.cuda.empty_cache()


def phase_main(torch, dev, failures) -> dict:
    from dip_admm_tpu_torch.core import admm
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss
    from dip_admm_tpu_torch.utils.imaging import psnr

    cfg = _bench_cfg("bfloat16")
    ss.reset_launch_counts()
    t0 = time.perf_counter()
    problem = loader.build_problem(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_counts = ss.launch_counts()
    t0 = time.perf_counter()
    res = admm.run_admm(problem, cfg.admm)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ss.launch_counts()
    run_counts = {k: counts[k] - build_counts[k] for k in counts}

    n = res.n_iters
    pri = float(res.history["primal"][n - 1])
    dual = float(res.history["dual"][n - 1])
    inner = res.history["inner_iters"][:n].float().mean().item()
    x = res.x.cpu().numpy()
    x_true = problem.x_true.cpu().numpy()
    mean_psnr = float(np.mean([psnr(xi, x_true, data_range=x_true.max())
                               for xi in x]))
    checks = {
        "outers": n == cfg.admm.max_iters,
        "shape": x.shape == (cfg.geometry.num_nodes, cfg.geometry.n),
        "finite": bool(np.isfinite(x).all()) and math.isfinite(pri)
        and math.isfinite(dual),
        "psnr": abs(mean_psnr - REF_PSNR) <= PSNR_TOL,
        "launches": all(c > 0 for c in run_counts.values()),
    }
    for k, ok in checks.items():
        if not ok:
            failures.append(f"main path check {k} failed")
    print(f"main: build_s={build_s} run_s={run_s} outer_iters={n} "
          f"outer_it_per_s={n / run_s} mean_inner_iters={inner} "
          f"final_primal={pri} final_dual={dual} mean_psnr={mean_psnr} "
          f"ref_psnr={REF_PSNR} build_launches={json.dumps(build_counts)} "
          f"run_launches={json.dumps(run_counts)} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30} "
          f"ok={all(checks.values())}", flush=True)
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port never falls back to the "
              "CPU here", file=sys.stderr)
        return 1
    try:
        import dip_admm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"gpu: {smi[0] if smi else 'nvidia-smi gave nothing'}", flush=True)

    failures: list[str] = []
    phase_build(torch)
    kern = phase_kernels(torch, dev, failures)
    phase_adjoint(torch, dev, failures)
    counts = phase_main(torch, dev, failures)
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"]}
        for name in REPLACES
    ]}))
    print(smi[0] if smi else "nvidia-smi gave nothing")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
