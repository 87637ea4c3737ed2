#!/usr/bin/env python3
"""Parity, recommended, shear recommended, mesh_bench, 512^2 pallas, fan
grouped and 512^2 grouped recommended outer rates of the PyTorch port on
one GPU, and the per-call times of the skew transpose row stage, the eval
tail, the shear row stages and the select and grouped filter-sums, for
comparing two checkouts in one call on one card.

    python3 scripts/torch_ab_rates.py ROOT [--only grouped|rates]

runs, from the checkout at ROOT (its own ``chip_smoke.py`` and kernels):
the build; K2 (``skew_sum_planes_t``), K3 (``eval_shear``) and K4
(``eval_shear_t``) at the 256^2/8 bench and fan shapes, K3/K4 at a 2 x 2
mesh rank's node block (P_loc = 4) and K6 (``skew_sum_planes_t_rows``) at
row shard 0 of 2 of that node block and of the fan tables, K7
(``shear_sum_planes``) and K8 (``shear_sum_planes_t``) on the 256^2/8
``fft_shear`` problem's tables, each the median of 20 calls (CUDA events,
bf16 tables, seeded spectra and cotangents), and that problem's apply pair
(project + backproject); 20 parity and 20 recommended outers of the
256^2/8 bench problem on one device, and 20 recommended outers of the
``fft_shear`` problem; 20 recommended outers on a 2 x 2 node x pixel
mesh of four processes sharing the card (``chip_smoke.py``'s phases 5, 6,
6b and 18 without their reference checks); then K11 (``filter_sum_sel``)
and K12 (``filter_sum_sel_t``) on the 512^2/8 ``fft_pallas`` problem's
tables, on the spectra and cotangents that checkout's projector makes, its
apply pair, and 20 recommended outers of it (phase 14's pallas run, the
preconditioner's build inside the rate).
Last come K13 (``filter_sum_grouped``) and K14 (``filter_sum_grouped_t``)
on the fan 256^2/8 problem's shared ``fft_grouped`` tables and on the
512^2/8 ``fft_grouped`` problem's, each per call (CUDA events) and by
device time (``torch.profiler``), on the slot spectra and cotangents that
checkout's projector makes, with each problem's apply pair and 20
recommended outers of it (phase 10's and phase 14's grouped runs). With
``--only grouped`` it runs the build and that last part alone; with
``--only rates`` the build, then the dense flagship (64^2/5, 200 outers
of cv with the 1e-3 stop; phase 22's run) and 20 parity and 20
recommended outers of the 256^2/8 bench problem, each twice (the first
run of each warms the process up).
It prints a line for each. Alternate the checkouts, e.g. with the parent
unpacked by ``git archive`` into ``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_ab_rates.py $PWD/$r; done
"""

import os
import sys

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
ROOT = os.path.abspath(ARGS[0]) if ARGS else os.getcwd()
ONLY = (sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv
        else None)
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _kernel_ms(t, P, tag) -> dict:
    """K2, K3 and K4 on the skew tables ``t`` (all P node images; the fan's
    shared table set), K6 on row shard 0 of 2 of a 2 x 2 mesh rank's node
    block (the fan: every node) and, on the bench tables, K3/K4 on that
    node block, per call in ms."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss
    from dip_admm_tpu_torch.parallel.mesh import slice_tables

    gen = torch.Generator(device="cuda").manual_seed(0)
    _, NB, _, Tp, nb = t["WtT"].shape
    F = t["SEre"].shape[-1]
    _, DB, _, _, db = t["Wd"].shape
    g = [torch.randn((P, Tp, F), generator=gen, device="cuda")
         for _ in range(2)]
    ob = torch.randn((P, Tp, DB * db), generator=gen, device="cuda")
    sh = t["shared"]
    k2 = (*g, t["WtT"], t["SEre"], t["SEim"], sh["DreT"], sh["DimT"],
          t["plane"])
    tail = (t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"], sh["PhiDim"])
    nodes = slice(None) if tag == "fan" else slice(P // 2, P)
    loc = slice_tables(t, P, nodes, (0, 2))
    k6 = (*(v[nodes].contiguous() for v in g), loc["WtT"], loc["SEre"],
          loc["SEim"], sh["DreT"], sh["DimT"], loc["plane"], NB * nb)
    out = {f"k2_{tag}": cs._time_ms(torch, lambda: ss.skew_sum_planes_t(*k2)),
           f"k3_{tag}": cs._time_ms(torch, lambda: ss.eval_shear(*g, *tail)),
           f"k4_{tag}": cs._time_ms(torch, lambda: ss.eval_shear_t(ob, *tail)),
           f"k6_{tag}_shard": cs._time_ms(
               torch, lambda: ss.skew_sum_planes_t_rows(*k6))}
    if tag != "fan":
        blk = (loc["Wd"], loc["TEre"], loc["TEim"], sh["PhiDre"],
               sh["PhiDim"])
        gb = [v[nodes].contiguous() for v in g]
        obb = ob[nodes].contiguous()
        out[f"k3_{tag}_block"] = cs._time_ms(
            torch, lambda: ss.eval_shear(*gb, *blk))
        out[f"k4_{tag}_block"] = cs._time_ms(
            torch, lambda: ss.eval_shear_t(obb, *blk))
    return out


def _shear_ms(problem) -> dict:
    """K7 and K8 on the tables of the fft_shear ``problem`` (one image per
    node), per call in ms, and its apply pair."""
    from dip_admm_tpu_torch.ops import radon_fft
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    t = problem.fft_tables
    geo = problem.cfg.geometry
    gen = torch.Generator(device="cuda").manual_seed(0)
    P, NB, Tp, _, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    tabs = (t["Wt"], t["SEre"], t["SEim"], t["shared"]["Phire"],
            t["shared"]["Phiim"], t["plane"])
    r = [torch.randn((P, 2, NB * nb, F), generator=gen, device="cuda")
         for _ in range(2)]
    g = [torch.randn((P, Tp, F), generator=gen, device="cuda")
         for _ in range(2)]
    img = torch.randn((P, geo.N, geo.N), generator=gen, device="cuda")
    return {"k7_shear": cs._time_ms(
                torch, lambda: ss.shear_sum_planes(*r, *tabs)),
            "k8_shear": cs._time_ms(
                torch, lambda: ss.shear_sum_planes_t(*g, *tabs)),
            "shear_pair": cs._pair_ms(
                torch, radon_fft.project_nodes_shear,
                radon_fft.backproject_nodes_shear, geo, t, img)}


def _pallas_ms(problem) -> dict:
    """K11 and K12 on the tables of the 512^2/8 fft_pallas ``problem``, per
    call in ms, on the spectra and the cotangents the checkout's own
    projector makes (its layout: pitched or dense), and its apply pair."""
    from dip_admm_tpu_torch.ops import radon_fft
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs

    t = problem.fft_tables
    geo = problem.cfg.geometry
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn((problem.num_nodes, geo.N, geo.N), generator=gen,
                      device="cuda")
    r = radon_fft._plane_spectra(img, t)
    g = radon_fft._eval_tail_t(torch.randn(t["p"].shape, generator=gen,
                                           device="cuda"), t)
    tabs = (t["Hre"], t["Him"], t["sel"])
    return {"k11_p512": cs._time_ms(torch, lambda: fs.filter_sum_sel(*r,
                                                                     *tabs)),
            "k12_p512": cs._time_ms(torch, lambda: fs.filter_sum_sel_t(
                *g, *tabs)),
            "pallas_pair_p512": cs._pair_ms(
                torch, radon_fft.project_nodes_merged,
                radon_fft.backproject_nodes_merged, geo, t, img)}


def _grouped_ms(problem, t, pair) -> dict:
    """K13 and K14 on the grouped tables ``t`` of ``problem`` (the fan's
    shared set, or the parallel problem's own), per call and by device time
    in ms, on the slot spectra and cotangents the checkout's projector
    makes (its layout: pitched or dense), and the problem's apply pair."""
    from dip_admm_tpu_torch.ops import radon_fft
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs

    geo = problem.cfg.geometry
    P = problem.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(0)
    img = torch.randn((P, geo.N, geo.N), generator=gen, device="cuda")
    r = radon_fft._slot_spectra(img, t)
    g = radon_fft._slot_tail_t(torch.randn((P, *t["p"].shape[1:]),
                                           generator=gen, device="cuda"), t)
    H = (t["Hre_g"], t["Him_g"])
    TB = t["onehot"].shape[1]
    out = {}
    for name, fn in (
            ("k13", lambda: fs.filter_sum_grouped(*r, *H)),
            ("k14", lambda: fs.filter_sum_grouped_t(*g, *H, TB))):
        out[name] = cs._time_ms(torch, fn)
        out[f"{name}_device"] = cs._device_ms(torch, fn)[0]
    out["pair"] = cs._pair_ms(torch, *pair, geo, problem.fft_tables, img)
    return out


def _grouped(failures) -> None:
    """K13/K14 and the grouped runs of the fan and 512^2/8 cells."""
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon_fan, radon_fft

    dev = torch.device("cuda", 0)
    fan = loader.build_problem(cs._bench_cfg("bfloat16", fan_beam=True), dev,
                               mode="fft_grouped")
    times = _grouped_ms(fan, fan.fft_tables["shared"]["par"],
                        (radon_fan.project_nodes_fan_grouped,
                         radon_fan.backproject_nodes_fan_grouped))
    print(f"{ROOT} grouped_ms[fan]: " + " ".join(
        f"{k}={v}" for k, v in times.items()), flush=True)
    _, _, line = cs._drive(torch, fan, cs._recommended(fan.cfg.admm),
                           cs.REF_FAN_PSNR, "fan_grouped", failures,
                           cs.GROUPED)
    print(f"{ROOT} fan_grouped_recommended: {line}", flush=True)
    del fan
    torch.cuda.empty_cache()
    p512 = loader.build_problem(cs._bench_cfg("bfloat16", N=512), dev,
                                mode="fft_grouped")
    times = _grouped_ms(p512, p512.fft_tables,
                        (radon_fft.project_nodes_grouped,
                         radon_fft.backproject_nodes_grouped))
    print(f"{ROOT} grouped_ms[512^2/8]: " + " ".join(
        f"{k}={v}" for k, v in times.items()), flush=True)
    _, _, line = cs._drive(torch, p512, cs._recommended(p512.cfg.admm),
                           cs.REF_512_PSNR, "p512_grouped", failures,
                           cs.GROUPED + cs.HAT)
    print(f"{ROOT} p512_grouped_recommended: {line}", flush=True)
    del p512
    torch.cuda.empty_cache()


def _rates(failures) -> None:
    """The outer rates of the dense flagship and of the bench problem's
    parity and recommended runs, each run twice."""
    from dip_admm_tpu_torch.data import loader

    dev = torch.device("cuda", 0)
    cfg = cs._dense_cfg()
    flagship = loader.build_problem(cfg, dev)
    for rep in range(2):
        _, _, _, line = cs._dense_drive(torch, flagship, cfg.admm,
                                        "dense_flagship", failures,
                                        cs.REF_DENSE_PSNR)
        print(f"{ROOT} flagship[{rep}]: {line}", flush=True)
    del flagship
    cfg = cs._bench_cfg("bfloat16")
    problem = loader.build_problem(cfg, dev)
    for rep in range(2):
        _, _, line = cs._drive(torch, problem, cfg.admm, cs.REF_PSNR, "main",
                               failures)
        print(f"{ROOT} parity[{rep}]: {line}", flush=True)
        _, _, line = cs._drive(torch, problem, cs._recommended(cfg.admm),
                               cs.REF_REC_PSNR, "recommended", failures)
        print(f"{ROOT} recommended[{rep}]: {line}", flush=True)
    del problem
    torch.cuda.empty_cache()


def main() -> int:
    from dip_admm_tpu_torch.data import loader

    if not torch.cuda.is_available():
        print("torch_ab_rates: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list[str] = []
    cs.phase_build()
    if ONLY in ("grouped", "rates"):
        (_grouped if ONLY == "grouped" else _rates)(failures)
        print(f"{ROOT} failures={failures}", flush=True)
        return 1 if failures else 0
    dev = torch.device("cuda", 0)
    cfg = cs._bench_cfg("bfloat16")
    problem = loader.build_problem(cfg, dev)
    fan = loader.build_problem(cs._bench_cfg("bfloat16", fan_beam=True), dev)
    times = {}
    for tag, t in (("bench", problem.fft_tables),
                   ("fan", fan.fft_tables["shared"]["par"])):
        times.update(_kernel_ms(t, cfg.geometry.num_nodes, tag))
    del fan
    shear = loader.build_problem(cfg, dev, mode="fft_shear")
    times.update(_shear_ms(shear))
    print(f"{ROOT} kernel_ms: " + " ".join(
        f"{k}={v}" for k, v in times.items()), flush=True)
    _, _, line = cs._drive(torch, problem, cfg.admm, cs.REF_PSNR, "main",
                           failures)
    print(f"{ROOT} parity: {line}", flush=True)
    _, _, line = cs._drive(torch, problem, cs._recommended(cfg.admm),
                           cs.REF_REC_PSNR, "recommended", failures)
    print(f"{ROOT} recommended: {line}", flush=True)
    _, _, line = cs._drive(torch, shear, cs._recommended(cfg.admm),
                           cs.REF_REC_PSNR, "sm_shear", failures, cs.SHEAR)
    print(f"{ROOT} shear_recommended: {line}", flush=True)
    del problem, shear
    torch.cuda.empty_cache()
    cs._mesh_run(torch, "mesh_bench", False, 2, 2, cs.REF_REC_PSNR, failures)
    p512 = loader.build_problem(cs._bench_cfg("bfloat16", N=512), dev,
                                mode="fft_pallas")
    print(f"{ROOT} kernel_ms: " + " ".join(
        f"{k}={v}" for k, v in _pallas_ms(p512).items()), flush=True)
    _, _, line = cs._drive(torch, p512, cs._recommended(p512.cfg.admm),
                           cs.REF_512_PSNR, "p512_pallas", failures,
                           cs.PALLAS + cs.HAT)
    print(f"{ROOT} p512_pallas_recommended: {line}", flush=True)
    del p512
    torch.cuda.empty_cache()
    _grouped(failures)
    print(f"{ROOT} failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
