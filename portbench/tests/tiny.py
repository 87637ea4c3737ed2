"""A tiny cell on the CPU (the kernels' plain versions), for the tests:

    python portbench/tests/tiny.py <config> <mix> [--fan] [--fault NAME]
        [--trace] [--control KIND --seeds 1,2]

prints one run's result line (``portbench.run.run_cell``, the look for a
card skipped) with the process's forbidden modules under "forbidden",
read after the check and, with ``--trace``, the per-layer readers and the
kernel wrappers of ``counts/`` have been loaded; or with ``--control`` the
correctness readings of ``portbench.control``. ``--fan`` turns the
configuration's geometry into a fan beam (FAN). A fault breaks the timed
path underneath the harness (see FAULTS).

    python3 portbench/tests/tiny.py <config> <mix> --full --fault NAME \
        --seeds 1,2,3 [--seconds 2]

runs the cell at its own size on the card with the fault, one line a
seed: the numbers compared, their limits and ``correct``."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import run  # noqa: E402

N, ANGLES, OUTERS, LANES = 32, 96, 6, 4
# Limits at this size, between the program's readings (4 seeds) and the
# control's (3 seeds): float8 taps for the fft_pallas configuration
# (program 5.6e-4, 5.8e-4, 4.8e-4 against 1.9e-2, 1.9e-2, 2.6e-2), float8
# products for the fft_skew one (x_gap 6.4e-3 against 3.4e-2, z_gap 5.6e-3
# against 3.2e-2, psnr_gap 2.4e-3 against 2.2e-2, seeds 3-5); the same
# on the fan beam of --fan (15 seeds: x_gap 5.2e-3 against 2.8e-2, z_gap
# 5.1e-3 against 2.9e-2, psnr_gap 7.1e-4 against 2.9e-3).
LIMITS = {
    "par512_p8": {"control": "tables_fp8", "numbers": {
        "x_gap": {"limit": 3e-3}, "z_gap": {"limit": 3e-3},
        "psnr_gap": {"limit": 5e-3}}},
    "par256_p8": {"control": "products_fp8", "numbers": {
        "x_gap": {"limit": 1.5e-2}, "z_gap": {"limit": 1.5e-2},
        "psnr_gap": {"limit": 8e-3}}},
    "par256_p8.fan": {"control": "products_fp8", "numbers": {
        "x_gap": {"limit": 1.5e-2}, "z_gap": {"limit": 1.5e-2},
        "psnr_gap": {"limit": 1.5e-3}}},
}


# The fan beam of --fan: the source and a flat detector 4 from the centre,
# the detector wide enough that the fan covers the image's inscribed disc.
FAN = {"fan_beam": True, "det_width_factor": 2.1, "src_radius": 4.0,
       "det_radius": 4.0}


def tiny_spec(config: str, mix: str, fan: bool = False) -> dict:
    conf = json.loads((ROOT / "portbench" / "configs" / f"{config}.json")
                      .read_text())
    conf["geometry"].update(N=N, angles_total=ANGLES, det_pixels=N)
    if fan:
        conf["geometry"].update(FAN)
        config += ".fan"
    m = json.loads((ROOT / "portbench" / "mixes" / f"{mix}.json")
                   .read_text())
    m["recipe"]["max_iters"] = OUTERS
    m["scales"] = m["scales"][:LANES]
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {"cell": {"name": f"{config}.{mix}", "chips": 1}, "config": conf,
            "mix": m, "limits": LIMITS[config],
            "end_to_end": man["end_to_end"], "per_layer": man["per_layer"]}


def _unchanged_step():
    from dip_admm_tpu_torch.core import admm

    admm.admm_iteration = lambda data, cfg, state, hist, *a, **k: \
        state._replace(k=state.k + 1)
    admm._batched_iteration = lambda data, cfg, state, *a, **k: \
        state._replace(k=state.k + 1)


def _half_batch():
    from dip_admm_tpu_torch.core import admm

    orig = admm.run_admm_batched

    def half(problem, b_batch, x_true_batch=None, cfg=None, **kw):
        B = b_batch.shape[0]
        res = orig(problem, b_batch[:B // 2], x_true_batch[:B // 2], cfg,
                   **kw)

        def fill(t):
            rest = t.mean(dim=0, keepdim=True).expand(B - B // 2,
                                                      *t.shape[1:])
            return torch.cat([t, rest.to(t.dtype)])

        st = res.state._replace(Z=fill(res.state.Z), Y=fill(res.state.Y))
        return res._replace(x=fill(res.x), state=st,
                            n_iters=fill(res.n_iters.float()).long())

    admm.run_admm_batched = half


def _no_exchange():
    from dip_admm_tpu_torch.ops.kernels import consensus

    orig = consensus.consensus_update_ref

    def own(a, y, z, adjm, w=None, fusion="midpoint", **kw):
        return orig(a, y, z, adjm, w, fusion, a_t=a, w_own=w, w_all=w)

    # The plain version (the CPU's) and K5 (the card's) alike.
    consensus.consensus_update_ref = consensus.consensus_update = own


def _altered_answer():
    from dip_admm_tpu_torch.core import admm

    def rolled(res):
        x = res.x.clone()
        x[..., 0, :] = torch.roll(x[..., 0, :], 1, dims=-1)
        return res._replace(x=x)

    single, batched = admm.run_admm, admm.run_admm_batched
    admm.run_admm = lambda *a, **k: rolled(single(*a, **k))
    admm.run_admm_batched = lambda *a, **k: rolled(batched(*a, **k))


# A step that returns its state unchanged; half of the batch left out,
# each left-out lane the mean of the others; the exchange between nodes
# left out (each edge's z from its own side only); node 0's image moved
# by one pixel where it is produced.
FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "no_exchange": _no_exchange, "altered_answer": _altered_answer}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("mix")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--control")
    ap.add_argument("--seeds", default="1,2")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--fan", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    if args.full:
        return full(args)
    torch.set_num_threads(2)
    spec = tiny_spec(args.config, args.mix, args.fan)
    dev = torch.device("cpu")
    if args.control:
        from portbench import control

        seeds = [int(s) for s in args.seeds.split(",")]
        out = control.readings(spec, seeds, seeds, dev, args.control,
                               log=lambda line: None)
        print(json.dumps({"lower": out["lower"], "upper": out["upper"]}))
        return 0
    if args.fault:
        FAULTS[args.fault]()
    out = run.run_cell(spec, 2**31 + 7, 0.5, args.trace, dev,
                       log=lambda line: print(line, file=sys.stderr))
    if args.trace:
        run.kernel_wrappers()
    out["forbidden"] = run.forbidden_modules()
    print(json.dumps(out))
    return 0


def full(args) -> int:
    """The cell at its own size on the card, with the fault, a run a
    seed."""
    from portbench import spec

    if args.fault:
        FAULTS[args.fault]()
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.cell(f"{args.config}.{args.mix}")
    dev = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        out = run.run_cell(cell, seed, args.seconds, False, dev,
                           log=lambda line: None)
        print(json.dumps({"fault": args.fault, "seed": seed,
                          "correct": out["correct"],
                          "numbers": out["notes"]["numbers"],
                          "checked": out["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
