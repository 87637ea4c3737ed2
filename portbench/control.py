"""The readings that a cell's correctness limits are set from, in one
process: for each seed, the gaps (``check.NUMBERS``) of the program's
first window reconstruction from the plain reference's, and for each
control seed the gaps of the control, the reference put in the program's
place one precision step below what the configuration states:

- ``tables_fp8``: every interpolation tap rounded to float8 (e4m3), the
  step below the bfloat16 tables, where the program multiplies them with
  float32 operands (``fft_pallas``'s filter sums);
- ``products_fp8``: the taps and each product's operand (an image or
  measurement row, scaled to e4m3's range) rounded to float8 e4m3 and
  accumulated in float32, the step below products on bfloat16 tensor
  cores (``fft_skew``'s tables and DFT matrices with bfloat16 operands);
- ``state_bf16``: the sinograms and every iterate (images, TV duals, Z,
  Y) kept in bfloat16, the step below the float32 problem dtype.

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--control tables_fp8|products_fp8|state_bf16]

The control defaults to the one the cell's limits name.

Prints one JSON line a seed and a summary line: the program's largest
reading of each number (the lower) and the control's smallest (the
upper). Runs on the card only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from portbench import check, inputs, program, spec


def _ints(s: str) -> list:
    return [int(v) for v in s.split(",") if v]


CONTROLS = {"tables_fp8": {"tap_dtype": torch.float8_e4m3fn},
            "products_fp8": {"tap_dtype": torch.float8_e4m3fn,
                             "operand_dtype": torch.float8_e4m3fn},
            "state_bf16": {"state_dtype": torch.bfloat16}}


def readings(cell: dict, seeds: list, control_seeds: list, device,
             control: str, log=print) -> dict:
    from dip_admm_tpu_torch.data import loader

    conf, mix = cell["config"], cell["mix"]
    program.load_kernels(conf["libraries"] if device.type == "cuda" else [])
    prog = program.Program(conf, mix, seeds[0] if seeds else 0, device)
    base = prog.problem
    out = {"program": {}, "control": {}}
    got = {}
    for s in seeds:
        prog.seed = s
        prog.lanczos_v0 = inputs.normal((prog.n,), s, inputs.LANCZOS_V0,
                                        device=device)
        v0 = inputs.normal((prog.P, prog.n), s, inputs.OPNORM_V0,
                           device=device)
        prog.problem = dataclasses.replace(
            base, opnorm=loader.estimate_opnorms(
                base.forward, base.adjoint, prog.P, prog.n, device, v0=v0))
        res = prog.reconstruct(1)
        got[s] = {"r": 1, "x": res["x"].cpu(), "Z": res["Z"].cpu()}
        del res
    del prog, base
    torch.cuda.empty_cache() if device.type == "cuda" else None
    proj = check.projector(conf, device)
    kind = CONTROLS[control]
    ctrl = check.projector(conf, device, kind.get("tap_dtype"),
                           kind.get("operand_dtype")) \
        if "tap_dtype" in kind and control_seeds else proj
    for s in sorted(set(seeds) | set(control_seeds)):
        for lane in range(len(mix["scales"])):
            x_ref, Z_ref = check.reference_run(proj, conf, mix, s, 1, lane)
            tru = check.truth(conf, mix, lane, device)
            if s in got:
                g = check.gaps(got[s]["x"][lane].to(device),
                               got[s]["Z"][lane].to(device), x_ref, Z_ref,
                               *tru)
                _worst(out["program"], s, g)
            if s in control_seeds:
                x_c, Z_c = check.reference_run(
                    ctrl, conf, mix, s, 1, lane, kind.get("state_dtype"))
                _worst(out["control"], s,
                       check.gaps(x_c, Z_c, x_ref, Z_ref, *tru))
        for side in ("program", "control"):
            if s in out[side]:
                log(json.dumps({"seed": s, "side": side, **out[side][s]}))
    out["lower"] = {k: max(v[k] for v in out["program"].values())
                    for k in check.NUMBERS} if seeds else None
    out["upper"] = {k: min(v[k] for v in out["control"].values())
                    for k in check.NUMBERS} if control_seeds else None
    return out


def _worst(side: dict, seed: int, g: dict) -> None:
    cur = side.setdefault(seed, {k: 0.0 for k in g})
    for k, v in g.items():
        cur[k] = max(cur[k], v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--control", choices=sorted(CONTROLS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.cell(args.workload)
    control = args.control or cell["limits"]["control"]
    out = readings(cell, args.seeds, args.control_seeds,
                   torch.device("cuda", 0), control)
    print(json.dumps({"workload": args.workload, "control": control,
                      "lower": out["lower"], "upper": out["upper"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
