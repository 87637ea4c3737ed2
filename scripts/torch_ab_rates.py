#!/usr/bin/env python3
"""Recommended and mesh_bench outer rates of the PyTorch port on one GPU,
for comparing two checkouts in one call on one card.

    python3 scripts/torch_ab_rates.py ROOT

runs, from the checkout at ROOT (its own ``chip_smoke.py`` and kernels):
the build, 20 recommended outers of the 256^2/8 bench problem on one
device, and 20 on a 2 x 2 node x pixel mesh of four processes sharing the
card (``chip_smoke.py``'s phases 6 and 6b without their reference checks),
and prints both lines. Alternate the checkouts, e.g. with the parent
unpacked by ``git archive`` into ``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_ab_rates.py $PWD/$r; done
"""

import os
import sys

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.getcwd()
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    from dip_admm_tpu_torch.data import loader

    if not torch.cuda.is_available():
        print("torch_ab_rates: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures: list[str] = []
    cs.phase_build()
    cfg = cs._bench_cfg("bfloat16")
    problem = loader.build_problem(cfg, torch.device("cuda", 0))
    _, _, line = cs._drive(torch, problem, cs._recommended(cfg.admm),
                           cs.REF_REC_PSNR, "recommended", failures)
    print(f"{ROOT} recommended: {line}", flush=True)
    del problem
    torch.cuda.empty_cache()
    cs._mesh_run(torch, "mesh_bench", False, 2, 2, cs.REF_REC_PSNR, failures)
    print(f"{ROOT} failures={failures}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
