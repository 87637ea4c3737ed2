#!/usr/bin/env python3
"""Mode ``fft``'s fan apply pair at the fan bench size on one GPU, for
comparing two checkouts in one call on one card.

    python3 scripts/torch_fan_fft_pair.py ROOT

builds, from the checkout at ROOT (its own ``chip_smoke.py`` and
package), the fan bench problem (Shepp-Logan 256², 8 nodes, 768 fan
angles, f32 tables) on mode ``fft``, and prints one line: the build
seconds and peak GiB, the tables' GiB, the apply pair's ms (project, then
backproject; the median of ``chip_smoke.TIMED_RUNS`` CUDA events after 3
warm-ups, on seeded images), the pair's peak GiB beyond the problem, and
a checksum of the pair's output. No kernel runs. Alternate the
checkouts, e.g. with the parent unpacked by ``git archive`` into
``build/parent``:

    for r in build/parent . . build/parent; do
        python3 scripts/torch_fan_fft_pair.py $PWD/$r; done
"""

import os
import sys

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.getcwd()
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    dev = torch.device("cuda", 0)
    cfg = cs._bench_cfg("float32", fan_beam=True)
    problem, build_s, build_peak = cs._build_timed(torch, cfg, dev,
                                                   mode="fft")
    gen = torch.Generator(device=dev).manual_seed(35)
    x = torch.randn((problem.num_nodes, problem.n), generator=gen,
                    device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = problem.adjoint(problem.forward(x))
    torch.cuda.synchronize()
    pair_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    pair_ms = cs._time_ms(torch, lambda: problem.adjoint(problem.forward(x)))
    print(f"fan_fft_pair: root={ROOT} build_s={build_s} "
          f"build_peak_gib={build_peak} "
          f"table_gib={cs._table_gib(problem.fft_tables)} pair_ms={pair_ms} "
          f"pair_peak_gib={pair_peak} "
          f"out_sum={float(out.double().sum())}", flush=True)


if __name__ == "__main__":
    main()
