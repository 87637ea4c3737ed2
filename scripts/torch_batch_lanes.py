#!/usr/bin/env python3
"""Where a scenario batch's lanes part from their single runs, on one GPU.

    python3 scripts/torch_batch_lanes.py

On the smoke's batched_64 problem (64^2/5 dense, 64 ``rand_im`` phantoms,
cv at <= 100 inner, 20 outers, K5 on): the dense product of the 64 lanes
against each lane's own (bit for bit or not, and the largest relative
difference), then lanes 0-3 of three batched runs against ``run_admm`` on
each lane alone: the batch of 64 as the port runs it, the same batch with
the dense product taken lane by lane (each a [P, n, 1] product, as a
single run takes it), and a batch of the four lanes alone. Per lane: the
state's relative difference (x, Z, Y by norm), the first outers whose
inner counts differ and the PSNR difference in dB. Prints the card's name
and power limit first.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from dip_admm_tpu_torch.core import admm  # noqa: E402
from dip_admm_tpu_torch.data import loader  # noqa: E402
from dip_admm_tpu_torch.ops import phantoms, radon  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_batch_lanes: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    base = cs._dense_cfg()
    cfg = cs._dense_cfg(max_iters=20, eps_pri=0.0, eps_dual=0.0,
                        use_pallas=True, node=dataclasses.replace(
                            base.admm.node, max_inner=100))
    problem = loader.build_problem(cfg, dev)
    P, N, n, B = problem.num_nodes, problem.N, problem.n, cs.BATCH_64
    xs = np.stack([phantoms.rand_im(N, seed=s).astype(np.float32)
                   .reshape(-1) for s in range(B)])
    X = torch.as_tensor(xs, device=dev)
    clean = problem.forward(X[:, None, :].expand(B, P, n).reshape(B * P, n))
    clean = clean.reshape(B, P, -1)
    rows = problem.angle_valid.repeat_interleave(N, dim=1).to(torch.float32)
    noise = torch.as_tensor(np.stack([
        cs.batch_noise(s, tuple(clean.shape[1:])) for s in range(B)]),
        device=dev)
    b = clean + (cfg.noise_level * noise) * rows

    A = problem.fft_tables["A"]
    v = torch.randn((B, P, n), device=dev)
    got = radon._batch_bmm(A, v.reshape(B * P, n)).reshape(B, P, -1)
    one = torch.stack([radon._batch_bmm(A, v[s]) for s in range(4)])
    print(f"product: lanes_bitwise="
          f"{[bool(torch.equal(got[s], one[s])) for s in range(4)]} "
          f"max_rel={float((got[:4] - one).abs().max() / one.abs().max())}",
          flush=True)

    singles = [admm.run_admm(dataclasses.replace(problem, b=b[s],
                                                 x_true=X[s]), cfg.admm)
               for s in range(4)]

    def report(tag, res):
        for s in range(4):
            hb = res.history["inner_iters"][s].cpu().numpy()
            hs = singles[s].history["inner_iters"].cpu().numpy()
            first = [k for k in range(hs.shape[0])
                     if not np.array_equal(hb[k], hs[k])][:3]
            d = (cs._mean_psnr(res.x[s].cpu().numpy(), xs[s])
                 - cs._mean_psnr(singles[s].x.cpu().numpy(), xs[s]))
            print(f"{tag}: lane {s} state_rel="
                  f"{cs._lane_rel(torch, res, s, singles[s])} "
                  f"inner_counts_first_differ_at_outers={first} "
                  f"psnr_minus_single_db={d}", flush=True)

    report("batch_64", admm.run_admm_batched(problem, b, X, cfg.admm))
    batched = radon._batch_bmm

    def lane_by_lane(Am, x):
        Pn = Am.shape[0]
        return torch.cat([batched(Am, x[k * Pn:(k + 1) * Pn])
                          for k in range(x.shape[0] // Pn)])

    radon._batch_bmm = lane_by_lane
    try:
        report("batch_64_product_by_lane",
               admm.run_admm_batched(problem, b, X, cfg.admm))
    finally:
        radon._batch_bmm = batched
    report("batch_4", admm.run_admm_batched(problem, b[:4], X[:4], cfg.admm))


if __name__ == "__main__":
    main()
