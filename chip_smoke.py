#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dip_admm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers (the kernels phases one a
kernel):

1. build       - compiles every ``dip_admm_tpu_torch/csrc/*.cu`` with nvcc
                 (sm_90a), all at once, and prints each one's nvcc seconds
                 (or ``cached``).
2. problem     - builds the bench problem once with the port's loader on the
                 card (Shepp-Logan 256^2, 8 nodes, 768 angles, knn k=2, bf16
                 tables); the main and recommended phases share it.
3. kernels     - at the 256^2/8 bench shapes, with the problem's bf16
                 tables and seeded inputs on the card, runs each of the four
                 projector kernels (error <= 2e-3 of the output's max), K1
                 and K6 as the ranks of the 2 x 2 mesh run them (node block
                 1 of 2, each row shard of the 2-wide pixel axis: K1 on the
                 shard's rows, K6 at the full row width; two calls bitwise
                 equal; the shards' K1 outputs summed hold to K1 on all
                 rows, their K6 outputs concatenated equal K2's bit for
                 bit), and the consensus kernel K5 at [8, 8,
                 65536] with the problem's union graph and weights, both
                 fusions, and its sharded form at one rank's block of the
                 2 x 2 mesh ([4, 8, 32768], explicit a_t; its z and y equal
                 the single-device kernel's on the block) (error <= 1e-5 of
                 the output's max, two calls bitwise equal, one device
                 launch a call, the clusters the card holds at once), each
                 against its plain PyTorch version, and times both (median
                 of 20 runs after warm-up, CUDA events); K5 also by its
                 host's cost a call (200 calls with no sync between them)
                 and its device time. K1 and K2, here and at
                 the fan shapes (phase 8), and K1 and K6 on each row shard,
                 also run twice bitwise equal, and each prints its device
                 time by launch (``torch.profiler``), its device launches a
                 call and the share of its taps and tensor-core tap tiles
                 that hold a nonzero. K3 and K4, here, at the fan shapes
                 and on node block 1 of 2 with its tables (a 2 x 2 mesh
                 rank's P_loc = 4, where each must also equal the whole
                 batch's rows bit for bit), run twice bitwise equal and
                 print their device time by launch and launches a call.
4. adjoint     - <Ax, y> = <x, A^T y> through the kernels with f32 tables at
                 256^2/8, relative error <= 1e-5.
5. main        - 20 outers of the <=200-inner Condat-Vu parity contract
                 through ``run_admm`` (fused consensus on by the auto rule):
                 K1-K4 must launch, K5 exactly once per outer, the residuals
                 must be finite and the mean PSNR within 0.5 dB of the JAX
                 package's 30.51 dB.
6. recommended - 20 outers of the recommended operating point (fcv, 15
                 inner checked once, over-relaxation 1.8) through
                 ``run_admm``: the same launch checks, finite residuals, and
                 a mean PSNR within 0.5 dB of the JAX package's 34.19 dB. It
                 prints the preconditioner's build seconds (the process's
                 first FFT and eigvalsh included, then warm), each node's
                 certified step and final step, and the step halvings of the
                 divergence monitor.
6b. mesh_bench - the recommended run on a 2 x 2 node x pixel mesh of four
                 processes sharing the card, over gloo with the collectives'
                 payloads staged through host memory
                 (``parallel/admm_sharded.py``): each rank builds the bench
                 problem, zeroes its counts, runs 20 outers (row-sharded
                 fft_skew: K1 and K6 must launch on every rank, K2 must not,
                 K5's sharded form once per outer) and reads its counts;
                 mean PSNR within 0.5 dB of 34.19 dB and within 0.05 dB of
                 phase 6's, the state (x, Z, Y) after 3 outers within 1e-3
                 (relative norm) of the single-device run's with fcv's
                 preconditioner built per node block, as each node shard
                 builds it. It prints the outer rate, the transport, each
                 rank's collectives and their share of its run time, and how
                 far the per-block build moves the certified steps and the
                 3-outer state from the build over every node.
6c. mesh_fan   - the fan bench problem on a 1 x 2 pixel mesh (two processes),
                 20 recommended outers, the same launch checks, mean PSNR
                 within 0.5 dB of 12.66 dB.
7. fan_problem - builds the fan-beam bench problem (Shepp-Logan 256^2, 8
                 nodes, 768 fan angles over [0, 2 pi), 96 per node, rebinned
                 to 48 parallel angles; knn k=2, bf16 tables) twice, for
                 ``fft_skew`` and ``fft_grouped``, and prints each build's
                 seconds and the exact fan column norms' seconds.
8. fan_kernels - at the fan shapes (8 node images against one shared table
                 set, PT = 1), K1-K4 against their plain versions (error <=
                 2e-3 of the output's max), K1 and K6 on each row shard as
                 the 1 x 2 fan mesh runs them (the checks of phase 3), and
                 the grouped filter-sum K13/K14 with bf16 H on the
                 problem's pitched tables and pitched slot spectra and
                 cotangents (error <= 2e-3 of the output's max, two calls
                 bitwise equal, a node slice of the images equal to the
                 whole batch's rows bit for bit), timed as in phase 3 and
                 by their device time per recorded launch (as K11/K12 in
                 phase 12), with the images a thread takes; and both fan
                 apply pairs.
9. fan_adjoint - <Ax, y> = <x, A^T y> with f32 tables through fan
                 ``fft_skew``, fan ``fft_grouped`` and parallel
                 ``fft_grouped`` at 256^2/8 (PT = PB = 8), relative error
                 <= 1e-5 each.
10. fan_skew, fan_grouped - 20 outers of the recommended preset on each fan
                 problem through ``run_admm``: K1-K4 must launch on the skew
                 run, K13/K14 on the grouped run, K5 exactly once per outer
                 on both; finite residuals and a mean PSNR within 0.5 dB of
                 the JAX package's 12.66 dB.
11. p512_problem - builds the 512^2/8 parallel problem (Shepp-Logan, 1536
                 angles, 192 per node, knn k=2, bf16 tables) twice, for
                 ``fft_pallas`` and ``fft_grouped``, and prints each build's
                 seconds and table GiB.
12. p512_kernels - at the 512^2/8 shapes, the select filter-sum K11/K12
                 with bf16 H on the problem's pitched tables and pitched
                 spectra and cotangents (error <= 2e-3 of the output's
                 max) and the hat kernels K17/K18 (error <= 1e-5), each
                 against its plain version, two calls bitwise equal, and
                 with one NaN detector coordinate NaN exactly where the
                 plain version is (K17: that detector, K18: every v of its
                 rows, as the JAX kernels give) and bit-equal elsewhere to
                 their output on the finite coordinates, timed
                 as in phase 3 and by their device time alone (K17/K18
                 also by their host's cost a call, as K5; K11/K12:
                 per launch the profile recorded, with the launches made
                 and recorded a call and their GB/s against the bound)
                 beside their library calls'; K13/K14 as in phase 8 on the
                 ``fft_grouped`` problem's tables; both 512^2 apply pairs;
                 K11/K12 the same way on the 256^2/8 ``fft_pallas`` tables;
                 the ``fft_pallas`` and ``fft_grouped`` operators on a node
                 slice of the 256^2/8 tables (``mesh.slice_tables``)
                 against the whole batch's (1e-5); ``--mesh 2 --mode
                 fft_grouped`` through the CLI at 128^2, 4 nodes, 3 outers,
                 beside the same run on one device (mean PSNR within 0.05
                 dB); and the 256^2/8 ``fft_pallas`` pair with its tail
                 materialized and through K17/K18.
13. p512_adjoint - <Ax, y> = <x, A^T y> with f32 tables through
                 ``fft_pallas`` at 256^2/8 (materialized tail) and 512^2/8
                 (K17/K18), and ``fft_grouped`` at 512^2/8, relative error
                 <= 1e-5 each.
14. p512_pallas, p512_grouped - 20 outers of the recommended preset on each
                 512^2 problem through ``run_admm``: K11/K12 and K17/K18
                 must launch on the pallas run, K13/K14 and K17/K18 on the
                 grouped run, K5 exactly once per outer on both; finite
                 residuals and a mean PSNR within 0.5 dB of the JAX
                 package's 39.7 dB. Each prints its preconditioner's build
                 seconds.
15. sm_problem - builds the 256^2/8 bench problem (bf16 tables) twice, for
                 ``fft_shear`` and ``fft_mxu``, and prints each build's
                 seconds and table GiB.
16. sm_kernels - at those shapes, with the problems' bf16 tables, the shear
                 kernels K7/K8 and the tiled filter-sums K15/K16 against
                 their plain versions (error <= 2e-3 of the output's max,
                 two calls bitwise equal), timed as in phase 3, K7/K8 also
                 by their device time by launch, with their device
                 launches a call and the share of their taps and tap tiles
                 that hold a nonzero; both apply pairs at 256^2/8, and
                 both at 512^2/8 from their tables alone, with K3, K4, K7
                 and K8 on the 512^2 shear tables (four row and detector
                 blocks) against their plain versions, bitwise on a second
                 call, with their device time by launch.
17. sm_adjoint - <Ax, y> = <x, A^T y> with f32 tables through ``fft_shear``
                 and ``fft_mxu`` at 256^2/8, relative error <= 1e-5 each.
18. sm_shear, sm_mxu - 20 outers of the recommended preset on each problem
                 through ``run_admm``: K7, K8, K3 and K4 must launch on the
                 shear run and K1/K2 must not, K15/K16 must launch on the
                 mxu run, K5 exactly once per outer on both; finite
                 residuals and a mean PSNR within 0.5 dB of 34.19 dB. Each
                 prints its preconditioner's build seconds, as phase 14
                 does.
19. stages     - the stages of the JAX package's
                 ``scripts/bench_shear_stages.py`` at 256^2/8 with bf16
                 tables: the fft_shear pipeline on slot spectra gathered
                 one-hot (plane spectra, select, K9, eval tail K3, K4, K10),
                 run once with the counts zeroed (the path of K9/K10), then
                 K9/K10 against their plain versions (two calls bitwise
                 equal), K9 against K7 on the gathered spectra (bit for bit)
                 and K10 summed back over the one-hot against K8 (2e-3), and
                 each stage's time, the skew row stages K1, K2 and K6 (two
                 shards) and both full pairs included.
20. dense_flagship - the reference flagship with the package defaults
                 (64^2, 5 nodes, const phantom, cv at <= 200 inner, 200
                 outers with the 1e-3 stop): ``mode=None`` must resolve to
                 ``dense``; build seconds, A's GiB, the dense apply pair
                 against its bound (A's bytes twice over 3.35 TB/s), the
                 outer rate, mean inner iterations, the outer it stopped
                 at and a mean PSNR within 0.5 dB of the JAX package's on
                 the CPU (``scripts/jax_dense_anchors.py``).
21. inner_solvers - on that problem, 20 outers at max_inner 50 under each
                 of cv, pcv, ppdhg and fista, each within 0.5 dB of JAX's.
22. dense_joseph - 64^2/5, parallel and fan: the dense and Joseph builds'
                 b, W and opnorm, and both applies on seeded inputs, within
                 1e-5 of the max; the adjoint identity of each within 1e-5;
                 Joseph's adjoint and column norms equal bit for bit on a
                 second call; three outers on each mode within 1e-3.
23. dense_128  - 128^2/5 Shepp-Logan (the top of the auto rule): the dense
                 build (seconds, A's GiB, peak memory) and pair against its
                 bound, Joseph's build and pair, and 20 recommended outers on
                 each, their PSNRs within 0.05 dB of each other.
24. adapt_rho  - 64^2/8 dense (K5 on): 20 recommended outers under
                 ``--rho 20 --adapt-rho --rho-mu 2`` and ``--rho 2
                 --adapt-rho --rho-mode stall --rho-stall-window 5``, each
                 rho trajectory beside JAX's and a PSNR within 0.5 dB of it.
25. cli_default - the CLI on its defaults with ``--max-iters 5`` (auto =
                 dense at 64^2/5) beside ``--mesh 5`` (five gloo ranks on
                 the card, a node each): PSNRs within 0.05 dB.
                 Every dense run must launch no projector kernel, and K5
                 exactly once an outer where its auto rule puts it on.
26. strategies - the flagship of phase 20 under the mst, chain (JAX's node
                 orders, ``scripts/chain_orders_64x5_seed123.npy``) and
                 complete per-pixel graphs (``loader.rebuild_graph``), each
                 mean PSNR within 0.5 dB of the JAX package's on the CPU
                 (``scripts/jax_dense_anchors.py strategies``), and chain
                 with the port's own draws (printed, no anchor). Each
                 graph built on the card must equal the expected one: the
                 path along JAX's orders (numpy) for chain, the CPU build
                 from the same W for the others.
27. strategies_256 - the bench problem (256^2/8, fft_skew, bf16 tables)
                 under mst, chain (the port's draws) and complete: K5
                 against its plain version on each graph's adjacency, the
                 edge state zero off each pixel's mask (error <= 1e-5), and
                 20 recommended outers (K1-K4 launch, K5 once an outer); PSNR,
                 residuals and union edges printed.
28. experiment_cli - ``python -m dip_admm_tpu_torch.runners.cli --device
                 cuda --all-strategies --max-iters 20 --out DIR`` on the
                 flagship defaults: mst, chain and knn printed, each
                 ``out_dir`` holding the JAX package's artifact files
                 (``artifact_names``) less the plots it names as skipped
                 (no matplotlib on the host).
29. checkpoint_resume - on the bench problem, 20 recommended outers
                 unsegmented, through ``run_one_strategy`` in segments of 5
                 with a checkpoint after each, and 10 outers then a resume
                 from their checkpoint: both final states within 1e-6 of
                 the unsegmented run's norm (the largest difference and
                 whether they are bit-equal printed, with the checkpoint
                 writer); snapshots every 5 outers (iter_0005-iter_0020).
30. bundle     - ``save_problem`` then ``load_problem`` of the bench
                 problem: three recommended outers on the loaded problem
                 equal three on the original bit for bit.
                 Each of phases 26-34 prints its seconds (``phase_s``).
31. batched_64 - BASELINE config 4: 64 phantoms ``rand_im(64, seed=s)``
                 in one ``run_admm_batched`` at 64^2/5 (auto = dense), each
                 sinogram the problem's forward of its phantom plus the
                 numpy noise of ``batch_noise``; cv at <= 100 inner, 20
                 outers, no early stop, K5 on (batched, P = 5, once an
                 outer). Lanes 0-3 bit-equal to a batch of those four
                 alone, within 6e-3 (relative state) and 0.01 dB of the
                 port's single run of each (cuBLAS rounds a 64-column
                 product apart from a one-column one), their mean PSNR
                 within 0.5 dB of JAX's ``run_admm_batched`` on the CPU;
                 the batch run again with the dense product taken lane by
                 lane bit-equal to the single runs (state, inner counts,
                 acceptance codes); the batch's phantom-iterations/s
                 beside the single runs'.
32. batched_256 - the bench problem (256^2/8, bf16 fft_skew, recommended,
                 20 outers) as a batch of four (b, 1.05 b, 1.1 b, 1.15 b):
                 batched K5 at [4, 8, 8, 65536] against its plain version,
                 each lane and B = 1 bit-equal to the unbatched call, one
                 device launch a call; each lane within 0.01 dB of its own
                 single run, lane 0 within 0.5 dB of 34.19 dB; K1-K5
                 launches and the phantom-iterations/s beside the single
                 runs'.
33. solvers    - the flagship problem (64^2/5, dense): centralized ridge
                 by Cholesky and by CG on ``joseph`` (at lam 1e-2 they
                 agree within the JAX package's own test tolerance, as
                 there), centralized TV under cv
                 and fcv, pdhg-consensus at the reference defaults under
                 both anchor weightings, and a SnapVX-shaped dense
                 GraphProblem (nodes A_i, b_i, diag W_i; the union edges
                 with Q_ij; 50 outers): each PSNR within 0.5 dB of the JAX
                 package's on the CPU (``scripts/jax_dense_anchors.py
                 solvers``; the fcv runs with JAX's Lanczos start).
34. solvers_large - BASELINE config 1, centralized TV under fcv on a 128^2
                 Shepp-Logan (auto = dense), within 0.5 dB of JAX's CPU
                 value on Joseph (RESULTS.md's 38.1 dB from earlier JAX code
                 on a TPU printed beside it); then on the bench problem
                 centralized TV, 20 pdhg-consensus outers and a matrix-free
                 GraphProblem with TV (5 outers, fcv): finite, the
                 GraphProblem's primal residual falling, K1-K4 launching;
                 seconds and K1-K4 launches printed.
35. matrix_free - the bench problem on mode fft (the split-table
                 projector of torch FFTs and products, no kernel) with f32
                 tables: build s, table GiB, the adjoint identity, the
                 apply pair (CUDA events) beside the tables' bytes both
                 ways over the memory rate, the bf16-table pair within
                 2e-3 of the f32 pair's max, 20 recommended outers (K5
                 once an outer, no projector kernel; PSNR within 0.5 dB of
                 34.19: mode fft is fft_skew's operator), and the 64^2/4
                 run of ``scripts/jax_dense_anchors.py matrix_free``
                 within 0.5 dB of JAX's CPU value.
36. multihost  - two processes started with an environment rendezvous on
                 127.0.0.1 (``_multihost_rank``: ``multihost.initialize``,
                 ``global_mesh``, ``distribute_problem`` of the mode-fft
                 problem, 3 cv outers through ``run_admm_sharded``, K5's
                 sharded form once an outer on each): x, Z, Y within 1e-3
                 (relative norm) of the single-device run.
37. matrix_free_fan - phase 35 on the fan bench problem (12.66 dB) and
                 the 64^2/4 fan anchor run.
38. fold_eval  - 256^2/8 fft_grouped (bf16) with ``fold_eval``'s WC
                 tables: WC GiB and build s, both pairs in one call, the
                 folded pair within 1e-2 of the unfolded pair's max (K13
                 and K14 once each, no hat kernel), the adjoint identity
                 with f32 WC tables, 20 recommended outers (K13/K14, K5;
                 PSNR within 0.5 dB of 34.19).
39. mesh_segments - two gloo ranks on the card, the bench problem through
                 ``run_one_strategy`` on a 2-node mesh: 6 recommended
                 outers checkpointed every 2, the same cut at 4 and
                 resumed from that checkpoint (within 1e-6 of the unbroken
                 run, rank 0's checkpoints of the gathered state), and
                 snapshots every 2 under the JAX package's file names.
40. dtype      - 64^2/5 dense, 5 outers, under the problem dtypes
                 bfloat16 and float64: each field's and the state's dtype
                 the JAX package's, results finite, PSNR printed.
41. native_graphs - the native graph builder (``graph/native.py``) on
                 the host at n = 65536 (the mode-fft bench problem's
                 column norms), knn k = 2 and mst: masks equal to the torch
                 build's on the card; seconds of each.
                 Phases 35-41 print their seconds (``phase_s``).

Every kernel line gives the kernel's time, its plain version's, its bound
(the larger of its bytes over 3.35 TB/s and its FLOPs over 67 TFLOP/s f32
or 989 TFLOP/s bf16, counted from this call's inputs) and, where one
PyTorch call computes the same function, that call's time
(``library_ms``). The launch counters are set to 0 just before each of the
ten runs (on each rank of the mesh runs), before the stage path and before
each run of the dense phases and of phases 26, 27, 29-36 and 38-40 (on
each rank of phases 36 and 39), and read just after. Then a JSON line with each kernel's route, source,
launches in those runs together (a kernel that launched in none fails the
run), error, times and bound (K1-K5, K7-K10, K15 and K16 at the parallel
256^2 shapes (K5's batched form at [4, 8, 8, 65536] in its error), K6
and K5's sharded form at a 2 x 2 mesh rank's,
K13/K14 at the fan shapes, K11/K12/K17/K18 at the 512^2 shapes; the largest
error of any call, row shards, node blocks, fan and 512^2 shapes
included, K5 on the graphs of phase 27 too); the ``nvidia-smi``
name/power-limit line; and last ``{"ok": true, "device": {...}}``. Without
a CUDA device, or when any phase fails, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REF_PSNR = 30.51  # JAX package, 20 outers of the cv parity contract, 256^2/8
REF_REC_PSNR = 34.19  # JAX package, 20 outers of the recommended preset
# JAX package, fan 256^2/8, 20 outers of the recommended preset
# (RESULTS.md, scripts/bench_budget12_regimes.py).
REF_FAN_PSNR = 12.66
# JAX package, parallel 512^2/8, 20 outers of the recommended preset
# (RESULTS.md:51-52).
REF_512_PSNR = 39.7
PSNR_TOL = 0.5
KERNEL_RTOL = 2e-3
K5_RTOL = 1e-5
ADJOINT_TOL = 1e-5
NODE_SLICE_RTOL = 1e-5  # an operator on a node slice vs on the whole batch
TIMED_RUNS = 20
HAT_RTOL = 1e-5
LIBRARIES = ("shear_sum", "consensus", "filter_sum", "hat_eval", "filter_mxu")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
F32_FLOPS = 67e12  # off the tensor cores
BF16_FLOPS = 989e12  # dense, on the tensor cores
SOURCE = {
    "skew_sum_planes": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "skew_sum_planes_t": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "eval_shear": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "eval_shear_t": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "consensus_update": "dip_admm_tpu_torch/csrc/consensus.cu",
    "filter_sum_grouped": "dip_admm_tpu_torch/csrc/filter_sum.cu",
    "filter_sum_grouped_t": "dip_admm_tpu_torch/csrc/filter_sum.cu",
    "filter_sum_sel": "dip_admm_tpu_torch/csrc/filter_sum.cu",
    "filter_sum_sel_t": "dip_admm_tpu_torch/csrc/filter_sum.cu",
    "hat_eval": "dip_admm_tpu_torch/csrc/hat_eval.cu",
    "hat_eval_t": "dip_admm_tpu_torch/csrc/hat_eval.cu",
    "shear_sum_planes": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "shear_sum_planes_t": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "filter_sum_mxu": "dip_admm_tpu_torch/csrc/filter_mxu.cu",
    "filter_sum_mxu_t": "dip_admm_tpu_torch/csrc/filter_mxu.cu",
    "skew_sum_planes_t_rows": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "consensus_update_sharded": "dip_admm_tpu_torch/csrc/consensus.cu",
    "shear_sum": "dip_admm_tpu_torch/csrc/shear_sum.cu",
    "shear_sum_t": "dip_admm_tpu_torch/csrc/shear_sum.cu",
}
REPLACES = {
    "skew_sum_planes": "dip_admm_tpu/ops/pallas/shear_sum.py:983",
    "skew_sum_planes_t": "dip_admm_tpu/ops/pallas/shear_sum.py:1002",
    "eval_shear": "dip_admm_tpu/ops/pallas/shear_sum.py:490",
    "eval_shear_t": "dip_admm_tpu/ops/pallas/shear_sum.py:511",
    "consensus_update": "dip_admm_tpu/ops/pallas/consensus.py:107",
    "filter_sum_grouped": "dip_admm_tpu/ops/pallas/filter_sum.py:410",
    "filter_sum_grouped_t": "dip_admm_tpu/ops/pallas/filter_sum.py:434",
    "filter_sum_sel": "dip_admm_tpu/ops/pallas/filter_sum.py:373",
    "filter_sum_sel_t": "dip_admm_tpu/ops/pallas/filter_sum.py:394",
    "hat_eval": "dip_admm_tpu/ops/pallas/hat_eval.py:147",
    "hat_eval_t": "dip_admm_tpu/ops/pallas/hat_eval.py:166",
    "shear_sum_planes": "dip_admm_tpu/ops/pallas/shear_sum.py:685",
    "shear_sum_planes_t": "dip_admm_tpu/ops/pallas/shear_sum.py:703",
    "filter_sum_mxu": "dip_admm_tpu/ops/pallas/filter_mxu.py:314",
    "filter_sum_mxu_t": "dip_admm_tpu/ops/pallas/filter_mxu.py:341",
    "skew_sum_planes_t_rows": "dip_admm_tpu/ops/pallas/shear_sum.py:1014",
    "consensus_update_sharded": "dip_admm_tpu/ops/pallas/consensus.py:107",
    "shear_sum": "dip_admm_tpu/ops/pallas/shear_sum.py:235",
    "shear_sum_t": "dip_admm_tpu/ops/pallas/shear_sum.py:253",
}
SKEW = ("skew_sum_planes", "skew_sum_planes_t", "eval_shear", "eval_shear_t")
GROUPED = ("filter_sum_grouped", "filter_sum_grouped_t")
HAT = ("hat_eval", "hat_eval_t")
PALLAS = ("filter_sum_sel", "filter_sum_sel_t")
SHEAR = ("shear_sum_planes", "shear_sum_planes_t", "eval_shear",
         "eval_shear_t")
MXU = ("filter_sum_mxu", "filter_sum_mxu_t")
# JAX package on the CPU, scripts/jax_dense_anchors.py: the reference
# flagship (64^2/5, dense, cv <= 200 inner, 200 outers, 1e-3 stop; it ran
# all 200: RESULTS.md's 37.54 dB is earlier code's), 20 outers at
# max_inner 50 under each inner algorithm (64^2/5 dense), and 20
# recommended outers under each adapt-rho recipe (64^2/8 dense), with the
# rho trajectory of each.
REF_DENSE_PSNR = 36.986
REF_INNER_PSNR = {"cv": 26.449, "pcv": 26.53, "ppdhg": 26.027,
                  "fista": 26.615}
REF_RHO = {
    "rho20_balance_mu2": (23.761, [20.0, 10.0, 5.0] + [2.5] * 17),
    "rho2_stall_w5": (24.714, [2.0] * 20),
}
# JAX package on the CPU, scripts/jax_dense_anchors.py strategies: the
# flagship (as REF_DENSE_PSNR's run; all 200 outers ran) under the mst,
# chain (JAX's node orders, CHAIN_ORDERS) and complete per-pixel graphs.
REF_STRATEGY_PSNR = {"mst": 42.568, "chain": 43.378, "complete": 34.519}
CHAIN_ORDERS = "scripts/chain_orders_64x5_seed123.npy"
# JAX package on the CPU, scripts/jax_dense_anchors.py batched: its
# run_admm_batched on 64^2/5 dense (cv <= 100 inner, 20 outers, no early
# stop) over rand_im(64, seed=s), s = 0..3, each lane's noise from
# default_rng(BATCH_NOISE_SEED + s): the lanes' mean PSNR, and each lane's.
REF_BATCHED_PSNR = 29.662
REF_BATCHED_LANES = (30.310, 28.369, 28.332, 31.635)
BATCH_NOISE_SEED = 1000
BATCH_64 = 64  # BASELINE config 4: 64 phantoms in one batch
# A lane against its own single run: cuBLAS's product of 64 columns rounds
# apart from its one-column product (4.4e-7 relative on the card), which
# moves an inner stop decision at outers 9-12 of 20 and leaves the states
# 7e-5 to 2.8e-3 apart (relative norm) and the PSNRs 0.0014 dB (PERF.md,
# section 6; scripts/torch_batch_lanes.py). Exactness is held bit for bit
# instead against a batch of the same lanes alone.
# twice the largest lane-against-single-run state difference of the
# batched_64 cell on an H100 (2.8e-3, the 64-column product's rounding)
BATCH_STATE_RTOL = 6e-3
BATCH_PSNR_TOL = 0.01  # dB, a lane against its own single run
BATCH_256_SCALES = (1.0, 1.05, 1.1, 1.15)
# JAX package on the CPU, scripts/jax_dense_anchors.py solvers: the
# alternative solvers on the flagship problem (64^2/5, dense), and BASELINE
# config 1 (centralized TV under fcv on a 128^2 Shepp-Logan, on JAX's
# Joseph operator: the dense operator without A). The fcv runs take JAX's
# Lanczos start from LANCZOS_V0.
REF_SOLVER_PSNR = {
    "ridge_dense": 29.285, "ridge_cg_joseph": 29.284,
    "centralized_tv_cv": 28.979, "centralized_tv_fcv": 29.216,
    "pdhg_oracle": 11.408, "pdhg_residual": 11.391,
    "graph_problem_dense": 21.367,
}
REF_TV_128_PSNR = 29.989
# Ridge by Cholesky and by CG held to each other at the JAX test's lam and
# tolerance (tests/test_solvers.py:32-41: atol 2e-2, rtol 1e-2).
RIDGE_AGREE_LAM = 1e-2
# RESULTS.md's value for BASELINE config 1, from earlier JAX code on a TPU:
# printed beside the port's as context, not a limit.
RESULTS_TV_128_PSNR = 38.1
LANCZOS_V0 = "scripts/jax_lanczos_v0.npz"
# A checkpointed or resumed run against the unsegmented one, relative to
# its state's norm.
RESUME_RTOL = 1e-6
# Dense against Joseph (one operator): b, W, opnorm and both applies within
# 1e-5 of the max, x after three outers within 1e-3, 128^2 PSNRs 0.05 dB.
DENSE_JOSEPH_RTOL = 1e-5
DENSE_JOSEPH_X_RTOL = 1e-3
DENSE_JOSEPH_PSNR_TOL = 0.05
# The mesh runs' checks, and the single-device state they are held to.
MESH_PSNR_TOL = 0.05  # dB from the single-device recommended run
MESH_STATE_OUTERS = 3
MESH_STATE_RTOL = 1e-3


def _bench_cfg(table_dtype: str, fan_beam: bool = False, N: int = 256):
    from dip_admm_tpu_torch.config import (
        AdmmConfig, GeometryConfig, GraphConfig, NodeSolverConfig,
        ProblemConfig,
    )

    return ProblemConfig(
        geometry=GeometryConfig(N=N, num_nodes=8, fan_beam=fan_beam),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=20,
            eps_pri=0.0, eps_dual=0.0,  # never stop early
            node=NodeSolverConfig(max_inner=200, check_every=25),
        ),
        noise_level=0.005, noise_seed=0, phantom="shepp",
        fft_table_dtype=table_dtype,
    )


def _recommended(admm_cfg):
    """The recommended operating point on top of the parity contract."""
    return dataclasses.replace(
        admm_cfg, relax_alpha=1.8,
        node=dataclasses.replace(admm_cfg.node, algorithm="fcv",
                                 max_inner=15, check_every=15),
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


def _kernel_modules():
    from dip_admm_tpu_torch.ops.kernels import (
        consensus, filter_mxu, filter_sum, hat_eval, shear_sum,
    )

    return shear_sum, consensus, filter_sum, hat_eval, filter_mxu


def _counts() -> dict:
    out = {}
    for m in _kernel_modules():
        out.update(m.launch_counts())
    return out


def _reset_counts() -> None:
    for m in _kernel_modules():
        m.reset_launch_counts()


def _nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(a) for a in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0


def _nnz_taps(W, PB) -> int:
    """Nonzero taps that PB images read from the tap table ``W``
    [PT, ...]: image p reads table set p % PT."""
    import torch

    return (PB // W.shape[0]) * int(torch.count_nonzero(W))


def _work(name, args, got):
    """(bytes, f32 FLOPs, bf16 FLOPs) that kernel ``name`` must do on
    ``args``: each input read once, each output written once (K17 reads
    only the profile taps this call's coordinates touch), the FLOPs of the
    function's arithmetic by the type it runs in (bf16 where the JAX kernel
    rounds both factors to bf16). A tap product counts the nonzero taps of
    its table (at most two of D2 per row), not the dense contraction."""
    nbytes = _nbytes([a for a in args if hasattr(a, "numel")]) + _nbytes(got)
    f32 = bf16 = 0
    if name in ("skew_sum_planes", "skew_sum_planes_t",
                "skew_sum_planes_t_rows"):
        fwd = name == "skew_sum_planes"
        W = args[1] if fwd else args[2]  # WtT [PT, NB, D2, Tp, nb]
        PB = args[0].shape[0]
        _, NB, _, Tp, nb = W.shape
        WZ = args[4].shape[0] if fwd else args[5].shape[1]
        F = args[2 if fwd else 3].shape[-1]
        WS = (args[0] if fwd else got[0]).shape[-1]  # the row width
        taps = 2 * _nnz_taps(W, PB) * WS
        dft = 4 * PB * NB * Tp * WZ * F
        lowp = W.dtype != args[0].dtype
        f32 += 8 * PB * NB * Tp * F + (0 if lowp else taps + dft)
        bf16 += taps + dft if lowp else 0
    elif name in ("eval_shear", "eval_shear_t"):
        Wd = args[2] if name == "eval_shear" else args[1]
        PB = args[0].shape[0]
        _, DB, Tp, D2p, _ = Wd.shape
        F = args[-3].shape[-1]
        mm = 4 * PB * DB * Tp * F * D2p
        lowp = Wd.dtype != args[0].dtype
        f32 += 8 * PB * DB * Tp * F + 2 * _nnz_taps(Wd, PB)
        f32 += 0 if lowp else mm
        bf16 += mm if lowp else 0
    elif name in ("shear_sum_planes", "shear_sum_planes_t", "shear_sum",
                  "shear_sum_t"):
        Wt = args[2]  # [PT, NB, Tp, D2, nb]
        PB, F = args[0].shape[0], args[3].shape[-1]
        _, NB, Tp, D2, _ = Wt.shape
        taps = 4 * _nnz_taps(Wt, PB) * F
        lowp = Wt.dtype != args[0].dtype
        f32 += 8 * PB * NB * Tp * (D2 + 1) * F + (0 if lowp else taps)
        bf16 += taps if lowp else 0
    elif name in ("consensus_update", "consensus_update_sharded"):
        f32 += 12 * args[0].numel()
    elif name in MXU:  # the contraction, on the tiled table
        _, FB, NBt, Tp, L = args[2].shape
        f32 += 8 * args[0].shape[0] * Tp * NBt * L * FB
    elif name.startswith("filter_sum"):
        PB = args[0].shape[0]
        _, T, N, F = args[2].shape
        f32 += 8 * PB * T * N * F
    elif name in HAT:
        pc = args[1]
        PB, PT = args[0].shape[0], pc.shape[0]
        f32 += 13 * PB * pc[0].numel()
        if name == "hat_eval":
            import torch

            g = args[0]
            Np = g.shape[-1]
            v0 = torch.floor(pc).long()
            hit = torch.zeros((PT, pc.shape[1], Np + 3), dtype=torch.bool,
                              device=pc.device)
            for k in (0, 1):
                hit.scatter_(2, (v0 + k + 1).clamp(0, Np + 2), True)
            taps = int(hit[..., 1:Np + 1].sum())
            nbytes += (PB // PT) * taps * 4 - _nbytes(g)
    return nbytes, f32, bf16


def _bound(nbytes, f32, bf16):
    """(ms, "bytes" or "operations"): the least time of the card for this
    work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32 / F32_FLOPS + bf16 / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_build() -> None:
    from dip_admm_tpu_torch.ops.kernels import _build

    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        infos = dict(zip(LIBRARIES, ex.map(_build.build, LIBRARIES)))
    for name in LIBRARIES:
        _build.load(name)
    print("build: " + " ".join(
        f"{name}_nvcc_s={'cached' if i['seconds'] is None else i['seconds']}"
        for name, i in infos.items()), flush=True)


def phase_problem(torch, dev):
    from dip_admm_tpu_torch.data import loader

    cfg = _bench_cfg("bfloat16")
    _reset_counts()
    t0 = time.perf_counter()
    problem = loader.build_problem(cfg, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"problem: build_s={build_s} build_launches={json.dumps(_counts())} "
          f"union_edges={int(problem.adj.sum()) // 2}", flush=True)
    return cfg, problem


def _compare(torch, name, kern, ref, args, rtol, failures, note="",
             library=None):
    """Kernel against plain version on ``args``; times both, and
    ``library`` (one PyTorch call computing the same function on inputs
    prepared from ``args``) where given. Returns (outputs, numbers)."""
    got, want = kern(*args), ref(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    # Error of each output relative to that output's max.
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    rels = [e / float(b.abs().max()) if float(b.abs().max()) > 0 else math.inf
            for e, b in zip(errs, want)]
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    del want
    ms = _time_ms(torch, lambda: kern(*args))
    plain_ms = _time_ms(torch, lambda: ref(*args))
    library_ms = None if library is None else _time_ms(torch, library)
    bound_ms, bound_by = _bound(*_work(name, args, got))
    ok = finite and max(rels) <= rtol
    if not ok:
        failures.append(f"kernel {name}{note}: rel err {max(rels)} "
                        f"(finite={finite})")
    print(f"kernels: {name}{note} shape={tuple(got[0].shape)} "
          f"max_abs_err={max(errs)} max_rel_err={max(rels)} ms={ms} "
          f"plain_ms={plain_ms} library_ms={library_ms} bound_ms={bound_ms} "
          f"bound_by={bound_by} share_of_bound={bound_ms / ms} ok={ok}",
          flush=True)
    return got, dict(max_abs_err=max(errs), max_rel_err=max(rels), ms=ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=bound_ms, bound_by=bound_by)


def _check_repeat(torch, name, kern, args, got, failures) -> bool:
    """Whether a second call of ``kern`` on ``args`` gives ``got`` (the
    first call's outputs, as ``_compare`` returns them) bit for bit."""
    again = kern(*args)
    torch.cuda.synchronize()
    again = again if isinstance(again, tuple) else (again,)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    if not bitwise:
        failures.append(f"kernel {name}: two calls differ")
    return bitwise


def _device_ms(torch, fn, calls=10) -> tuple[float, dict, float]:
    """The device time of one call of ``fn`` from ``torch.profiler`` (the
    host's dispatch excluded): the per-call sum over its kernels, in ms,
    each kernel's per-call ms by name, and the device launches a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = e.name[:60]
            by[k] = by.get(k, 0.0) + 1e-3 * (
                e.time_range.end - e.time_range.start) / calls
            n += 1
    return sum(by.values()), by, n / calls


def _host_us(torch, fn, calls=200) -> float:
    """The host's cost of one call of ``fn`` where the host is slower than
    the device: the wall clock of ``calls`` back-to-back calls with no sync
    between them, over ``calls``, in microseconds (one sync after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def _call_cost(torch, fn, failures=None, name="", launches_max=None) -> str:
    """``host_us_per_call``, ``device_ms`` and ``device_launches_per_call``
    of ``fn`` (``_host_us``, ``_device_ms``), for a kernel's line; a call of
    more than ``launches_max`` device launches is a failure."""
    dev_ms, _, launches = _device_ms(torch, fn)
    if launches_max is not None and launches > launches_max:
        failures.append(f"kernel {name}: {launches} device launches a call, "
                        f"expected {launches_max}")
    return (f"host_us_per_call={_host_us(torch, fn)} device_ms={dev_ms} "
            f"device_launches_per_call={launches}")


def _repeat_and_device(torch, kern, args, got, failures, note=""):
    """A second call of ``kern`` on ``args`` against ``got`` (bit for bit)
    and its device time: (bitwise, device ms, ms by kernel, device launches
    a call)."""
    bitwise = _check_repeat(torch, f"{kern.__name__}{note}", kern, args, got,
                            failures)
    return (bitwise, *_device_ms(torch, lambda: kern(*args)))


def _skew_checks(torch, kern, args, got, failures, note="") -> None:
    """K1, K2 or K6 (``kern``) with bf16 tables beyond ``_compare``:
    bitwise on a second call, its device time by launch, and the share of
    its taps and of its tensor-core tap tiles that hold a nonzero (K1: d,
    16 rows n, 8 slots; K2/K6: a k16 step of (d, t) in the order d then t,
    8 rows n)."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    name = kern.__name__
    bitwise, dev_ms, by, per_call = _repeat_and_device(torch, kern, args, got,
                                                       failures, note)
    fwd = kern is ss.skew_sum_planes
    W = args[1] if fwd else args[2]  # WtT [PT, NB, D2, Tp, nb]
    PT, NB, D2, Tp, nb = W.shape
    tt = Tp // args[6 if fwd else 7].shape[1]  # plane [PT, TB]
    nz = W != 0
    tiles = None
    if fwd and Tp % 8 == 0 and nb % 16 == 0:
        tiles = nz.reshape(PT, NB, D2, Tp // 8, 8, nb // 16, 16)
    elif not fwd and tt % 8 == 0 and nb % 8 == 0 and D2 * tt % 16 == 0:
        tiles = nz.reshape(PT, NB, D2, Tp // tt, tt, nb).transpose(2, 3) \
            .reshape(PT, NB, Tp // tt, D2 * tt // 16, 16, nb // 8, 8)
    if tiles is not None:
        tiles = float(tiles.any(dim=-1).any(dim=-2).float().mean())
    print(f"kernels: {name}{note} bitwise_repeat={bitwise} "
          f"device_ms={dev_ms} device_launches_per_call={per_call} "
          f"device_ms_by_kernel={json.dumps(by)} "
          f"nonzero_tap_share={float(nz.float().mean())} "
          f"nonzero_tap_tile_share={tiles}", flush=True)


def _shear_checks(torch, kern, args, got, failures, note="") -> None:
    """K7 or K8 (``kern``) beyond ``_compare``: bitwise on a second call,
    its device time by launch and its device launches a call, and the share
    of its taps and of its tap tiles that hold a nonzero (the mask pass's
    8 x 8 tiles; the tensor-core tiles, K7's of 8 taps x 16 rows and K8's
    of 16 taps x 8 rows)."""
    bitwise, dev_ms, by, per_call = _repeat_and_device(torch, kern, args, got,
                                                       failures, note)
    W = args[2]  # Wt [PT, NB, Tp, D2, nb]
    PT, NB, Tp, D2, nb = W.shape
    nz = W != 0
    tiles = {}
    if D2 % 16 == 0 and nb % 16 == 0:
        t8 = nz.reshape(PT, NB, Tp, D2 // 8, 8, nb // 8, 8).any(dim=-1) \
            .any(dim=-2)  # [PT, NB, Tp, D2 / 8, nb / 8]
        tiles = {
            "8x8": float(t8.float().mean()),
            "k7_8x16": float(t8.reshape(PT, NB, Tp, D2 // 8, nb // 16, 2)
                             .any(dim=-1).float().mean()),
            "k8_16x8": float(t8.reshape(PT, NB, Tp, D2 // 16, 2, nb // 8)
                             .any(dim=-2).float().mean())}
    print(f"kernels: {kern.__name__}{note} bitwise_repeat={bitwise} "
          f"device_ms={dev_ms} device_launches_per_call={per_call} "
          f"device_ms_by_kernel={json.dumps(by)} "
          f"nonzero_tap_share={float(nz.float().mean())} "
          f"nonzero_tap_tile_share={json.dumps(tiles)}", flush=True)


def _shear_cases(torch, dev, t, P, gen):
    """(name, wrapper, plain version, arguments) of K7 and K8 on the shear
    tables ``t``, with the spectra and cotangents of P images drawn from
    ``gen``."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    _, NB, Tp, _, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    tabs = (t["Wt"], t["SEre"], t["SEim"], t["shared"]["Phire"],
            t["shared"]["Phiim"], t["plane"])
    r = [torch.randn((P, 2, NB * nb, F), generator=gen, device=dev)
         for _ in range(2)]
    g = [torch.randn((P, Tp, F), generator=gen, device=dev) for _ in range(2)]
    return (("shear_sum_planes", ss.shear_sum_planes,
             ss.shear_sum_planes_ref, (*r, *tabs)),
            ("shear_sum_planes_t", ss.shear_sum_planes_t,
             ss.shear_sum_planes_t_ref, (*g, *tabs)))


def _eval_checks(torch, kern, args, got, failures, note="") -> None:
    """K3 or K4 (``kern``) beyond ``_compare``: bitwise on a second call,
    its device time by launch and its device launches a call."""
    bitwise, dev_ms, by, per_call = _repeat_and_device(torch, kern, args, got,
                                                       failures, note)
    print(f"kernels: {kern.__name__}{note} bitwise_repeat={bitwise} "
          f"device_ms={dev_ms} device_launches_per_call={per_call} "
          f"device_ms_by_kernel={json.dumps(by)}", flush=True)


def _eval_block_checks(torch, t, num_nodes, nodes, cases, got, failures,
                       note) -> dict:
    """K3 and K4 as a mesh rank runs them: on the images of the graph nodes
    ``nodes`` with their node block's tables (``t`` sliced), against their
    plain versions, with ``_eval_checks``, and equal bit for bit to the
    rows of ``got`` (each kernel's outputs on every node). Returns each
    kernel's numbers under ``block_`` + its name."""
    from dip_admm_tpu_torch.parallel.mesh import slice_tables

    loc = slice_tables(t, num_nodes, nodes)
    out = {}
    for name in ("eval_shear", "eval_shear_t"):
        kern, ref, args = cases[name]
        nimg = 2 if name == "eval_shear" else 1
        largs = (*(a[nodes].contiguous() for a in args[:nimg]), loc["Wd"],
                 loc["TEre"], loc["TEim"], *args[-2:])
        part, out[f"block_{name}"] = _compare(
            torch, name, kern, ref, largs, KERNEL_RTOL, failures, note=note)
        _eval_checks(torch, kern, largs, part, failures, note)
        rows = all(torch.equal(a, b[nodes]) for a, b in zip(part, got[name]))
        if not rows:
            failures.append(f"kernel {name}{note}: differs from the whole "
                            "batch's rows")
        print(f"kernels: {name}{note} equals_whole_batch_rows={rows}",
              flush=True)
    return out


def _eval_p512_checks(torch, dev, t, P, gen, failures) -> dict:
    """K3 and K4 on the 512^2/8 shear tables ``t`` (four detector blocks of
    128: the R stage's two pairs) for P images drawn from ``gen``, against
    their plain versions, with ``_eval_checks``. Returns each kernel's
    numbers under ``p512_`` + its name."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    sh = t["shared"]
    _, DB, Tp, _, db = t["Wd"].shape
    F = t["TEre"].shape[-1]
    g = [torch.randn((P, Tp, F), generator=gen, device=dev) for _ in range(2)]
    ob = torch.randn((P, Tp, DB * db), generator=gen, device=dev)
    out = {}
    for name, kern, ref, args in (
            ("eval_shear", ss.eval_shear, ss.eval_shear_ref,
             (*g, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"],
              sh["PhiDim"])),
            ("eval_shear_t", ss.eval_shear_t, ss.eval_shear_t_ref,
             (ob, t["Wd"], t["TEre"], t["TEim"], sh["PhiDre"],
              sh["PhiDim"]))):
        got, out[f"p512_{name}"] = _compare(torch, name, kern, ref, args,
                                            KERNEL_RTOL, failures,
                                            note=f"[512^2/8 DB={DB}]")
        _eval_checks(torch, kern, args, got, failures, f"[512^2/8 DB={DB}]")
        del got
    return out


def _skew_cases(torch, dev, t, P, gen):
    """Inputs of P images drawn from ``gen`` and each of K1-K4's (wrapper,
    plain version, arguments) on the skew tables ``t``."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    sh = t["shared"]
    _, NB, D2, Tp, nb = t["WtT"].shape
    N, F, D = NB * nb, t["SEre"].shape[-1], t["Wd"].shape[1] * t["Wd"].shape[-1]
    img = torch.randn((P, N, N), generator=gen, device=dev)
    rows2 = torch.stack([img, img.transpose(1, 2)], dim=1).contiguous()
    g_re = torch.randn((P, Tp, F), generator=gen, device=dev)
    g_im = torch.randn((P, Tp, F), generator=gen, device=dev)
    ob = torch.randn((P, Tp, D), generator=gen, device=dev)
    return img, {
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


def _row_shard_checks(torch, t, num_nodes, nodes, img, g, failures, note,
                      shards=2) -> dict:
    """K1 and K6 as each shard of a ``shards``-wide pixel axis runs them on
    the skew tables ``t`` (``WtT``/``SEre``/``SEim``/``plane`` and their
    ``shared``) of the graph nodes ``nodes``: K1 on the shard's rows of the
    images ``img`` [PB, N, N] and K6 from the slot spectra ``g`` at the full
    row width, each against its plain version and twice bitwise. The
    shards' K1 outputs summed, as the pixel-axis sum adds them, must hold
    to K1 on all rows (error <= 2e-3 of its max), and their K6 outputs
    concatenated must equal K2's bit for bit. Returns each kernel's numbers
    (the first shard's times, the largest error) under ``rows_`` + K1's
    name and K6's name."""
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss
    from dip_admm_tpu_torch.parallel.mesh import slice_tables

    whole = slice_tables(t, num_nodes, nodes)
    sh = whole["shared"]
    N = img.shape[-1]
    k1 = ss.skew_sum_planes(
        torch.stack([img, img.transpose(1, 2)], dim=1).contiguous(),
        whole["WtT"], whole["SEre"], whole["SEim"], sh["Dre"], sh["Dim"],
        whole["plane"])
    k2 = ss.skew_sum_planes_t(*g, whole["WtT"], whole["SEre"],
                              whole["SEim"], sh["DreT"], sh["DimT"],
                              whole["plane"])
    got_all = {"skew_sum_planes": [], "skew_sum_planes_t_rows": []}
    res = {"skew_sum_planes": [], "skew_sum_planes_t_rows": []}
    for s in range(shards):
        loc = slice_tables(t, num_nodes, nodes, (s, shards))
        tabs = (loc["WtT"], loc["SEre"], loc["SEim"])
        rows = slice(s * N // shards, (s + 1) * N // shards)
        rows2 = torch.stack([img[:, rows], img.transpose(1, 2)[:, rows]],
                            dim=1).contiguous()
        for name, kern, ref, args in (
                ("skew_sum_planes", ss.skew_sum_planes,
                 ss.skew_sum_planes_ref,
                 (rows2, *tabs, sh["Dre"], sh["Dim"], loc["plane"])),
                ("skew_sum_planes_t_rows", ss.skew_sum_planes_t_rows,
                 ss.skew_sum_planes_t_rows_ref,
                 (*g, *tabs, sh["DreT"], sh["DimT"], loc["plane"], N))):
            tag = f"{name}{note}[row shard {s} of {shards}]"
            got, r = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                              failures, note=tag[len(name):])
            _skew_checks(torch, kern, args, got, failures, tag[len(name):])
            got_all[name].append(got)
            res[name].append(r)
    k1_rel = max(
        float((sum(p[i] for p in got_all["skew_sum_planes"]) - k1[i])
              .abs().max() / k1[i].abs().max()) for i in range(2))
    tiles = torch.equal(torch.cat(
        [p[0] for p in got_all["skew_sum_planes_t_rows"]], dim=2), k2)
    if k1_rel > KERNEL_RTOL or not tiles:
        failures.append(f"row shards{note}: K1 summed vs all rows {k1_rel}, "
                        f"K6 concatenated equals K2 {tiles}")
    print(f"kernels: row shards{note} k1_sum_vs_all_rows_rel_err={k1_rel} "
          f"k6_concat_equal_k2={tiles}", flush=True)
    return {key: dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
            for key, rs in (("rows_skew_sum_planes", res["skew_sum_planes"]),
                            ("skew_sum_planes_t_rows",
                             res["skew_sum_planes_t_rows"]))}


def phase_kernels(torch, dev, problem, failures) -> dict:
    from dip_admm_tpu_torch.ops import radon_fft
    from dip_admm_tpu_torch.ops.kernels import consensus as cons

    t = problem.fft_tables
    P, NB, D2, Tp, nb = t["WtT"].shape
    N, F = NB * nb, t["SEre"].shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    img, cases = _skew_cases(torch, dev, t, P, gen)
    out, got_all = {}, {}
    for name, (kern, ref, args) in cases.items():
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures)
        got_all[name] = got
        if name in ("skew_sum_planes", "skew_sum_planes_t"):
            _skew_checks(torch, kern, args, got, failures)
        else:
            _eval_checks(torch, kern, args, got, failures)

    # K1 and K6 as the ranks of the 2 x 2 mesh run them: node block 1 of 2,
    # each row shard of the pixel axis; K3 and K4 on that node block.
    g = cases["skew_sum_planes_t"][2][:2]
    blk = slice(P // 2, P)
    out.update(_eval_block_checks(torch, t, P, blk, cases, got_all, failures,
                                  f"[P_loc={P // 2} of {P}]"))
    out.update(_row_shard_checks(torch, t, P, blk, img[blk],
                                 [v[blk] for v in g], failures,
                                 f"[P_loc={P // 2} of {P}]"))

    geo = problem.cfg.geometry

    def pair():
        return radon_fft.backproject_nodes_skew(
            geo, radon_fft.project_nodes_skew(geo, img, t), t)

    pair_ms = _time_ms(torch, pair)
    print(f"kernels: apply_pair_ms={pair_ms} (project + backproject, bf16 "
          f"tables, P={P} N={N} Tp={Tp} F={F})", flush=True)
    out["apply_pair_ms"] = pair_ms

    # K5 at the edge-state shape of the main path, on its graph and weights.
    print("kernels: consensus_update clusters_resident=" + json.dumps({
        f"{'sharded' if sh else 'single'}_{f}": cons.max_active_clusters(
            sh, f == "weighted")
        for sh in (False, True) for f in ("midpoint", "weighted")}),
        flush=True)
    n = geo.n
    a, y, z = (torch.randn((P, P, n), generator=gen, device=dev)
               for _ in range(3))
    adjm = problem.adj.to(torch.float32)
    res = []
    for fusion in ("midpoint", "weighted"):
        # a, y, z (and w) read; z', y' written. The midpoint reads no w.
        w = problem.W if fusion == "weighted" else None
        nbytes = 5 * P * P * n * 4 + (0 if w is None else _nbytes([w]))
        args = (a, y, z, adjm, w, fusion)
        got, r = _compare(torch, "consensus_update", cons.consensus_update,
                          cons.consensus_update_ref, args, K5_RTOL, failures,
                          note=f"[{fusion}]")
        bitwise = _check_repeat(torch, f"consensus_update[{fusion}]",
                                cons.consensus_update, args, got, failures)
        cost = _call_cost(torch, lambda: cons.consensus_update(*args),
                          failures, f"consensus_update[{fusion}]", 1)
        print(f"kernels: consensus_update[{fusion}] bitwise_repeat={bitwise} "
              f"bytes={nbytes} GB_per_s={nbytes / r['ms'] / 1e6} "
              f"plain_GB_per_s={nbytes / r['plain_ms'] / 1e6} {cost}",
              flush=True)
        res.append(r)
    # The main path runs the midpoint fusion: its times represent K5.
    out["consensus_update"] = dict(
        res[0], max_abs_err=max(r["max_abs_err"] for r in res))

    # K5's sharded form at a rank's block of the 2 x 2 mesh run: node block
    # 1 of 2 and pixel block 1 of 2, a_t gathered as the mesh's all_to_all
    # gathers it; its z and y equal the single-device kernel's on the block.
    rows, cols = slice(P // 2, P), slice(n // 2, n)
    blk = [v[rows][..., cols].contiguous() for v in (a, y, z, a.transpose(0, 1))]
    blk.append(adjm[rows].contiguous())
    w_blk = (problem.W[rows, cols].contiguous(), problem.W[:, cols].contiguous())
    res = []
    for fusion in ("midpoint", "weighted"):
        ws = w_blk if fusion == "weighted" else (None, None)

        def kern(a_, y_, z_, at_, m_, *w, _f=fusion):
            return cons.consensus_update(
                a_, y_, z_, m_, fusion=_f, a_t=at_, w_own=w[0] if w else None,
                w_all=w[1] if w else None)

        def ref(a_, y_, z_, at_, m_, *w, _f=fusion):
            return cons.consensus_update_ref(
                a_, y_, z_, m_, fusion=_f, a_t=at_, w_own=w[0] if w else None,
                w_all=w[1] if w else None)

        args = (*blk, *(w for w in ws if w is not None))
        got, r = _compare(torch, "consensus_update_sharded", kern, ref, args,
                          K5_RTOL, failures, note=f"[{fusion}, P_loc={P // 2}"
                          f" of {P}, n_loc={n // 2}]")
        bitwise = _check_repeat(torch, f"consensus_update_sharded[{fusion}]",
                                kern, args, got, failures)
        single = cons.consensus_update(a, y, z, adjm, problem.W, fusion)
        block = all(torch.equal(g, f[rows][..., cols])
                    for g, f in zip(got[:2], single[:2]))
        if not block:
            failures.append(f"kernel consensus_update_sharded[{fusion}]: z, y"
                            " differ from the single-device kernel's block")
        # a, a_t, y, z (and w_own, w_all) read; z', y' written
        sh_bytes = 6 * (P // 2) * P * (n // 2) * 4 + _nbytes(args[5:])
        cost = _call_cost(torch, lambda: kern(*args), failures,
                          f"consensus_update_sharded[{fusion}]", 1)
        print(f"kernels: consensus_update_sharded[{fusion}] bitwise_repeat="
              f"{bitwise} equals_single_device_block={block} "
              f"bytes={sh_bytes} GB_per_s={sh_bytes / r['ms'] / 1e6} {cost}",
              flush=True)
        res.append(r)
    out["consensus_update_sharded"] = dict(
        res[0], max_abs_err=max(r["max_abs_err"] for r in res))
    del a, y, z, blk
    torch.cuda.empty_cache()
    return out


def phase_adjoint(torch, dev, failures) -> None:
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fft

    cfg = _bench_cfg("float32")
    geo = cfg.geometry
    a, v, _ = radon.node_angles(geo)
    t = loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev))
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


def _mean_psnr(x, x_true) -> float:
    """Mean PSNR over the nodes' images x [P, n] (numpy)."""
    from dip_admm_tpu_torch.utils.imaging import psnr

    return float(np.mean([psnr(xi, x_true, data_range=x_true.max())
                          for xi in x]))


def _drive(torch, problem, admm_cfg, ref_psnr, tag, failures,
           kernels=SKEW):
    """Run ``admm_cfg`` through ``run_admm`` with the counters zeroed just
    before and read just after; check it (each of ``kernels`` and K5 must
    launch, the mean PSNR within ``PSNR_TOL`` of ``ref_psnr`` where one is
    given); return (result, counts, line)."""
    from dip_admm_tpu_torch.core import admm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = admm.run_admm(problem, admm_cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()

    n = res.n_iters
    pri = float(res.history["primal"][n - 1])
    dual = float(res.history["dual"][n - 1])
    inner = res.history["inner_iters"][:n].float().mean().item()
    x = res.x.cpu().numpy()
    mean_psnr = _mean_psnr(x, problem.x_true.cpu().numpy())
    checks = {
        "outers": n == admm_cfg.max_iters,
        "shape": x.shape == (problem.num_nodes, problem.n),
        "finite": bool(np.isfinite(x).all()) and math.isfinite(pri)
        and math.isfinite(dual),
        "psnr": ref_psnr is None or abs(mean_psnr - ref_psnr) <= PSNR_TOL,
        "launches": all(counts[k] > 0 for k in kernels),
        "k5_once_per_outer": counts["consensus_update"] == n,
    }
    for k, ok in checks.items():
        if not ok:
            failures.append(f"{tag} path check {k} failed")
    line = (f"run_s={run_s} outer_iters={n} outer_it_per_s={n / run_s} "
            f"mean_inner_iters={inner} final_primal={pri} final_dual={dual} "
            f"mean_psnr={mean_psnr} ref_psnr={ref_psnr} "
            f"run_launches={json.dumps(counts)} "
            f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30} "
            f"ok={all(checks.values())}")
    return res, counts, line


def phase_main(torch, cfg, problem, failures) -> dict:
    _, counts, line = _drive(torch, problem, cfg.admm, REF_PSNR, "main",
                             failures)
    print(f"main: {line}", flush=True)
    return counts


def phase_recommended(torch, cfg, problem, failures) -> dict:
    from dip_admm_tpu_torch.core import node_solver

    rec = _recommended(cfg.admm)
    # The preconditioner alone, as run_admm builds it (same default start):
    # first the process's first FFT and eigvalsh (library set-up included),
    # then warm.
    precond_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp = node_solver.build_fourier_precond(
            problem.forward, problem.adjoint, torch.sum(problem.Q, dim=1),
            rec.rho, rec.node, problem.N)
        step = fp.step.cpu().numpy()
        precond_s.append(time.perf_counter() - t0)

    res, counts, line = _drive(torch, problem, rec, REF_REC_PSNR,
                               "recommended", failures)
    tk = res.state.node.tk.cpu().numpy()
    halvings = int(np.rint(np.log2(step / tk)).sum())
    if not (np.isfinite(step).all() and (step > 0).all()):
        failures.append(f"recommended: certified steps {step}")
    print(f"recommended: precond_build_s={precond_s[0]} "
          f"precond_build_warm_s={precond_s[1]} {line} "
          f"certified_step={step.tolist()} final_tk={tk.tolist()} "
          f"monitor_halvings={halvings}", flush=True)
    return counts, _mean_psnr(res.x.cpu().numpy(),
                              problem.x_true.cpu().numpy())


def _mesh_rank(rank, device, fan, n_node, pixel, state_outers):
    """One rank of a mesh phase: builds the fan or parallel 256^2/8 bench
    problem on ``device``, zeroes its launch counts, runs 20 recommended
    outers through ``run_admm_sharded`` and reads its counts; with
    ``state_outers``, also a run of that many outers. Rank 0 returns the
    gathered results besides its counts."""
    import torch

    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.parallel import admm_sharded
    from dip_admm_tpu_torch.parallel import mesh as meshlib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(device)
    cfg = _bench_cfg("bfloat16", fan_beam=fan)
    rec = _recommended(cfg.admm)
    problem = loader.build_problem(cfg, device)
    mesh = meshlib.make_mesh(n_node, pixel, device)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = admm_sharded.run_admm_sharded(problem, rec, mesh)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    out = {"counts": _counts(), "run_s": run_s, "n_iters": res.n_iters,
           "comm": dict(mesh.stats),
           "transport": mesh.transport,
           "pixel_compute": admm_sharded.pixel_compute(problem, mesh),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    full = admm_sharded.gather_result(res, mesh)
    n = res.n_iters
    out.update(x=full.x.cpu().numpy(), x_true=problem.x_true.cpu().numpy(),
               primal=float(full.history["primal"][n - 1]),
               dual=float(full.history["dual"][n - 1]))
    if state_outers:
        part = admm_sharded.gather_result(admm_sharded.run_admm_sharded(
            problem, rec, mesh, until=state_outers), mesh)
        out["state"] = _state_np(part.state)
    return out if rank == 0 else {"counts": out["counts"], "comm": out["comm"],
                                  "run_s": run_s}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _state_np(st) -> list:
    return [v.cpu().numpy() for v in (st.node.x, st.Z, st.Y)]


def _node_block_reference(torch, problem, n_node) -> tuple[list, list, float]:
    """The single-device recommended run after ``MESH_STATE_OUTERS`` outers
    twice: with fcv's preconditioner built per node block of an
    ``n_node``-wide node axis, as each node shard of the mesh builds it
    (its Lanczos sums run over that block's batch), and built over every
    node, as ``run_admm`` builds it. Returns both states (x, Z, Y) and the
    largest relative shift of the block-built certified steps."""
    from dip_admm_tpu_torch.core import admm, node_solver
    from dip_admm_tpu_torch.data.loader import make_node_ops
    from dip_admm_tpu_torch.parallel.mesh import slice_tables

    rec = _recommended(problem.cfg.admm)
    P = problem.num_nodes
    P_loc = P // n_node
    D = torch.sum(problem.Q, dim=1)
    blocks = []
    for i in range(n_node):
        nodes = slice(i * P_loc, (i + 1) * P_loc)
        fwd, adj = make_node_ops(problem.mode, problem.cfg.geometry,
                                 slice_tables(problem.fft_tables, P, nodes))
        blocks.append(node_solver.build_fourier_precond(
            fwd, adj, D[nodes], rec.rho, rec.node, problem.N))
    data = admm.block_data(problem, rec)
    fp = type(data.fprecond)(*(torch.cat(v) for v in zip(*blocks)))
    step = data.fprecond.step
    shift = float(((fp.step - step).abs() / step).max())
    states = []
    for d in (data._replace(fprecond=fp), data):
        state, hist = admm.init_state(problem, rec)
        for _ in range(MESH_STATE_OUTERS):
            state = admm.admm_iteration(d, rec, state, hist)
        states.append(_state_np(state))
    return states[0], states[1], shift


def _mesh_run(torch, tag, fan, n_node, pixel, ref_psnr, failures,
              single=None):
    """A mesh phase: ``_mesh_rank`` on n_node x pixel ranks sharing the
    card. ``single`` = (mean PSNR, problem) of the single-device
    recommended run: the mesh's PSNR is held to it, and its state after
    ``MESH_STATE_OUTERS`` outers to that run's with the preconditioner
    built per node block as the mesh builds it. Returns the launch counts
    summed over the ranks."""
    from dip_admm_tpu_torch.parallel import mesh as meshlib

    if single is not None:
        ref_state, whole_state, step_shift = _node_block_reference(
            torch, single[1], n_node)
    world = n_node * pixel
    t0 = time.perf_counter()
    outs = meshlib.launch(
        _mesh_rank, world, torch.device("cuda", 0),
        args=(fan, n_node, pixel, MESH_STATE_OUTERS if single else 0))
    wall_s = time.perf_counter() - t0
    r0 = outs[0]
    n = r0["n_iters"]
    mean_psnr = _mean_psnr(r0["x"], r0["x_true"])
    checks = {
        "outers": n == 20,
        "finite": bool(np.isfinite(r0["x"]).all())
        and math.isfinite(r0["primal"]) and math.isfinite(r0["dual"]),
        "psnr": abs(mean_psnr - ref_psnr) <= PSNR_TOL,
        "pixel_compute": r0["pixel_compute"],
        # Every rank: K1 and K6 launch, K2 does not (the problem build's
        # power method ran it before the counts were zeroed), K5's sharded
        # form once per outer and its single-device form never.
        "launches": all(
            o["counts"]["skew_sum_planes"] > 0
            and o["counts"]["skew_sum_planes_t_rows"] > 0
            and o["counts"]["skew_sum_planes_t"] == 0
            and o["counts"]["consensus_update_sharded"] == n
            and o["counts"]["consensus_update"] == 0 for o in outs),
    }
    line = ""
    if single is not None:
        rel = max(_rel(a, b) for a, b in zip(r0["state"], ref_state))
        checks["psnr_vs_single_device"] = (
            abs(mean_psnr - single[0]) <= MESH_PSNR_TOL)
        checks["state_vs_single_device"] = rel <= MESH_STATE_RTOL
        whole_rel = max(_rel(a, b) for a, b in zip(ref_state, whole_state))
        line = (f" single_device_psnr={single[0]} state_rel_diff_after_"
                f"{MESH_STATE_OUTERS}={rel} (single device, preconditioner "
                f"per node block) precond_step_rel_shift_block_vs_whole="
                f"{step_shift} block_vs_whole_precond_state_rel_diff_after_"
                f"{MESH_STATE_OUTERS}={whole_rel}")
    for k, ok in checks.items():
        if not ok:
            failures.append(f"{tag} check {k} failed")
    counts = {k: sum(o["counts"][k] for o in outs) for k in r0["counts"]}
    how = (f"host-staged, {world} processes on one card"
           if r0["transport"] == "gloo" else f"{world} cards")
    comm = [o["comm"]["seconds"] / o["run_s"] for o in outs]
    print(f"{tag}: mesh={n_node}x{pixel} transport={r0['transport']} "
          f"({how}) run_s={r0['run_s']} "
          f"outer_iters={n} outer_it_per_s={n / r0['run_s']} "
          f"rank0_collectives={r0['comm']['collectives']} "
          f"rank0_collective_s={r0['comm']['seconds']} "
          f"rank0_collective_bytes={r0['comm']['bytes']} "
          f"collective_share_per_rank={comm} "
          f"launch_wall_s={wall_s} final_primal={r0['primal']} "
          f"final_dual={r0['dual']} mean_psnr={mean_psnr} ref_psnr="
          f"{ref_psnr}{line} rank0_peak_mem_gib={r0['peak_mem_gib']} "
          f"rank_launches={json.dumps([o['counts'] for o in outs])} "
          f"ok={all(checks.values())}", flush=True)
    return counts


def _adjoint_rel(torch, fwd, adj, x, y) -> float:
    Ax, Aty = fwd(x), adj(y)
    lhs = float(torch.sum(Ax.double() * y.double()))
    rhs = float(torch.sum(x.double() * Aty.double()))
    return abs(lhs - rhs) / float(torch.linalg.norm(Ax.double())
                                  * torch.linalg.norm(y.double()))


def _pair_ms(torch, fwd, adj, geo, t, img):
    return _time_ms(torch, lambda: adj(geo, fwd(geo, img, t), t))


def phase_fan_problem(torch, dev):
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon_fan

    cfg = _bench_cfg("bfloat16", fan_beam=True)
    problems = {}
    for mode in ("fft_skew", "fft_grouped"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        problems[mode] = loader.build_problem(cfg, dev, mode=mode)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        p = problems[mode]
        t0 = time.perf_counter()
        radon_fan.colnorms_sq_nodes(cfg.geometry, p.angles, p.angle_valid)
        torch.cuda.synchronize()
        print(f"fan_problem: mode={mode} build_s={build_s} "
              f"colnorms_s={time.perf_counter() - t0} "
              f"fan_angles={tuple(p.angles.shape)} "
              f"union_edges={int(p.adj.sum()) // 2}", flush=True)
    return cfg, problems


def phase_fan_kernels(torch, dev, problems, failures) -> dict:
    from dip_admm_tpu_torch.ops import radon_fan

    ts = problems["fft_skew"].fft_tables
    tg = problems["fft_grouped"].fft_tables
    P = ts["fan_valid"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    img, cases = _skew_cases(torch, dev, ts["shared"]["par"], P, gen)
    out = {}
    for name, (kern, ref, args) in cases.items():
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures, note="[fan PT=1]")
        if name in ("skew_sum_planes", "skew_sum_planes_t"):
            _skew_checks(torch, kern, args, got, failures, "[fan PT=1]")
        else:
            _eval_checks(torch, kern, args, got, failures, "[fan PT=1]")
    # K1 and K6 as the 1 x 2 fan mesh runs them: every node's image against
    # the row shards of the node-shared tables.
    rows = _row_shard_checks(torch, ts["shared"]["par"], P, slice(None), img,
                             cases["skew_sum_planes_t"][2][:2], failures,
                             "[fan PT=1]")
    out.update({f"fan_{k}": v for k, v in rows.items()})

    out.update(_grouped_checks(torch, dev, tg["shared"]["par"], P, gen,
                               failures, "[fan PT=1]"))

    geo = problems["fft_skew"].cfg.geometry
    for mode, t, fwd, adj in (
            ("fft_skew", ts, radon_fan.project_nodes_fan_skew,
             radon_fan.backproject_nodes_fan_skew),
            ("fft_grouped", tg, radon_fan.project_nodes_fan_grouped,
             radon_fan.backproject_nodes_fan_grouped)):
        pair_ms = _pair_ms(torch, fwd, adj, geo, t, img)
        out[f"fan_{mode}_apply_pair_ms"] = pair_ms
        print(f"fan_kernels: mode={mode} apply_pair_ms={pair_ms} (project + "
              f"backproject, bf16 tables, P={P} N={geo.N} fan angles "
              f"{ts['fan_valid'].shape[1]})", flush=True)
    return out


def phase_fan_adjoint(torch, dev, failures) -> None:
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fan, radon_fft

    gen = torch.Generator(device=dev).manual_seed(4)
    ops = {
        "fan_fft_skew": (True, "fft_skew", radon_fan.project_nodes_fan_skew,
                         radon_fan.backproject_nodes_fan_skew),
        "fan_fft_grouped": (True, "fft_grouped",
                            radon_fan.project_nodes_fan_grouped,
                            radon_fan.backproject_nodes_fan_grouped),
        "parallel_fft_grouped": (False, "fft_grouped",
                                 radon_fft.project_nodes_grouped,
                                 radon_fft.backproject_nodes_grouped),
    }
    for tag, (fan, mode, fwd, adj) in ops.items():
        cfg = _bench_cfg("float32", fan_beam=fan)
        geo = cfg.geometry
        a, v, _ = radon.node_angles(geo)
        t = loader.build_fft_tables(
            cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
            torch.as_tensor(v, device=dev), mode)
        P, N, m = geo.num_nodes, geo.N, a.shape[1]
        x = torch.randn((P, N, N), generator=gen, device=dev)
        y = torch.randn((P, m, geo.n_det), generator=gen, device=dev)
        rel = _adjoint_rel(torch, lambda u: fwd(geo, u, t),
                           lambda u: adj(geo, u, t), x, y)
        ok = math.isfinite(rel) and rel <= ADJOINT_TOL
        if not ok:
            failures.append(f"fan_adjoint {tag}: rel {rel}")
        print(f"fan_adjoint: {tag} rel_err={rel} ok={ok}", flush=True)
        del t
        torch.cuda.empty_cache()


def phase_fan_runs(torch, cfg, problems, failures) -> dict:
    rec = _recommended(cfg.admm)
    counts = {}
    for mode, kernels in (("fft_skew", SKEW), ("fft_grouped", GROUPED)):
        tag = f"fan_{mode.removeprefix('fft_')}"
        _, counts[mode], line = _drive(torch, problems[mode], rec,
                                       REF_FAN_PSNR, tag, failures, kernels)
        print(f"{tag}: {line}", flush=True)
    return counts


def _table_gib(t) -> float:
    if isinstance(t, dict):
        return sum(_table_gib(v) for v in t.values())
    return _nbytes(t) / 2**30


def _stream_checks(torch, name, kern, args, got, ms, failures, note):
    """K11-K14 (``kern``) beyond ``_compare``: bitwise on a second call,
    the device time of a call and of each launch the profile recorded, the
    launches made and recorded a call (``torch.profiler`` has dropped
    launches before), and the GB/s over the bytes the function must move
    (each input read once, each output written once) against its bound."""
    bitwise = _check_repeat(torch, name, kern, args, got, failures)
    made0 = kern.launches
    dev_ms, by, recorded = _device_ms(torch, lambda: kern(*args))
    made = (kern.launches - made0 - 1) / 10  # one warm-up call, then ten
    nbytes, f32, bf16 = _work(name, args, got)
    bound_ms = _bound(nbytes, f32, bf16)[0]
    per_launch = dev_ms / recorded if recorded else math.inf
    H = args[2]
    print(f"kernels: {name}{note} bitwise_repeat={bitwise} "
          f"shape={tuple(H.shape)} H={H.dtype} pitch={H.stride(-2)} "
          f"device_ms={dev_ms} device_ms_per_recorded_launch={per_launch} "
          f"launches_made_per_call={made} "
          f"launches_recorded_per_call={recorded} bytes={nbytes} "
          f"GB_per_s={nbytes / ms / 1e6} "
          f"device_GB_per_s={nbytes / per_launch / 1e6} bound_ms={bound_ms} "
          f"share_of_bound={bound_ms / ms} "
          f"device_share_of_bound={bound_ms / per_launch} by_kernel={by}",
          flush=True)


def _grouped_checks(torch, dev, t, P, gen, failures, note) -> dict:
    """K13/K14 on the pitched grouped tables ``t`` with P images (seeded
    slot spectra and cotangents in the tables' pitch): ``_compare`` beside
    one complex einsum on complex copies of the same inputs (the transpose
    as conj(sum_t H conj(g))), ``_stream_checks``, the images a thread
    takes, and a node slice of the images (the last half, as a mesh rank
    holds them, with its own table sets where each image has one) against
    the whole batch's rows, bit for bit."""
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs

    PT, Tp, N, F = t["Hre_g"].shape
    TB = t["onehot"].shape[1]
    H = (t["Hre_g"], t["Him_g"])
    r = [fs.pitched_zeros((P, TB, N, F), torch.float32, dev).copy_(
        torch.randn((P, TB, N, F), generator=gen, device=dev))
        for _ in range(2)]
    g = [fs.pitched_zeros((P, Tp, F), torch.float32, dev).copy_(
        torch.randn((P, Tp, F), generator=gen, device=dev)) for _ in range(2)]
    tt = Tp // TB
    Hc = torch.complex(H[0].float(), H[1].float()).reshape(PT, TB, tt, N, F)
    rc = torch.complex(*r).reshape(P // PT, PT, TB, N, F)
    gcc = torch.complex(*g).conj().resolve_conj().reshape(P // PT, PT, TB,
                                                         tt, F)
    half = slice(P // 2, P)
    hs = half if PT == P else slice(None)
    out = {}
    for name, kern, ref, args, part, lib in (
            ("filter_sum_grouped", fs.filter_sum_grouped,
             fs.filter_sum_grouped_ref, (*r, *H),
             (r[0][half], r[1][half], H[0][hs], H[1][hs]),
             lambda: torch.einsum("kpbnf,pbtnf->kpbtf", rc, Hc)),
            ("filter_sum_grouped_t", fs.filter_sum_grouped_t,
             fs.filter_sum_grouped_t_ref, (*g, *H, TB),
             (g[0][half], g[1][half], H[0][hs], H[1][hs], TB),
             lambda: torch.einsum("kpbtf,pbtnf->kpbnf", gcc, Hc))):
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures, note=note, library=lib)
        _stream_checks(torch, name, kern, args, got, out[name]["ms"],
                       failures, note)
        sliced = kern(*part)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b[half]) for a, b in zip(sliced, got))
        if not same:
            failures.append(f"kernel {name}{note}: a node slice differs "
                            "from the whole batch's rows")
        K = fs.grouped_images(P, PT)
        print(f"kernels: {name}{note} PB={P} PT={PT} TB={TB} Tp={Tp} N={N} "
              f"F={F} images_a_thread={K} node_slice={half.start}:"
              f"{half.stop} node_slice_bitwise={same}", flush=True)
        del got, sliced
    del Hc, rc, gcc, r, g
    torch.cuda.empty_cache()
    return out


def phase_p512_problem(torch, dev):
    from dip_admm_tpu_torch.data import loader

    cfg = _bench_cfg("bfloat16", N=512)
    problems = {}
    for mode in ("fft_pallas", "fft_grouped"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        problems[mode] = loader.build_problem(cfg, dev, mode=mode)
        torch.cuda.synchronize()
        p = problems[mode]
        print(f"p512_problem: mode={mode} build_s={time.perf_counter() - t0} "
              f"table_gib={_table_gib(p.fft_tables)} "
              f"angles={tuple(p.angles.shape)} "
              f"union_edges={int(p.adj.sum()) // 2}", flush=True)
    return cfg, problems


def _hat_nan_check(torch, he, prof, pc, s, ob, failures) -> bool:
    """K17 and K18 with one NaN detector coordinate (pc[0, 1, 3]): each
    output NaN exactly where its plain version's is (K17: that detector of
    every image of the geometry set, K18: every v of those rows, as the
    JAX kernels give), and bit-equal elsewhere to the kernel's output on
    the finite coordinates."""
    Np = prof.shape[-1]
    bad = pc.clone()
    bad[0, 1, 3] = float("nan")
    ok = True
    for name, kern, ref, args, bad_args in (
            ("hat_eval", he.hat_eval, he.hat_eval_ref, (prof, pc, s),
             (prof, bad, s)),
            ("hat_eval_t", he.hat_eval_t, he.hat_eval_t_ref,
             (ob, pc, s, Np), (ob, bad, s, Np))):
        clean, got, want = kern(*args), kern(*bad_args), ref(*bad_args)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        same_nan = torch.equal(torch.isnan(got), nan) and bool(nan.any())
        rest = torch.equal(got[~nan], clean[~nan])
        ok = ok and same_nan and rest
        print(f"kernels: {name} nan_coordinate nan_outputs="
              f"{int(torch.isnan(got).sum())} plain_nan_outputs="
              f"{int(nan.sum())} nan_where_plain={same_nan} "
              f"rest_bitwise={rest}", flush=True)
    if not ok:
        failures.append("K17/K18: a NaN coordinate does not give NaN where "
                        "the plain version does")
    return ok


def phase_p512_kernels(torch, dev, problems, failures) -> dict:
    import torch.nn.functional as fn

    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fft
    from dip_admm_tpu_torch.ops.kernels import filter_sum as fs
    from dip_admm_tpu_torch.ops.kernels import hat_eval as he

    tp = problems["fft_pallas"].fft_tables
    PT, T, N, F = tp["Hre"].shape
    P = problems["fft_pallas"].num_nodes
    gen = torch.Generator(device=dev).manual_seed(5)
    H, sel = (tp["Hre"], tp["Him"]), tp["sel"]
    # Spectra and cotangents in the tables' pitch, as the projector makes
    # them.
    r = [fs.pitched_zeros((P, 2, N, F), torch.float32, dev).copy_(
        torch.randn((P, 2, N, F), generator=gen, device=dev))
        for _ in range(2)]
    g = [fs.pitched_zeros((P, T, F), torch.float32, dev).copy_(
        torch.randn((P, T, F), generator=gen, device=dev)) for _ in range(2)]
    # Library yardstick: one complex einsum on complex copies of the same
    # inputs, the plane select as a one-hot factor (the transpose as
    # conj(sum_t H conj(g))).
    Hc = torch.complex(H[0].float(), H[1].float())
    onehot = torch.cat([1.0 - sel, sel], dim=-1).to(Hc.dtype)  # [PT, T, 2]
    rc = torch.complex(*r).reshape(P // PT, PT, 2, N, F)
    gcc = torch.complex(*g).conj().resolve_conj().reshape(P // PT, PT, T, F)
    out = {}
    for name, kern, ref, args, lib in (
            ("filter_sum_sel", fs.filter_sum_sel, fs.filter_sum_sel_ref,
             (*r, *H, sel),
             lambda: torch.einsum("kponf,pto,ptnf->kptf", rc, onehot, Hc)),
            ("filter_sum_sel_t", fs.filter_sum_sel_t,
             fs.filter_sum_sel_t_ref, (*g, *H, sel),
             lambda: torch.einsum("kptf,pto,ptnf->kponf", gcc, onehot, Hc))):
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures, note="[512^2/8]", library=lib)
        _stream_checks(torch, name, kern, args, got, out[name]["ms"],
                       failures, "[512^2/8]")
        del got
    del Hc, onehot, rc, gcc, r, g
    torch.cuda.empty_cache()
    out.update({f"p512_{k}": v for k, v in _grouped_checks(
        torch, dev, problems["fft_grouped"].fft_tables, P, gen, failures,
        "[512^2/8]").items()})

    # K17/K18 on the problem's evaluation coordinates and scales.
    pc, s = tp["p"], tp["s"][..., None]
    Np = tp["Cre"].shape[-1]
    D = pc.shape[-1]
    prof = torch.randn((P, T, Np), generator=gen, device=dev)
    ob = torch.randn((P, T, D), generator=gen, device=dev)
    # Library yardsticks: grid_sample, 1-D linear with zero padding
    # (align_corners: x = -1 is v = 0, x = 1 is v = Np - 1), times s for
    # K17; for K18 its input gradient (grid_sample's backward, bilinear =
    # 0, zeros = 0) at s * ob.
    x = (2.0 * pc / (Np - 1) - 1.0).repeat(P // PT, 1, 1)
    grid = torch.stack([x, torch.zeros_like(x)], -1).reshape(P * T, 1, D, 2)
    s_b = s.repeat(P // PT, 1, 1)
    img = prof.reshape(P * T, 1, 1, Np)
    for name, kern, ref, args, lib in (
            ("hat_eval", he.hat_eval, he.hat_eval_ref, (prof, pc, s),
             lambda: fn.grid_sample(img, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=True
                                    ).reshape(P, T, D) * s_b),
            ("hat_eval_t", he.hat_eval_t, he.hat_eval_t_ref,
             (ob, pc, s, Np),
             lambda: torch.ops.aten.grid_sampler_2d_backward(
                 (ob * s_b).reshape(P * T, 1, 1, D), img, grid, 0, 0, True,
                 [True, False])[0].reshape(P, T, Np))):
        got, out[name] = _compare(torch, name, kern, ref, args, HAT_RTOL,
                                  failures, note="[512^2/8]", library=lib)
        bitwise = _check_repeat(torch, name, kern, args, got, failures)
        lib_err = None if lib is None else float((lib() - got[0]).abs().max())
        # Device time alone (the host's dispatch of one call is most of a
        # single call's ms at these sizes), of the kernel and of the
        # library call with its input preparation.
        cost = _call_cost(torch, lambda: kern(*args))
        lib_dev_ms = _device_ms(torch, lib)[0]
        print(f"kernels: {name} bitwise_repeat={bitwise} PB={P} PT={PT} T={T} "
              f"D={D} Np={Np} library_max_abs_err={lib_err} {cost} "
              f"library_device_ms={lib_dev_ms}", flush=True)
    _hat_nan_check(torch, he, prof, pc, s, ob, failures)
    del prof, ob, grid, img, x
    torch.cuda.empty_cache()

    # Apply pairs: both 512^2 modes, and fft_pallas at 256^2/8 with its tail
    # materialized (below the threshold) and through K17/K18.
    geo = problems["fft_pallas"].cfg.geometry
    im = torch.randn((P, N, N), generator=gen, device=dev)
    for mode, fwd, adj in (
            ("fft_pallas", radon_fft.project_nodes_merged,
             radon_fft.backproject_nodes_merged),
            ("fft_grouped", radon_fft.project_nodes_grouped,
             radon_fft.backproject_nodes_grouped)):
        t = problems[mode].fft_tables
        out[f"p512_{mode}_apply_pair_ms"] = ms = _pair_ms(torch, fwd, adj,
                                                          geo, t, im)
        print(f"p512_kernels: mode={mode} apply_pair_ms={ms} (project + "
              f"backproject, bf16 tables, P={P} N={N} T={T}, hat tail "
              f"{'K17/K18' if radon_fft._hat_on_the_fly(t) else 'einsum'})",
              flush=True)
    cfg = _bench_cfg("bfloat16")
    geo = cfg.geometry
    a, v, _ = radon.node_angles(geo)
    t = loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), "fft_pallas")
    im = torch.randn((P, geo.N, geo.N), generator=gen, device=dev)
    # K11/K12 on these tables: the spectra of im, and the cotangents the
    # tail's transpose makes of seeded sinogram cotangents.
    g256 = radon_fft._eval_tail_t(
        torch.randn((P, t["p"].shape[1], t["p"].shape[2]), generator=gen,
                    device=dev), t)
    for name, kern, ref, args in (
            ("filter_sum_sel", fs.filter_sum_sel, fs.filter_sum_sel_ref,
             (*radon_fft._plane_spectra(im, t), t["Hre"], t["Him"],
              t["sel"])),
            ("filter_sum_sel_t", fs.filter_sum_sel_t,
             fs.filter_sum_sel_t_ref, (*g256, t["Hre"], t["Him"], t["sel"]))):
        got, out[f"p256_{name}"] = _compare(torch, name, kern, ref, args,
                                            KERNEL_RTOL, failures,
                                            note="[256^2/8]")
        _stream_checks(torch, name, kern, args, got,
                       out[f"p256_{name}"]["ms"], failures, "[256^2/8]")
        del got
    # A mesh rank's node slice of the tables (mesh.slice_tables, as --mesh
    # runs it) keeps their pitch: the operators on the slice, through
    # K11/K12 and (fft_grouped's tables) K13/K14, against the whole
    # batch's on those nodes.
    from dip_admm_tpu_torch.parallel import mesh

    half = slice(P // 2, P)
    sino = torch.randn((P, t["p"].shape[1], t["p"].shape[2]), generator=gen,
                       device=dev)
    tg = loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), "fft_grouped")
    for mode, tm, H, fwd, adj in (
            ("fft_pallas", t, "Hre", radon_fft.project_nodes_merged,
             radon_fft.backproject_nodes_merged),
            ("fft_grouped", tg, "Hre_g", radon_fft.project_nodes_grouped,
             radon_fft.backproject_nodes_grouped)):
        ts = mesh.slice_tables(tm, P, half)
        for what, op, x in (("project", fwd, im), ("backproject", adj, sino)):
            got, want = op(geo, x[half], ts), op(geo, x, tm)[half]
            rel = float((got - want).abs().max()) / float(want.abs().max())
            ok = bool(torch.isfinite(got).all()) and rel <= NODE_SLICE_RTOL
            if not ok:
                failures.append(f"{mode} {what} on a node slice: rel err "
                                f"{rel}")
            print(f"p512_kernels: mode={mode} N={geo.N} node_slice={what} "
                  f"nodes={half.start}:{half.stop} pitch={ts[H].stride(-2)} "
                  f"max_rel_err={rel} ok={ok}", flush=True)
        del ts
    del tg, sino
    _cli_mesh_check(failures)
    limit = radon_fft._HAT_MAX_BYTES
    for tail, lim in (("einsum", limit), ("K17/K18", 0)):
        radon_fft._HAT_MAX_BYTES = lim
        try:
            ms = _pair_ms(torch, radon_fft.project_nodes_merged,
                          radon_fft.backproject_nodes_merged, geo, t, im)
        finally:
            radon_fft._HAT_MAX_BYTES = limit
        out[f"p256_pallas_{tail}_apply_pair_ms"] = ms
        print(f"p512_kernels: mode=fft_pallas N={geo.N} apply_pair_ms={ms} "
              f"(bf16 tables, P={P}, hat tail {tail})", flush=True)
    del t, im, g256
    torch.cuda.empty_cache()
    return out


def _cli_mesh_check(failures) -> None:
    """``--mesh 2 --mode fft_grouped`` through the CLI at a small size (two
    ranks sharing the card, each on its node slice of the grouped tables)
    beside the same run on one device: both finite, mean PSNR within
    ``MESH_PSNR_TOL``."""
    argv = [sys.executable, "-m", "dip_admm_tpu_torch.runners.cli",
            "--device", "cuda", "--mode", "fft_grouped", "--N", "128",
            "--nodes", "4", "--max-iters", "3", "--fft-table-dtype",
            "bfloat16"]
    psnr = {}
    for tag, extra in (("single", []), ("mesh_2", ["--mesh", "2"])):
        t0 = time.perf_counter()
        run = subprocess.run(argv + extra, capture_output=True, text=True,
                             timeout=600)
        text = run.stdout
        start = text.rfind("\n{\n") + 1 if "\n{\n" in text else 0
        try:
            psnr[tag] = next(iter(json.loads(text[start:]).values()))[
                "mean_psnr"]
        except (ValueError, KeyError, StopIteration):
            psnr[tag] = math.nan
            print(run.stderr[-2000:], file=sys.stderr)
        print(f"p512_kernels: cli mode=fft_grouped N=128 nodes=4 {tag} "
              f"rc={run.returncode} mean_psnr={psnr[tag]} "
              f"s={time.perf_counter() - t0}", flush=True)
    ok = (all(math.isfinite(x) for x in psnr.values())
          and abs(psnr["single"] - psnr["mesh_2"]) <= MESH_PSNR_TOL)
    if not ok:
        failures.append(f"cli --mesh 2 --mode fft_grouped: {psnr}")


def phase_p512_adjoint(torch, dev, failures) -> None:
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon, radon_fft

    gen = torch.Generator(device=dev).manual_seed(6)
    pairs = {"fft_pallas": (radon_fft.project_nodes_merged,
                            radon_fft.backproject_nodes_merged),
             "fft_grouped": (radon_fft.project_nodes_grouped,
                             radon_fft.backproject_nodes_grouped)}
    for N, mode in ((256, "fft_pallas"), (512, "fft_pallas"),
                    (512, "fft_grouped")):
        cfg = _bench_cfg("float32", N=N)
        geo = cfg.geometry
        a, v, _ = radon.node_angles(geo)
        t = loader.build_fft_tables(
            cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
            torch.as_tensor(v, device=dev), mode)
        P, m = geo.num_nodes, a.shape[1]
        x = torch.randn((P, geo.N, geo.N), generator=gen, device=dev)
        y = torch.randn((P, m, geo.n_det), generator=gen, device=dev)
        fwd, adj = pairs[mode]
        _reset_counts()
        rel = _adjoint_rel(torch, lambda u: fwd(geo, u, t),
                           lambda u: adj(geo, u, t), x, y)
        hat = {k: _counts()[k] for k in HAT}
        tail = "K17/K18" if radon_fft._hat_on_the_fly(t) else "einsum"
        ok = (math.isfinite(rel) and rel <= ADJOINT_TOL
              and all(hat.values()) == (tail == "K17/K18"))
        if not ok:
            failures.append(f"p512_adjoint {mode} {geo.N}: rel {rel}, {hat}")
        print(f"p512_adjoint: {mode} N={geo.N} tail={tail} rel_err={rel} "
              f"hat_launches={json.dumps(hat)} ok={ok}", flush=True)
        del t, x, y
        torch.cuda.empty_cache()


def phase_p512_runs(torch, cfg, problems, failures) -> dict:
    from dip_admm_tpu_torch.core import node_solver

    rec = _recommended(cfg.admm)
    counts = {}
    for mode, kernels in (("fft_pallas", PALLAS + HAT),
                          ("fft_grouped", GROUPED + HAT)):
        problem = problems[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp = node_solver.build_fourier_precond(
            problem.forward, problem.adjoint, torch.sum(problem.Q, dim=1),
            rec.rho, rec.node, problem.N)
        step = fp.step.cpu().numpy()
        precond_s = time.perf_counter() - t0
        tag = f"p512_{mode.removeprefix('fft_')}"
        _, counts[mode], line = _drive(torch, problem, rec, REF_512_PSNR, tag,
                                       failures, kernels)
        print(f"{tag}: precond_build_s={precond_s} certified_step="
              f"{step.tolist()} {line}", flush=True)
    return counts


SM_MODES = {
    "fft_shear": ("project_nodes_shear", "backproject_nodes_shear"),
    "fft_mxu": ("project_nodes_mxu", "backproject_nodes_mxu"),
}


def _sm_pair(mode):
    from dip_admm_tpu_torch.ops import radon_fft

    return tuple(getattr(radon_fft, f) for f in SM_MODES[mode])


def _tables_at(torch, dev, table_dtype, N, mode):
    """One mode's tables of the bench geometry at N, without a problem."""
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon

    cfg = _bench_cfg(table_dtype, N=N)
    a, v, _ = radon.node_angles(cfg.geometry)
    return cfg, loader.build_fft_tables(
        cfg, torch.as_tensor(a, dtype=torch.float32, device=dev),
        torch.as_tensor(v, device=dev), mode)


def phase_sm_problem(torch, dev):
    from dip_admm_tpu_torch.data import loader

    cfg = _bench_cfg("bfloat16")
    problems = {}
    for mode in SM_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        problems[mode] = loader.build_problem(cfg, dev, mode=mode)
        torch.cuda.synchronize()
        p = problems[mode]
        print(f"sm_problem: mode={mode} build_s={time.perf_counter() - t0} "
              f"table_gib={_table_gib(p.fft_tables)} "
              f"angles={tuple(p.angles.shape)} "
              f"union_edges={int(p.adj.sum()) // 2}", flush=True)
    return cfg, problems


def phase_sm_kernels(torch, dev, problems, failures) -> dict:
    from dip_admm_tpu_torch.ops.kernels import filter_mxu as fm
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    # K7/K8 on the fft_shear problem's tables.
    t = problems["fft_shear"].fft_tables
    P, NB, Tp, D2, nb = t["Wt"].shape
    F = t["SEre"].shape[-1]
    for name, kern, ref, args in _shear_cases(torch, dev, t, P, gen):
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures, note="[256^2/8]")
        _shear_checks(torch, kern, args, got, failures, "[256^2/8]")
        print(f"kernels: {name} PB={P} NB={NB} Tp={Tp} D2={D2} nb={nb} F={F} "
              f"Wt={t['Wt'].dtype} TFLOP_per_s="
              f"{sum(_work(name, args, got)[1:]) / out[name]['ms'] / 1e9}",
              flush=True)
        del got, args

    # K15/K16 on the fft_mxu problem's tables; the library yardstick is one
    # complex einsum on the untiled table (the transpose as
    # conj(sum_t H conj(g))).
    t = problems["fft_mxu"].fft_tables
    H = (t["Hre_t"], t["Him_t"])
    PT, FB, NBt, Tp, L = H[0].shape
    TB = t["onehot"].shape[1]
    tt, N, Fpad = Tp // TB, NBt * L // 128, FB * 128
    r = [torch.randn((P, TB, N, Fpad), generator=gen, device=dev)
         for _ in range(2)]
    g = [torch.randn((P, Tp, Fpad), generator=gen, device=dev)
         for _ in range(2)]
    Hc = torch.complex(fm.untile_table(H[0]).float(),
                       fm.untile_table(H[1]).float()).reshape(
        PT, TB, tt, N, Fpad)
    rc = torch.complex(*r).reshape(P // PT, PT, TB, N, Fpad)
    gcc = torch.complex(*g).conj().resolve_conj().reshape(P // PT, PT, TB,
                                                         tt, Fpad)
    for name, kern, ref, args, lib in (
            ("filter_sum_mxu", fm.filter_sum_mxu, fm.filter_sum_mxu_ref,
             (*r, *H), lambda: torch.einsum("kpbnf,pbtnf->kpbtf", rc, Hc)),
            ("filter_sum_mxu_t", fm.filter_sum_mxu_t, fm.filter_sum_mxu_t_ref,
             (*g, *H, TB),
             lambda: torch.einsum("kpbtf,pbtnf->kpbnf", gcc, Hc))):
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures, note="[256^2/8]", library=lib)
        bitwise = _check_repeat(torch, name, kern, args, got, failures)
        print(f"kernels: {name} bitwise_repeat={bitwise} PB={P} PT={PT} "
              f"TB={TB} Tp={Tp} N={N} Fpad={Fpad} H={H[0].dtype} GB_per_s="
              f"{_work(name, args, got)[0] / out[name]['ms'] / 1e6}",
              flush=True)
        del got
    del Hc, rc, gcc, r, g
    torch.cuda.empty_cache()

    # Apply pairs: both modes at 256^2/8 on the problems' tables, and at
    # 512^2/8 from their tables alone.
    geo = problems["fft_shear"].cfg.geometry
    im = torch.randn((P, geo.N, geo.N), generator=gen, device=dev)
    for mode in SM_MODES:
        fwd, adj = _sm_pair(mode)
        out[f"p256_{mode}_apply_pair_ms"] = ms = _pair_ms(
            torch, fwd, adj, geo, problems[mode].fft_tables, im)
        print(f"sm_kernels: mode={mode} N={geo.N} apply_pair_ms={ms} "
              f"(project + backproject, bf16 tables, P={P})", flush=True)
    for mode in SM_MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cfg, t = _tables_at(torch, dev, "bfloat16", 512, mode)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        geo = cfg.geometry
        im = torch.randn((P, geo.N, geo.N), generator=gen, device=dev)
        if mode == "fft_shear":
            out.update(_eval_p512_checks(torch, dev, t, P, gen, failures))
            note = f"[512^2/8 NB={t['Wt'].shape[1]}]"
            for name, kern, ref, args in _shear_cases(torch, dev, t, P, gen):
                got, out[f"p512_{name}"] = _compare(
                    torch, name, kern, ref, args, KERNEL_RTOL, failures,
                    note=note)
                _shear_checks(torch, kern, args, got, failures, note)
                del got, args
        fwd, adj = _sm_pair(mode)
        out[f"p512_{mode}_apply_pair_ms"] = ms = _pair_ms(torch, fwd, adj,
                                                          geo, t, im)
        print(f"sm_kernels: mode={mode} N={geo.N} apply_pair_ms={ms} "
              f"(bf16 tables, P={P}) table_build_s={build_s} "
              f"table_gib={_table_gib(t)}", flush=True)
        del t, im
        torch.cuda.empty_cache()
    return out


def phase_sm_adjoint(torch, dev, failures) -> None:
    gen = torch.Generator(device=dev).manual_seed(12)
    for mode in SM_MODES:
        cfg, t = _tables_at(torch, dev, "float32", 256, mode)
        geo = cfg.geometry
        P, m = geo.num_nodes, max(geo.angles_per_node())
        x = torch.randn((P, geo.N, geo.N), generator=gen, device=dev)
        y = torch.randn((P, m, geo.n_det), generator=gen, device=dev)
        fwd, adj = _sm_pair(mode)
        rel = _adjoint_rel(torch, lambda u: fwd(geo, u, t),
                           lambda u: adj(geo, u, t), x, y)
        ok = math.isfinite(rel) and rel <= ADJOINT_TOL
        if not ok:
            failures.append(f"sm_adjoint {mode}: rel {rel}")
        print(f"sm_adjoint: {mode} N={geo.N} rel_err={rel} ok={ok}",
              flush=True)
        del t, x, y
        torch.cuda.empty_cache()


def phase_sm_runs(torch, cfg, problems, failures) -> dict:
    from dip_admm_tpu_torch.core import node_solver

    rec = _recommended(cfg.admm)
    counts = {}
    for mode, kernels in (("fft_shear", SHEAR), ("fft_mxu", MXU)):
        problem = problems[mode]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fp = node_solver.build_fourier_precond(
            problem.forward, problem.adjoint, torch.sum(problem.Q, dim=1),
            rec.rho, rec.node, problem.N)
        step = fp.step.cpu().numpy()
        precond_s = time.perf_counter() - t0
        tag = f"sm_{mode.removeprefix('fft_')}"
        _, counts[mode], line = _drive(torch, problem, rec, REF_REC_PSNR, tag,
                                       failures, kernels)
        if mode == "fft_shear" and any(counts[mode][k] for k in SKEW[:2]):
            failures.append(f"{tag}: the skew row stage K1/K2 launched")
        print(f"{tag}: precond_build_s={precond_s} certified_step="
              f"{step.tolist()} {line}", flush=True)
    return counts


def phase_stages(torch, dev, failures) -> tuple[dict, dict]:
    """The stages of ``scripts/bench_shear_stages.py`` at 256^2/8 with bf16
    tables: the fft_shear pipeline on gathered slot spectra (plane spectra,
    one-hot select, K9, the eval tail K3 and their transposes K4, K10) and
    the skew row stages K1, K2 and K6 (two row shards). The pipeline runs
    once with the counts zeroed (the path of K9/K10); then K9/K10 against
    their plain versions, K9 against K7 on the gathered spectra (bit for
    bit) and K10 summed back over the one-hot against K8, and each stage's
    time. Returns (kernel numbers, the path's counts)."""
    from dip_admm_tpu_torch.ops import radon_fft
    from dip_admm_tpu_torch.ops.kernels import filter_mxu
    from dip_admm_tpu_torch.ops.kernels import shear_sum as ss

    cfg, ts = _tables_at(torch, dev, "bfloat16", 256, "fft_shear")
    _, tk = _tables_at(torch, dev, "bfloat16", 256, "fft_skew")
    geo = cfg.geometry
    P, N, T = geo.num_nodes, geo.N, max(geo.angles_per_node())
    sh, shk = ts["shared"], tk["shared"]
    plane = ts["plane"]
    TB = plane.shape[1]
    pidx = torch.arange(P, device=dev)[:, None]
    tabs = (ts["Wt"], ts["SEre"], ts["SEim"], sh["Phire"], sh["Phiim"])
    gen = torch.Generator(device=dev).manual_seed(13)
    imgs = torch.randn((P, N, N), generator=gen, device=dev)

    def spectra():
        return [v.contiguous() for v in radon_fft._plane_spectra(imgs, ts)]

    def select(r2):
        return [v[pidx, plane.long()].contiguous() for v in r2]

    def tail(g):
        out = ss.eval_shear(*g, ts["Wd"], ts["TEre"], ts["TEim"],
                            sh["PhiDre"], sh["PhiDim"])
        return filter_mxu.permute_rows(out, ts["posfull"])[:, :T]

    def tail_t(sino):
        ob = radon_fft._pad_unpermute(sino, ts).contiguous()
        return ss.eval_shear_t(ob, ts["Wd"], ts["TEre"], ts["TEim"],
                               sh["PhiDre"], sh["PhiDim"])

    # The path once: forward through K9, back through K10.
    torch.cuda.synchronize()
    _reset_counts()
    r2 = spectra()
    r_s = select(r2)
    g = ss.shear_sum(*r_s, *tabs)
    sino = tail(g)
    g_bar = tail_t(sino)
    rs_bar = ss.shear_sum_t(*g_bar, *tabs, TB)
    torch.cuda.synchronize()
    counts = _counts()
    if not (counts["shear_sum"] == counts["shear_sum_t"] == 1):
        failures.append(f"stages: K9/K10 launches {counts}")

    out = {}
    for name, kern, ref, args in (
            ("shear_sum", ss.shear_sum, ss.shear_sum_ref, (*r_s, *tabs)),
            ("shear_sum_t", ss.shear_sum_t, ss.shear_sum_t_ref,
             (*g_bar, *tabs, TB))):
        got, out[name] = _compare(torch, name, kern, ref, args, KERNEL_RTOL,
                                  failures, note="[256^2/8]")
        bitwise = _check_repeat(torch, name, kern, args, got, failures)
        print(f"kernels: {name} bitwise_repeat={bitwise} PB={P} TB={TB} "
              f"Wt={ts['Wt'].dtype}", flush=True)
    k7 = ss.shear_sum_planes(*r2, *tabs, plane)
    k9_is_k7 = all(torch.equal(a, b) for a, b in zip(g, k7))
    onehot = torch.nn.functional.one_hot(plane.long(), 2).float()
    k8 = ss.shear_sum_planes_t(*g_bar, *tabs, plane)
    k10_rel = max(float((torch.einsum("ptnf,pto->ponf", a, onehot) - b)
                        .abs().max() / b.abs().max())
                  for a, b in zip(rs_bar, k8))
    if not k9_is_k7 or k10_rel > KERNEL_RTOL:
        failures.append(f"stages: K9 equals K7 {k9_is_k7}, K10 summed over "
                        f"the one-hot against K8 {k10_rel}")
    print(f"stages: k9_equals_k7_on_gathered={k9_is_k7} "
          f"k10_onehot_sum_vs_k8_rel_err={k10_rel}", flush=True)
    del k7, k8

    rows2 = torch.stack([imgs, imgs.transpose(1, 2)], dim=1).contiguous()
    skew_t = (*g, tk["WtT"], tk["SEre"], tk["SEim"], shk["DreT"],
              shk["DimT"], tk["plane"])
    NB = tk["WtT"].shape[1]

    def skew_rows_t():  # K6 on each row shard, as the pixel shards run it
        return [ss.skew_sum_planes_t_rows(
            *g, *(tk[k][:, b:b + 1].contiguous()
                  for k in ("WtT", "SEre", "SEim")),
            shk["DreT"], shk["DimT"], tk["plane"], N) for b in range(NB)]

    stages = (
        ("plane_spectra", spectra),
        ("onehot_select", lambda: select(r2)),
        ("shear_sum K9", lambda: ss.shear_sum(*r_s, *tabs)),
        ("permute+eval_tail K3", lambda: tail(g)),
        ("FULL forward shear", lambda: radon_fft.project_nodes_shear(
            geo, imgs, ts)),
        ("eval_tail_t K4", lambda: tail_t(sino)),
        ("shear_sum_t K10", lambda: ss.shear_sum_t(*g_bar, *tabs, TB)),
        ("FULL adjoint shear", lambda: radon_fft.backproject_nodes_shear(
            geo, sino, ts)),
        ("skew row stage K1", lambda: ss.skew_sum_planes(
            rows2, tk["WtT"], tk["SEre"], tk["SEim"], shk["Dre"], shk["Dim"],
            tk["plane"])),
        ("skew row stage T K2", lambda: ss.skew_sum_planes_t(*skew_t)),
        (f"skew row stage T K6 x{NB} shards", skew_rows_t),
        ("FULL forward skew", lambda: radon_fft.project_nodes_skew(
            geo, imgs, tk)),
        ("FULL adjoint skew", lambda: radon_fft.backproject_nodes_skew(
            geo, sino, tk)),
    )
    for name, fn in stages:
        print(f"stages: {name} ms={_time_ms(torch, fn)}", flush=True)
    del ts, tk
    torch.cuda.empty_cache()
    return out, counts


def _dense_cfg(N=64, nodes=5, phantom="const", **admm_over):
    """The reference flagship's configuration (the package defaults: 64^2,
    5 nodes, const phantom, cv at <= 200 inner, 200 outers with the 1e-3
    stop), resized and with loop fields replaced."""
    from dip_admm_tpu_torch.config import GeometryConfig, ProblemConfig

    base = ProblemConfig()
    return dataclasses.replace(
        base, geometry=GeometryConfig(N=N, num_nodes=nodes), phantom=phantom,
        admm=dataclasses.replace(base.admm, **admm_over))


def _build_timed(torch, cfg, dev, **kw):
    """(problem, build seconds, peak GiB of the build)."""
    from dip_admm_tpu_torch.data import loader

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    problem = loader.build_problem(cfg, dev, **kw)
    torch.cuda.synchronize()
    return (problem, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def _pair_line(torch, problem, gen) -> tuple[float, str]:
    """The apply pair's ms (fwd + adj, median of 20 after 3 warm-ups) on a
    seeded image batch, and its bound: A's bytes twice over the card's
    memory rate (the dense pair reads A once each way)."""
    x = torch.randn((problem.num_nodes, problem.n), generator=gen,
                    device=problem.device)
    ms = _time_ms(torch, lambda: problem.adjoint(problem.forward(x)))
    a_bytes = problem.num_nodes * problem.m_flat * problem.n * 4
    bound = 1e3 * 2 * a_bytes / HBM_BYTES_PER_S
    return ms, (f"pair_ms={ms} pair_bound_ms={bound} "
                f"pair_share_of_bound={bound / ms}")


def _dense_drive(torch, problem, admm_cfg, tag, failures, ref_psnr=None,
                 lanczos_v0=None):
    """``run_admm`` with the counters zeroed just before and read just
    after: finite residuals, the image shapes, a mean PSNR within
    ``PSNR_TOL`` of ``ref_psnr`` (when given), K5 once per outer where
    its auto rule puts it on (>= 8 nodes) and never elsewhere, and no
    projector kernel (the dense and Joseph pairs are plain torch).
    Returns (result, counts, mean PSNR, line)."""
    from dip_admm_tpu_torch.core import admm

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = admm.run_admm(problem, admm_cfg, lanczos_v0=lanczos_v0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()
    n = res.n_iters
    pri = float(res.history["primal"][n - 1])
    dual = float(res.history["dual"][n - 1])
    inner = res.history["inner_iters"][:n].float().mean().item()
    x = res.x.float().cpu().numpy()  # numpy has no bfloat16
    mean_psnr = _mean_psnr(x, problem.x_true.float().cpu().numpy())
    use_k5 = admm_cfg.use_pallas
    if use_k5 is None:  # run_admm's auto rule
        use_k5 = problem.device.type == "cuda" and problem.num_nodes >= 8
    k5 = n if use_k5 else 0
    checks = {
        "shape": x.shape == (problem.num_nodes, problem.n),
        "finite": bool(np.isfinite(x).all()) and math.isfinite(pri)
        and math.isfinite(dual),
        "psnr": ref_psnr is None or abs(mean_psnr - ref_psnr) <= PSNR_TOL,
        "k5": counts["consensus_update"] == k5,
        "no_projector_kernel": all(v == 0 for k, v in counts.items()
                                   if k != "consensus_update"),
    }
    for k, ok in checks.items():
        if not ok:
            failures.append(f"{tag} check {k} failed")
    line = (f"mode={problem.mode} run_s={run_s} outer_iters={n} "
            f"outer_it_per_s={n / run_s} mean_inner_iters={inner} "
            f"final_primal={pri} final_dual={dual} mean_psnr={mean_psnr} "
            f"ref_psnr={ref_psnr} k5_launches={counts['consensus_update']} "
            f"ok={all(checks.values())}")
    return res, counts, mean_psnr, line


def phase_dense_flagship(torch, dev, failures) -> tuple[dict, object]:
    """The reference flagship on the card: mode=None must resolve to
    dense; 200 outers of cv with the 1e-3 stop."""
    cfg = _dense_cfg()
    problem, build_s, _ = _build_timed(torch, cfg, dev)
    if problem.mode != "dense":
        failures.append(f"dense_flagship: mode=None gave {problem.mode}")
    gen = torch.Generator(device=dev).manual_seed(1)
    _, pair = _pair_line(torch, problem, gen)
    res, counts, _, line = _dense_drive(torch, problem, cfg.admm,
                                        "dense_flagship", failures,
                                        REF_DENSE_PSNR)
    stopped = res.n_iters if res.state.stop else None
    print(f"dense_flagship: N=64 nodes=5 build_s={build_s} "
          f"A_gib={_nbytes(problem.A) / 2**30} {pair} {line} "
          f"stopped_at_outer={stopped}", flush=True)
    return counts, problem


def _max_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def phase_dense_joseph(torch, dev, failures) -> list:
    """Dense against Joseph at 64^2/5, parallel and fan: one operator."""
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops import radon

    counts = []
    for fan in (False, True):
        cfg = _dense_cfg(max_iters=3)
        cfg = dataclasses.replace(cfg, geometry=dataclasses.replace(
            cfg.geometry, fan_beam=fan))
        tag = "fan" if fan else "parallel"
        t0 = time.perf_counter()
        pd = loader.build_problem(cfg, dev, mode="dense")
        pj = loader.build_problem(cfg, dev, mode="joseph")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn((pd.num_nodes, pd.n), generator=gen, device=dev)
        y = torch.randn((pd.num_nodes, pd.m_flat), generator=gen,
                        device=dev)
        y = y * pd.angle_valid.repeat_interleave(cfg.geometry.n_det, 1)
        errs = {
            "b": _max_rel(pj.b, pd.b), "W": _max_rel(pj.W, pd.W),
            "opnorm": _max_rel(pj.opnorm, pd.opnorm),
            "fwd": _max_rel(pj.forward(x), pd.forward(x)),
            "adj": _max_rel(pj.adjoint(y), pd.adjoint(y)),
        }
        adj_rel = {m: _adjoint_rel(torch, p.forward, p.adjoint, x, y)
                   for m, p in (("dense", pd), ("joseph", pj))}
        t2 = radon.joseph_tables(cfg.geometry, pj.angles, pj.angle_valid)
        bitwise = (torch.equal(pj.adjoint(y), pj.adjoint(y))
                   and torch.equal(radon.colnorms_sq_nodes(pj.fft_tables),
                                   radon.colnorms_sq_nodes(t2)))
        ms = {m: _pair_line(torch, p, gen)[0]
              for m, p in (("dense", pd), ("joseph", pj))}
        runs = {}
        for m, p in (("dense", pd), ("joseph", pj)):
            res, c, psnr, _ = _dense_drive(torch, p, cfg.admm,
                                           f"dense_joseph {tag} {m}",
                                           failures)
            runs[m] = (res, psnr)
            counts.append(c)
        x_rel = _max_rel(runs["joseph"][0].x, runs["dense"][0].x)
        ok = (all(v <= DENSE_JOSEPH_RTOL for v in errs.values())
              and all(v <= ADJOINT_TOL for v in adj_rel.values())
              and bitwise and x_rel <= DENSE_JOSEPH_X_RTOL)
        if not ok:
            failures.append(f"dense_joseph {tag}: errs={errs} "
                            f"adjoint={adj_rel} bitwise={bitwise} "
                            f"x_rel={x_rel}")
        print(f"dense_joseph: {tag} build_s={build_s} "
              f"rel_err={json.dumps(errs)} adjoint_rel={json.dumps(adj_rel)} "
              f"joseph_bitwise_repeat={bitwise} pair_ms={json.dumps(ms)} "
              f"three_outers_x_rel={x_rel} psnr_dense={runs['dense'][1]} "
              f"psnr_joseph={runs['joseph'][1]} ok={ok}", flush=True)
        del pd, pj, t2
    torch.cuda.empty_cache()
    return counts


def phase_dense_128(torch, dev, failures) -> list:
    """128^2/5 (Shepp-Logan, BASELINE configs 1-2's size), the top of the
    auto rule: the dense build and pair against its bound, and 20
    recommended outers on dense and on Joseph, one operator."""
    cfg = _dense_cfg(N=128, phantom="shepp", max_iters=20, eps_pri=0.0,
                     eps_dual=0.0)
    rec = _recommended(cfg.admm)
    gen = torch.Generator(device=dev).manual_seed(3)
    counts, psnr, lines = [], {}, []
    for mode in ("dense", "joseph"):
        problem, build_s, peak = _build_timed(
            torch, cfg, dev, **({} if mode == "dense" else {"mode": mode}))
        if mode == "dense" and problem.mode != "dense":
            failures.append(f"dense_128: mode=None gave {problem.mode}")
        _, pair = _pair_line(torch, problem, gen)
        _, c, psnr[mode], line = _dense_drive(torch, problem, rec,
                                              f"dense_128 {mode}", failures)
        counts.append(c)
        size = (f"A_gib={_nbytes(problem.A) / 2**30}" if mode == "dense"
                else f"tables_gib={_table_gib(problem.fft_tables)}")
        lines.append(f"{mode}: build_s={build_s} {size} build_peak_gib={peak} "
                     f"{pair} {line}")
        del problem
        torch.cuda.empty_cache()
    ok = abs(psnr["dense"] - psnr["joseph"]) <= DENSE_JOSEPH_PSNR_TOL
    if not ok:
        failures.append(f"dense_128: PSNRs {psnr}")
    print("dense_128: N=128 nodes=5 " + " | ".join(lines)
          + f" psnr_diff={psnr['dense'] - psnr['joseph']} ok={ok}",
          flush=True)
    return counts


def phase_inner_solvers(torch, problem, failures) -> list:
    """64^2/5 dense, 20 outers at max_inner 50 (no early stop) under each
    inner algorithm, each held to the JAX package's PSNR."""
    counts = []
    base = _dense_cfg(max_iters=20, eps_pri=0.0, eps_dual=0.0).admm
    for alg, ref in REF_INNER_PSNR.items():
        cfg = dataclasses.replace(base, node=dataclasses.replace(
            base.node, algorithm=alg, max_inner=50))
        _, c, _, line = _dense_drive(torch, problem, cfg,
                                     f"inner_solvers {alg}", failures, ref)
        counts.append(c)
        print(f"inner_solvers: {alg} {line}", flush=True)
    return counts


def phase_adapt_rho(torch, dev, failures) -> list:
    """64^2/8 dense (K5 on, under a changing rho): 20 recommended outers
    under each adapt-rho recipe, the rho trajectory beside the JAX run's
    (printed, not compared: the noise draws differ)."""
    counts = []
    base = _dense_cfg(nodes=8, max_iters=20, eps_pri=0.0, eps_dual=0.0)
    problem, build_s, _ = _build_timed(torch, base, dev)
    rec = dataclasses.replace(_recommended(base.admm), adapt_rho=True)
    for tag, over in (("rho20_balance_mu2", dict(rho=20.0, rho_mu=2.0)),
                      ("rho2_stall_w5", dict(adapt_rho_mode="stall",
                                             rho_stall_window=5))):
        ref_psnr, ref_rho = REF_RHO[tag]
        res, c, _, line = _dense_drive(
            torch, problem, dataclasses.replace(rec, **over),
            f"adapt_rho {tag}", failures, ref_psnr)
        counts.append(c)
        rho = res.history["rho"][:res.n_iters].cpu().tolist()
        print(f"adapt_rho: {tag} N=64 nodes=8 build_s={build_s} {line} "
              f"rho={json.dumps(rho)} jax_rho={json.dumps(ref_rho)}",
              flush=True)
    del problem
    torch.cuda.empty_cache()
    return counts


def _cli_default_check(failures) -> None:
    """The CLI on its defaults (auto -> dense at 64^2/5) beside the same
    flags on a one-card gloo mesh of five node ranks: both finite, mean
    PSNR within ``MESH_PSNR_TOL``."""
    argv = [sys.executable, "-m", "dip_admm_tpu_torch.runners.cli",
            "--device", "cuda", "--max-iters", "5"]
    psnr = {}
    for tag, extra in (("single", []), ("mesh_5", ["--mesh", "5"])):
        t0 = time.perf_counter()
        run = subprocess.run(argv + extra, capture_output=True, text=True,
                             timeout=600)
        text = run.stdout
        start = text.rfind("\n{\n") + 1 if "\n{\n" in text else 0
        try:
            psnr[tag] = next(iter(json.loads(text[start:]).values()))[
                "mean_psnr"]
        except (ValueError, KeyError, StopIteration):
            psnr[tag] = math.nan
            print(run.stderr[-2000:], file=sys.stderr)
        print(f"cli_default: --max-iters 5 {' '.join(extra)} "
              f"rc={run.returncode} mean_psnr={psnr[tag]} "
              f"s={time.perf_counter() - t0}", flush=True)
    ok = (all(math.isfinite(x) for x in psnr.values())
          and abs(psnr["single"] - psnr["mesh_5"]) <= MESH_PSNR_TOL)
    if not ok:
        failures.append(f"cli on its defaults, --mesh 5: {psnr}")


def _phase_s(name, t0) -> float:
    """Print a phase's seconds since ``t0``; return now."""
    now = time.perf_counter()
    print(f"{name}: phase_s={now - t0}", flush=True)
    return now


def _path_keep(orders: np.ndarray) -> np.ndarray:
    """keep [P, P, n] of the path along each pixel's node order
    ``orders [n, P]``, built with numpy alone."""
    n, P = orders.shape
    keep = np.zeros((P, P, n), dtype=bool)
    pix = np.arange(n)[:, None]
    keep[orders[:, :-1], orders[:, 1:], pix] = True
    return keep | keep.transpose(1, 0, 2)


def phase_strategies(torch, problem, failures) -> list:
    """The flagship (64^2/5, dense, cv <= 200 inner, 200 outers with the
    1e-3 stop) under mst, chain with JAX's node orders and complete, each
    within ``PSNR_TOL`` of the JAX package's CPU value, and chain with the
    port's own draws (printed): the problem's graph rebuilt for each. The
    masks built on the card must equal the expected ones: the path along
    JAX's orders (numpy) for that chain, the CPU build from the same W for
    the others; the union adjacency must be their union."""
    from dip_admm_tpu_torch.data import loader

    cfg = problem.cfg
    orders_np = np.load(CHAIN_ORDERS).astype(np.int64)
    orders = torch.as_tensor(orders_np)
    W_cpu = problem.W.cpu()
    counts = []
    for tag, strategy, ords in (("mst", "mst", None),
                                ("chain", "chain", orders),
                                ("complete", "complete", None),
                                ("chain_port_draws", "chain", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = dataclasses.replace(cfg.graph, strategy=strategy)
        p = loader.rebuild_graph(problem, g, orders=ords)
        torch.cuda.synchronize()
        graph_s = time.perf_counter() - t0
        if ords is not None:
            want = torch.from_numpy(_path_keep(orders_np))
        else:
            _, want, _ = loader.build_graph_layer(W_cpu, g.q_mode, strategy,
                                                  g.k, g.seed)
        keep = p.keep.cpu()
        masks_equal = (torch.equal(keep, want)
                       and torch.equal(p.adj.cpu(), keep.any(dim=-1)))
        print(f"strategies: {tag} masks_equal_expected={masks_equal} "
              f"differing_pixels={int((keep != want).any(0).any(0).sum())}",
              flush=True)
        if not masks_equal:
            failures.append(f"strategies {tag}: the card's masks or union "
                            "adjacency differ from the expected graph")
        res, c, _, line = _dense_drive(torch, p, cfg.admm,
                                       f"strategies {tag}", failures,
                                       REF_STRATEGY_PSNR.get(tag))
        counts.append(c)
        stopped = res.n_iters if res.state.stop else None
        print(f"strategies: {tag} N=64 nodes=5 graph_s={graph_s} "
              f"union_edges={int(p.adj.sum()) // 2} "
              f"active_ratio={float(p.keep.float().mean())} {line} "
              f"stopped_at_outer={stopped}", flush=True)
    return counts


STRATEGIES_256 = ("mst", "chain", "complete")


def phase_strategies_256(torch, dev, failures):
    """The bench problem (256^2/8, fft_skew, bf16 tables) under mst, chain
    (the port's own draws) and complete: K5 against its plain version on
    each graph's adjacency with the edge state zero off each pixel's mask,
    and 20 recommended outers (K1-K4 must launch, K5 once an outer); the
    PSNR, residuals and union edges printed (no JAX value at this size).
    Returns the runs' counts, K5's numbers by strategy and the problem."""
    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.ops.kernels import consensus as cons

    cfg = _bench_cfg("bfloat16")
    bench, build_s, _ = _build_timed(torch, cfg, dev)
    print(f"strategies_256: build_s={build_s}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    P, n = bench.num_nodes, bench.n
    counts, kern = [], {}
    for strategy in STRATEGIES_256:
        p = loader.rebuild_graph(
            bench, dataclasses.replace(cfg.graph, strategy=strategy))
        on = p.keep.to(torch.float32)  # [P, P, n]
        a, y, z = (torch.randn((P, P, n), generator=gen, device=dev) * on
                   for _ in range(3))
        adjm = p.adj.to(torch.float32)
        _, kern[f"{strategy}_consensus_update"] = _compare(
            torch, "consensus_update", cons.consensus_update,
            cons.consensus_update_ref, (a, y, z, adjm, None, "midpoint"),
            K5_RTOL, failures, note=f"[{strategy}, 256^2/8]")
        del a, y, z, on
        _, c, line = _drive(torch, p, _recommended(cfg.admm), None,
                            f"strategies_256 {strategy}", failures)
        counts.append(c)
        print(f"strategies_256: {strategy} union_edges="
              f"{int(p.adj.sum()) // 2} active_ratio="
              f"{float(p.keep.float().mean())} {line}", flush=True)
        del p
    torch.cuda.empty_cache()
    return counts, kern, bench


def artifact_names(tag: str, P: int) -> set:
    """The files the JAX package's ``run_one_strategy`` writes under its
    ``out_dir`` for a run with a fixed rho (the rho curve is drawn only
    when rho moves)."""
    curves = ("g_norm_per_node", "obj_per_node", "obj_total", "pri_per_node",
              "dual_per_node", "sino_mse_per_node", "sino_mse_total",
              "img_mse_per_node", "img_mse_total")
    arrays = curves + ("primal_hist", "dual_hist", "inner_iters_per_node",
                       "accept_code_per_node", "rho_hist")
    plots = curves + ("g_norm_stats", "residuals")
    return ({"run_parameters.txt",
             f"union_figs/pixel_union_graph_{tag}.png",
             f"union_figs/pixel_union_degree_{tag}.png"}
            | {f"{tag}_node_{i}.{e}" for i in range(P) for e in ("npy", "png")}
            | {f"{tag}_{a}.npy" for a in arrays}
            | {f"{tag}_{p}.png" for p in plots})


def _files(root) -> set:
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, fs in os.walk(root) for f in fs}


def phase_experiment_cli(failures, device="cuda") -> None:
    """``--all-strategies --max-iters 20 --out DIR`` through the CLI on the
    card (the flagship defaults, 64^2/5 dense): it must print mst, chain and
    knn, each ``out_dir`` holding :func:`artifact_names` less the plots it
    names as skipped (no matplotlib)."""
    out = tempfile.mkdtemp(prefix="smoke_cli_")
    try:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "dip_admm_tpu_torch.runners.cli",
             "--device", device, "--all-strategies", "--max-iters", "20",
             "--out", out], capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            res = json.loads(run.stdout[run.stdout.find("{"):])
        except ValueError:
            res = {}
            print(run.stderr[-2000:], file=sys.stderr)
        ok = run.returncode == 0 and list(res) == ["mst", "chain", "knn"]
        for strategy, summary in res.items():
            skipped = set(summary.get("artifacts_skipped", []))
            got = _files(summary["out_dir"])
            want = artifact_names(summary["tag"], 5) - skipped
            same = got == want
            ok = ok and same and math.isfinite(summary["mean_psnr"])
            print(f"experiment_cli: {strategy} mean_psnr="
                  f"{summary['mean_psnr']} final_primal="
                  f"{summary['final_primal']} final_dual="
                  f"{summary['final_dual']} n_iters={summary['n_iters']} "
                  f"files={len(got)} files_as_expected={same} "
                  f"artifacts_skipped={json.dumps(sorted(skipped))}",
                  flush=True)
        print(f"experiment_cli: rc={run.returncode} "
              f"s={time.perf_counter() - t0} ok={ok}", flush=True)
        if not ok:
            failures.append(f"experiment_cli: rc={run.returncode}, "
                            f"strategies {list(res)}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _state_rel(torch, st, ref) -> float:
    """Largest difference of (x, Z, Y) from ``ref``'s, over ``ref``'s
    norm."""
    return max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
               for a, b in ((st.node.x, ref.node.x), (st.Z, ref.Z),
                            (st.Y, ref.Y)))


def phase_checkpoint_resume(torch, bench, failures) -> list:
    """On the bench problem, 20 recommended outers: unsegmented, in
    segments of 5 through ``run_one_strategy`` (a checkpoint after each),
    10 outers then a resume from their checkpoint to 20; both final states
    within ``RESUME_RTOL`` of the unsegmented run's norm (bit for bit is
    expected). Then snapshots every 5 outers (``run_admm_snapshots``):
    iter_0005-iter_0020, each node's .npy and .png."""
    from dip_admm_tpu_torch.core import admm
    from dip_admm_tpu_torch.data import serialization
    from dip_admm_tpu_torch.runners import experiment
    from dip_admm_tpu_torch.utils import artifacts

    cfg = dataclasses.replace(bench.cfg, admm=_recommended(bench.cfg.admm))
    out = tempfile.mkdtemp(prefix="smoke_ckpt_")
    counts = []

    def run(tag, **kw):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        if kw:
            c = dataclasses.replace(cfg, admm=dataclasses.replace(
                cfg.admm, max_iters=kw.pop("max_iters", 20)))
            experiment.run_one_strategy(c, os.path.join(out, tag),
                                        problem=bench, write_artifacts=False,
                                        device=bench.device, **kw)
            state, _ = serialization.load_checkpoint(
                os.path.join(out, tag, "knn_k2", "checkpoint.npz"),
                bench.device)
        else:
            state = admm.run_admm(bench, cfg.admm).state
        torch.cuda.synchronize()
        counts.append(_counts())
        return state, time.perf_counter() - t0

    try:
        whole, whole_s = run("whole")
        seg, seg_s = run("segmented", checkpoint_every=5)
        half, _ = run("half", checkpoint_every=5, max_iters=10)
        resumed, res_s = run("resumed", checkpoint_every=5, resume=os.path.join(
            out, "half", "knn_k2", "checkpoint.npz"))
        rels = {"segmented": _state_rel(torch, seg, whole),
                "resumed": _state_rel(torch, resumed, whole)}
        bitwise = {k: all(torch.equal(a, b) for a, b in (
            (st.node.x, whole.node.x), (st.Z, whole.Z), (st.Y, whole.Y)))
            for k, st in (("segmented", seg), ("resumed", resumed))}
        ok = (half.k == 10 and seg.k == resumed.k == whole.k == 20
              and max(rels.values()) <= RESUME_RTOL)
        if not ok:
            failures.append(f"checkpoint_resume: k {half.k}/{seg.k}/"
                            f"{resumed.k}, rel {rels}")
        print(f"checkpoint_resume: writer={serialization.checkpoint_writer()}"
              f" whole_s={whole_s} segmented_s={seg_s} resumed_10_s={res_s} "
              f"max_rel_diff={json.dumps(rels)} bitwise={json.dumps(bitwise)}"
              f" ok={ok}", flush=True)

        snaps = os.path.join(out, "snapshots")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = admm.run_admm_snapshots(bench, cfg.admm, snapshot_dir=snaps,
                                      snapshot_every=5)
        snap_s = time.perf_counter() - t0
        counts.append(_counts())
        skipped = {os.path.basename(p) for p in artifacts.take_skipped()}
        want = {f"iter_{k:04d}_node_{i}.{e}" for k in (5, 10, 15, 20)
                for i in range(bench.num_nodes) for e in ("npy", "png")}
        got = _files(snaps)
        last = np.load(os.path.join(snaps, "iter_0020_node_0.npy"))
        ok = (got == want - skipped and res.n_iters == 20 and np.array_equal(
            last, res.x[0].reshape(bench.N, bench.N).cpu().numpy()))
        if not ok:
            failures.append("checkpoint_resume: snapshots "
                            f"{sorted(want - got)} missing")
        print(f"checkpoint_resume: snapshots files={len(got)} "
              f"skipped={len(skipped)} s={snap_s} ok={ok}", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return counts


def phase_bundle(torch, bench, failures) -> list:
    """``save_problem`` then ``load_problem`` of the bench problem: three
    recommended outers on the loaded problem equal three on the original
    bit for bit."""
    from dip_admm_tpu_torch.core import admm
    from dip_admm_tpu_torch.data import serialization

    cfg = dataclasses.replace(_recommended(bench.cfg.admm), max_iters=3)
    out = tempfile.mkdtemp(prefix="smoke_bundle_")
    try:
        path = os.path.join(out, "bench.npz")
        t0 = time.perf_counter()
        serialization.save_problem(bench, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = serialization.load_problem(path, bench.device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        counts, states = [], []
        for p in (bench, loaded):
            _reset_counts()
            states.append(admm.run_admm(p, cfg).state)
            torch.cuda.synchronize()
            counts.append(_counts())
        a, b = states
        bitwise = all(torch.equal(u, v) for u, v in (
            (a.node.x, b.node.x), (a.Z, b.Z), (a.Y, b.Y)))
        if not bitwise:
            failures.append("bundle: three outers on the loaded problem "
                            f"differ (rel {_state_rel(torch, b, a)})")
        print(f"bundle: mode={loaded.mode} bytes={size} save_s={save_s} "
              f"load_s={load_s} three_outers_bitwise={bitwise}", flush=True)
        del loaded
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return counts


def batch_noise(s: int, shape) -> np.ndarray:
    """Lane ``s``'s standard-normal noise (numpy, as
    ``scripts/jax_dense_anchors.py`` draws it for the JAX runs)."""
    return np.random.default_rng(BATCH_NOISE_SEED + s).standard_normal(
        shape, dtype=np.float32)


def _timed(torch, fn):
    """(fn(), seconds, launch counts): the counters zeroed just before and
    read just after."""
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _counts()


def _lane_rel(torch, res, s, one) -> float:
    """Largest difference of lane ``s`` of a batched result's (x, Z, Y)
    from a single run's, over the single run's norm."""
    st = res.state
    return max(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
               for a, b in ((st.node.x[s], one.state.node.x),
                            (st.Z[s], one.state.Z), (st.Y[s], one.state.Y)))


def phase_batched_64(torch, dev, failures) -> list:
    """BASELINE config 4: 64 phantoms rand_im(64, seed=s) in one
    ``run_admm_batched`` at 64^2/5 (auto = dense), each sinogram the
    problem's forward of its phantom plus seeded noise; cv at <= 100 inner,
    20 outers, no early stop, K5 on (batched, P = 5). Lanes 0-3 equal a
    batch of those four alone bit for bit, lie within
    ``BATCH_STATE_RTOL`` (relative state) and ``BATCH_PSNR_TOL`` of the
    port's single run of each, and their mean PSNR within ``PSNR_TOL`` of
    JAX's run_admm_batched. The batch run once more with its dense product
    taken lane by lane (each lane a [P, n, 1] product, as a single run
    takes it) must equal the single runs bit for bit (state, inner counts
    and acceptance codes): the batch's grouped solve, its freezes and K5's
    batch axis then add no difference of their own. Prints the
    phantom-iterations/s of the batch beside the single runs'."""
    from dip_admm_tpu_torch.core import admm
    from dip_admm_tpu_torch.ops import phantoms, radon

    base = _dense_cfg()
    cfg = _dense_cfg(max_iters=20, eps_pri=0.0, eps_dual=0.0,
                     use_pallas=True, node=dataclasses.replace(
                         base.admm.node, max_inner=100))
    problem, build_s, _ = _build_timed(torch, cfg, dev)
    P, N, n = problem.num_nodes, problem.N, problem.n
    B, T = BATCH_64, cfg.admm.max_iters
    xs = np.stack([phantoms.rand_im(N, seed=s).astype(np.float32).reshape(-1)
                   for s in range(B)])
    X = torch.as_tensor(xs, device=dev)
    clean = problem.forward(X[:, None, :].expand(B, P, n).reshape(B * P, n))
    clean = clean.reshape(B, P, -1)
    rows = problem.angle_valid.repeat_interleave(N, dim=1).to(torch.float32)
    noise = torch.as_tensor(np.stack([batch_noise(s, tuple(clean.shape[1:]))
                                      for s in range(B)]), device=dev)
    b = clean + (cfg.noise_level * noise) * rows
    res, batch_s, counts = _timed(
        torch, lambda: admm.run_admm_batched(problem, b, X, cfg.admm))
    runs = [counts]
    four, _, c = _timed(
        torch, lambda: admm.run_admm_batched(problem, b[:4], X[:4], cfg.admm))
    runs.append(c)
    pairs = [(res.x, four.x), (res.state.Z, four.state.Z),
             (res.state.Y, four.state.Y),
             *((res.history[k].nan_to_num(-1.0),
                four.history[k].nan_to_num(-1.0)) for k in res.history)]
    four_bitwise = all(torch.equal(u[:4], v) for u, v in pairs)
    rels, single_s, lane_psnr, psnr_diff, first_inner = [], 0.0, [], [], []
    singles = []
    for s in range(4):
        p = dataclasses.replace(problem, b=b[s], x_true=X[s])
        one, sec, c = _timed(torch, lambda: admm.run_admm(p, cfg.admm))
        runs.append(c)
        singles.append(one)
        single_s += sec
        rels.append(_lane_rel(torch, res, s, one))
        lane_psnr.append(_mean_psnr(res.x[s].cpu().numpy(), xs[s]))
        psnr_diff.append(lane_psnr[-1] - _mean_psnr(one.x.cpu().numpy(),
                                                    xs[s]))
        differ = (res.history["inner_iters"][s]
                  != one.history["inner_iters"]).any(dim=1).nonzero()
        first_inner.append(int(differ[0]) if len(differ) else None)
    batched = radon._batch_bmm

    def lane_by_lane(Am, v):
        Pn = Am.shape[0]
        return torch.cat([batched(Am, v[j * Pn:(j + 1) * Pn])
                          for j in range(v.shape[0] // Pn)])

    radon._batch_bmm = lane_by_lane
    try:
        by_lane, _, c = _timed(
            torch, lambda: admm.run_admm_batched(problem, b, X, cfg.admm))
    finally:
        radon._batch_bmm = batched
    runs.append(c)
    by_lane_bitwise = [all(torch.equal(u, v) for u, v in (
        (by_lane.state.node.x[s], one.state.node.x),
        (by_lane.state.Z[s], one.state.Z), (by_lane.state.Y[s], one.state.Y),
        (by_lane.history["inner_iters"][s], one.history["inner_iters"]),
        (by_lane.history["accept_code"][s], one.history["accept_code"])))
        for s, one in enumerate(singles)]
    mean4 = float(np.mean(lane_psnr))
    x = res.x.cpu().numpy()
    checks = {
        "outers": res.n_iters.tolist() == [T] * B,
        "finite": bool(np.isfinite(x).all()),
        "lanes_equal_a_batch_of_them": four_bitwise,
        "product_by_lane_equals_single_runs": all(by_lane_bitwise),
        "lanes_match_single_runs": max(rels) <= BATCH_STATE_RTOL
        and max(map(abs, psnr_diff)) <= BATCH_PSNR_TOL,
        "psnr": abs(mean4 - REF_BATCHED_PSNR) <= PSNR_TOL,
        "k5_once_per_outer": counts["consensus_update"] == T,
        "no_projector_kernel": all(v == 0 for k, v in counts.items()
                                   if k != "consensus_update"),
    }
    for k, ok in checks.items():
        if not ok:
            failures.append(f"batched_64 check {k} failed")
    print(f"batched_64: B={B} N={N} nodes={P} build_s={build_s} "
          f"batch_s={batch_s} phantom_it_per_s={B * T / batch_s} "
          f"single_phantom_it_per_s={4 * T / single_s} "
          f"lanes_0_3_bitwise_batch_of_4={four_bitwise} "
          f"product_by_lane_bitwise_single={json.dumps(by_lane_bitwise)} "
          f"lane_state_rel={json.dumps(rels)} lane_minus_single_db="
          f"{json.dumps(psnr_diff)} first_outer_inner_counts_differ="
          f"{json.dumps(first_inner)} lane_psnr="
          f"{json.dumps(lane_psnr)} mean_psnr_0_3={mean4} "
          f"ref_psnr={REF_BATCHED_PSNR} ref_lanes="
          f"{json.dumps(REF_BATCHED_LANES)} mean_psnr_all="
          f"{float(np.mean([_mean_psnr(x[s], xs[s]) for s in range(B)]))} "
          f"run_launches={json.dumps(counts)} ok={all(checks.values())}",
          flush=True)
    return runs


def phase_batched_256(torch, bench, failures) -> tuple[list, dict]:
    """The bench problem (256^2/8, bf16 fft_skew) under the recommended
    preset, 20 outers, as a batch of four (b, 1.05 b, 1.1 b, 1.15 b, the
    phantom scaled alike): each lane within ``BATCH_256_PSNR_TOL`` of its
    own single run, lane 0 within ``PSNR_TOL`` of 34.19 dB; K5's batched
    form against its plain version at [4, 8, 8, 65536], each lane and
    B = 1 bit-equal to the unbatched call on it; K1-K5 launches and the
    phantom-iterations/s beside the single runs'."""
    from dip_admm_tpu_torch.core import admm
    from dip_admm_tpu_torch.ops.kernels import consensus as cons

    cfg = _recommended(bench.cfg.admm)
    B, T = len(BATCH_256_SCALES), cfg.max_iters
    P, n = bench.num_nodes, bench.n
    gen = torch.Generator(device=bench.device).manual_seed(12)
    a, y, z = (torch.randn((B, P, P, n), generator=gen, device=bench.device)
               for _ in range(3))
    adjm = bench.adj.to(torch.float32)
    args = (a, y, z, adjm, None, "midpoint")
    got, kern = _compare(torch, "consensus_update", cons.consensus_update,
                         cons.consensus_update_ref, args, K5_RTOL, failures,
                         note=f"[batch {B}, 256^2/8]")
    lanes_bitwise = all(
        all(torch.equal(g[s], w) for g, w in zip(
            got, cons.consensus_update(a[s], y[s], z[s], adjm)))
        for s in range(B))
    one = cons.consensus_update(a[:1], y[:1], z[:1], adjm)
    b1_bitwise = all(torch.equal(g[0], w) for g, w in zip(
        one, cons.consensus_update(a[0], y[0], z[0], adjm)))
    k5_cost = _call_cost(torch, lambda: cons.consensus_update(*args),
                         failures, "consensus_update[batch]", 1)
    if not (lanes_bitwise and b1_bitwise):
        failures.append(f"batched K5: lanes bitwise {lanes_bitwise}, "
                        f"B = 1 bitwise {b1_bitwise}")
    print(f"batched_256: consensus_update[batch {B}] lanes_bitwise="
          f"{lanes_bitwise} b1_bitwise_unbatched={b1_bitwise} {k5_cost}",
          flush=True)
    del a, y, z, got, one

    b = torch.stack([s * bench.b for s in BATCH_256_SCALES])
    xt = torch.stack([s * bench.x_true for s in BATCH_256_SCALES])
    res, batch_s, counts = _timed(
        torch, lambda: admm.run_admm_batched(bench, b, xt, cfg))
    runs = [counts]
    single_s, diffs, lane_psnr = 0.0, [], []
    for s in range(B):
        p = dataclasses.replace(bench, b=b[s], x_true=xt[s])
        r, sec, c = _timed(torch, lambda: admm.run_admm(p, cfg))
        runs.append(c)
        single_s += sec
        xtn = xt[s].cpu().numpy()
        lane_psnr.append(_mean_psnr(res.x[s].cpu().numpy(), xtn))
        diffs.append(abs(lane_psnr[-1] - _mean_psnr(r.x.cpu().numpy(), xtn)))
    checks = {
        "outers": res.n_iters.tolist() == [T] * B,
        "finite": bool(torch.isfinite(res.x).all()),
        "lanes_match_single_runs": max(diffs) <= BATCH_PSNR_TOL,
        "psnr_lane0": abs(lane_psnr[0] - REF_REC_PSNR) <= PSNR_TOL,
        "launches": all(counts[k] > 0 for k in SKEW),
        "k5_once_per_outer": counts["consensus_update"] == T,
    }
    for k, ok in checks.items():
        if not ok:
            failures.append(f"batched_256 check {k} failed")
    print(f"batched_256: B={B} batch_s={batch_s} phantom_it_per_s="
          f"{B * T / batch_s} single_phantom_it_per_s={B * T / single_s} "
          f"lane_psnr={json.dumps(lane_psnr)} lane_minus_single_db="
          f"{json.dumps(diffs)} ref_psnr_lane0={REF_REC_PSNR} "
          f"run_launches={json.dumps(counts)} ok={all(checks.values())}",
          flush=True)
    return runs, {"batched_consensus_update": kern}


def _graph_from_problem(torch, problem, dense: bool, lam_tv: float = 0.0):
    """A SnapVX-shaped GraphProblem of ``problem``: node i's A_i (dense) or
    the problem's operators (matrix-free), b_i, diag W_i (dense), lam_tv;
    an edge with Q_ij on each pair of the union graph."""
    from dip_admm_tpu_torch.solvers import graph_problem

    ops = None if dense else (problem.forward, problem.adjoint,
                              problem.opnorm)
    gp = graph_problem.GraphProblem(problem.N, operators=ops,
                                    device=problem.device)
    for i in range(problem.num_nodes):
        if dense:
            gp.add_node(A=problem.A[i], b=problem.b[i],
                        diag_quad=problem.W[i])
        else:
            gp.add_node(b=problem.b[i], lam_tv=lam_tv)
    adj = problem.adj.cpu().numpy()
    for i, j in zip(*np.nonzero(np.triu(adj, 1))):
        gp.add_edge(int(i), int(j), problem.Q[i, j])
    return gp


def phase_solvers(torch, dev, failures) -> list:
    """The alternative solvers on the flagship problem (64^2/5, dense,
    the reference's settings): centralized ridge by Cholesky and by CG on
    ``joseph`` (at ``RIDGE_AGREE_LAM`` agreeing within JAX's own test
    tolerance, atol 2e-2 / rtol 1e-2), centralized TV under cv and fcv, pdhg-consensus at the
    reference defaults under both anchor weightings, and the SnapVX-shaped
    dense GraphProblem (50 outers); each PSNR within ``PSNR_TOL`` of the
    JAX package's on the CPU."""
    from dip_admm_tpu_torch.config import NodeSolverConfig
    from dip_admm_tpu_torch.solvers import centralized, pdhg_consensus

    cfg = _dense_cfg()
    problem, build_s, _ = _build_timed(torch, cfg, dev)
    joseph, jbuild_s, _ = _build_timed(torch, cfg, dev, mode="joseph")
    x_true = problem.x_true.cpu().numpy()
    v0 = torch.as_tensor(np.load(LANCZOS_V0)[f"n{problem.n}"], device=dev)
    lam = cfg.admm.lam_tv
    runs, xs, lines = [], {}, []

    def tv(alg):
        return centralized.tv_reconstruction(
            problem, lam_tv=lam, lanczos_v0=v0, cfg=NodeSolverConfig(
                max_inner=2000, check_every=50, algorithm=alg))[0]

    def pdhg(w):
        return pdhg_consensus.solve(problem, pdhg_consensus.PdhgConsensusConfig(
            anchor_weights=w)).x_nodes

    def graph():
        gp = _graph_from_problem(torch, problem, dense=True)
        x, hist = gp.solve(max_iters=50)
        lines.append(f"graph_problem_dense final_primal={hist['primal'][-1]}"
                     f" primal_first={hist['primal'][0]}")
        return x

    cases = (
        ("ridge_dense", lambda: centralized.ridge_reconstruction(problem)),
        ("ridge_cg_joseph", lambda: centralized.ridge_reconstruction(joseph)),
        ("centralized_tv_cv", lambda: tv("cv")),
        ("centralized_tv_fcv", lambda: tv("fcv")),
        ("pdhg_oracle", lambda: pdhg("oracle")),
        ("pdhg_residual", lambda: pdhg("residual")),
        ("graph_problem_dense", graph),
    )
    for tag, fn in cases:
        x, sec, c = _timed(torch, fn)
        runs.append(c)
        xs[tag] = x
        got = _mean_psnr(x.reshape(-1, problem.n).cpu().numpy(), x_true)
        ok = (bool(torch.isfinite(x).all())
              and abs(got - REF_SOLVER_PSNR[tag]) <= PSNR_TOL
              and all(v == 0 for v in c.values()))
        if not ok:
            failures.append(f"solvers {tag}: psnr {got} against "
                            f"{REF_SOLVER_PSNR[tag]}, launches "
                            f"{ {k: v for k, v in c.items() if v} }")
        print(f"solvers: {tag} s={sec} psnr={got} "
              f"ref_psnr={REF_SOLVER_PSNR[tag]} ok={ok}", flush=True)
    # Cholesky against CG at the JAX test's lam (1e-2) and tolerance: at
    # lam = 1e-3 500 CG steps leave JAX's own pair 0.54 apart at 64^2/5.
    (d, f), sec, c = _timed(torch, lambda: tuple(
        centralized.ridge_reconstruction(p, lam=RIDGE_AGREE_LAM)
        for p in (problem, joseph)))
    runs.append(c)
    agree = bool(torch.all(torch.abs(d - f) <= 2e-2 + 1e-2 * torch.abs(f)))
    if not agree:
        failures.append("solvers: ridge by Cholesky and by CG disagree")
    d3, f3 = xs["ridge_dense"], xs["ridge_cg_joseph"]
    print(f"solvers: build_s={build_s} joseph_build_s={jbuild_s} "
          f"ridge_lam={RIDGE_AGREE_LAM} dense_vs_cg_max_abs="
          f"{float((d - f).abs().max())} agree={agree} s={sec} "
          f"lam_1e-3_dense_vs_cg_max_abs={float((d3 - f3).abs().max())} "
          f"{' '.join(lines)}", flush=True)
    return runs


def phase_solvers_large(torch, dev, bench, failures) -> list:
    """BASELINE config 1, centralized TV under fcv on a 128^2 Shepp-Logan
    (auto = dense) within ``PSNR_TOL`` of JAX's CPU value on Joseph, with
    RESULTS.md's TPU value beside it; then at 256^2/8 bf16 fft_skew (the
    bench problem) centralized TV, 20 pdhg-consensus outers and a
    matrix-free GraphProblem with TV (5 outers, fcv): finite results, the
    GraphProblem's primal residual falling, K1-K4 launching."""
    from dip_admm_tpu_torch.config import NodeSolverConfig
    from dip_admm_tpu_torch.solvers import centralized, pdhg_consensus

    cfg = _dense_cfg(N=128, phantom="shepp")
    p128, build_s, _ = _build_timed(torch, cfg, dev)
    v0 = torch.as_tensor(np.load(LANCZOS_V0)[f"n{p128.n}"], device=dev)
    fcv = NodeSolverConfig(max_inner=2000, check_every=50, algorithm="fcv")
    (x, g), sec, c = _timed(torch, lambda: centralized.tv_reconstruction(
        p128, lam_tv=cfg.admm.lam_tv, cfg=fcv, lanczos_v0=v0))
    runs = [c]
    got = _mean_psnr(x[None].cpu().numpy(), p128.x_true.cpu().numpy())
    ok = (bool(torch.isfinite(x).all())
          and abs(got - REF_TV_128_PSNR) <= PSNR_TOL)
    if not ok:
        failures.append(f"solvers_large: 128^2 centralized TV psnr {got}")
    print(f"solvers_large: centralized_tv_fcv_128 mode={p128.mode} "
          f"build_s={build_s} s={sec} psnr={got} ref_psnr={REF_TV_128_PSNR} "
          f"results_md_tpu_psnr={RESULTS_TV_128_PSNR} final_stationarity="
          f"{float(g)} ok={ok}", flush=True)
    del p128, x
    torch.cuda.empty_cache()

    x_true = bench.x_true.cpu().numpy()

    def graph():
        gp = _graph_from_problem(torch, bench, dense=False,
                                 lam_tv=bench.cfg.admm.lam_tv)
        return gp.solve(max_iters=5, inner=NodeSolverConfig(
            max_inner=200, check_every=25, algorithm="fcv"))

    cases = (
        ("centralized_tv", lambda: centralized.tv_reconstruction(
            bench, lam_tv=bench.cfg.admm.lam_tv)[0]),
        ("pdhg_consensus_20", lambda: pdhg_consensus.solve(
            bench, pdhg_consensus.PdhgConsensusConfig(n_outer=20)).x_nodes),
        ("graph_problem_tv_fcv", graph),
    )
    for tag, fn in cases:
        out, sec, c = _timed(torch, fn)
        runs.append(c)
        extra = ""
        if tag == "graph_problem_tv_fcv":
            out, hist = out
            pri = hist["primal"]
            falls = bool(np.isfinite(pri).all() and pri[-1] < pri[0])
            extra = f"primal={json.dumps(pri.tolist())} primal_falls={falls} "
        else:
            falls = True
        ok = (bool(torch.isfinite(out).all()) and falls
              and all(c[k] > 0 for k in SKEW))
        if not ok:
            failures.append(f"solvers_large {tag}: finite/falling/launches "
                            f"failed ({ {k: c[k] for k in SKEW} })")
        psnr = _mean_psnr(out.reshape(-1, bench.n).cpu().numpy(), x_true)
        print(f"solvers_large: {tag} N=256 nodes=8 s={sec} psnr={psnr} "
              f"{extra}k1_k4_launches="
              f"{json.dumps({k: c[k] for k in SKEW})} ok={ok}", flush=True)
    return runs


# ---------------------------------------------------------------------------
# Phases 35-41: mode fft, fold_eval, segments on a mesh, multihost, the
# problem dtype, the native graph builder
# ---------------------------------------------------------------------------

# JAX package on the CPU, scripts/jax_dense_anchors.py matrix_free: mode
# fft (f32 tables) on a 64^2 Shepp-Logan with 4 nodes, 20 recommended
# outers (JAX's Lanczos start), parallel and fan beam. At the bench size
# mode fft computes fft_skew's operator (f32 tables, exactly), so its runs
# are held to REF_REC_PSNR and REF_FAN_PSNR; the bench size is not run on
# a CPU (its tables and hat weights take several GiB).
REF_MF_64_PSNR = {"parallel": 23.352, "fan": 13.833}
MF_BF16_RTOL = 2e-3  # bf16-table pair against the f32-table pair
FOLD_RTOL = 1e-2  # the folded (bf16 WC) pair against the unfolded pair
MULTIHOST_RTOL = 1e-3  # x, Z, Y against the single-device run
MULTIHOST_OUTERS = 3
SEGMENT_OUTERS, SEGMENT_EVERY = 6, 2
# The JAX package's per-field dtypes of a 64^2/5 dense build (and the
# loop state's) under each problem dtype, without x64.
DTYPE_WANT = {
    "bfloat16": {"angles": "bfloat16", "A": "float32", "b": "float32",
                 "W": "bfloat16", "Q": "bfloat16", "x_true": "bfloat16",
                 "opnorm": "bfloat16", "x": "float32"},
    "float64": {k: "float32" for k in ("angles", "A", "b", "W", "Q",
                                       "x_true", "opnorm", "x")},
}


def _mf_small_cfg(fan: bool):
    """The matrix_free anchors' configuration (REF_MF_64_PSNR)."""
    cfg = _dense_cfg(N=64, nodes=4, phantom="shepp", max_iters=20,
                     eps_pri=0.0, eps_dual=0.0)
    return dataclasses.replace(
        cfg, geometry=dataclasses.replace(cfg.geometry, fan_beam=fan),
        admm=_recommended(cfg.admm))


def _mf_run(torch, dev, fan, failures) -> tuple[dict, object, str]:
    """The bench problem (fan or parallel, 256^2/8) on mode fft with f32
    tables: build, adjoint identity, the apply pair (f32 tables, and bf16
    tables against it), 20 recommended outers; then the 64^2/4 anchor run.
    Returns (counts of the runs, the bench problem, the line)."""
    from dip_admm_tpu_torch.data import loader

    tag = "matrix_free_fan" if fan else "matrix_free"
    cfg = _bench_cfg("float32", fan_beam=fan)
    problem, build_s, peak = _build_timed(torch, cfg, dev, mode="fft")
    gen = torch.Generator(device=dev).manual_seed(35)
    x = torch.randn((problem.num_nodes, problem.n), generator=gen,
                    device=dev)
    y = torch.randn((problem.num_nodes, problem.m_flat), generator=gen,
                    device=dev)
    adj_rel = _adjoint_rel(torch, problem.forward, problem.adjoint, x, y)
    pair_ms = _time_ms(torch, lambda: problem.adjoint(problem.forward(x)))
    gib = _table_gib(problem.fft_tables)
    bound = 1e3 * 2 * gib * 2**30 / HBM_BYTES_PER_S  # the tables, both ways
    t16 = loader.build_fft_tables(
        dataclasses.replace(cfg, fft_table_dtype="bfloat16"), problem.angles,
        problem.angle_valid, "fft")
    fwd16, adj16 = loader.make_node_ops("fft", cfg.geometry, t16)
    ref = problem.adjoint(problem.forward(x))
    bf16_rel = _max_rel(adj16(fwd16(x)), ref)
    pair16_ms = _time_ms(torch, lambda: adj16(fwd16(x)))
    del t16, fwd16, adj16, ref
    torch.cuda.empty_cache()
    checks = {"adjoint": adj_rel <= ADJOINT_TOL,
              "bf16_pair": bf16_rel <= MF_BF16_RTOL}
    for k, ok in checks.items():
        if not ok:
            failures.append(f"{tag} check {k} failed")
    ref_psnr = REF_FAN_PSNR if fan else REF_REC_PSNR
    _, counts, _, line = _dense_drive(torch, problem, _recommended(cfg.admm),
                                      tag, failures, ref_psnr)
    small = _mf_small_cfg(fan)
    p64 = loader.build_problem(small, dev, mode="fft")
    v0 = torch.as_tensor(np.load(LANCZOS_V0)[f"n{p64.n}"], device=dev)
    _, counts64, _, line64 = _dense_drive(
        torch, p64, small.admm, f"{tag}_64", failures,
        REF_MF_64_PSNR["fan" if fan else "parallel"], lanczos_v0=v0)
    print(f"{tag}: N=256 nodes=8 table_dtype=float32 build_s={build_s} "
          f"build_peak_gib={peak} table_gib={gib} pair_ms={pair_ms} "
          f"pair_bound_ms={bound} (the tables' bytes both ways) "
          f"bf16_table_pair_ms={pair16_ms} bf16_pair_rel_diff={bf16_rel} "
          f"adjoint_rel={adj_rel} {line} | 64^2/4 anchor run: {line64} "
          f"ok={all(checks.values())}", flush=True)
    return [counts, counts64], problem


def phase_fold_eval(torch, dev, failures) -> list:
    """256^2/8 fft_grouped with fold_eval (bf16 tables): the WC build,
    both pairs in one call, the folded pair against the unfolded one, the
    adjoint identity with f32 WC tables, and 20 recommended outers (K13/K14
    and K5 launching)."""
    from dip_admm_tpu_torch.ops import radon_fft

    cfg = _bench_cfg("bfloat16")
    geo = cfg.geometry
    problem, build_s, _ = _build_timed(torch, cfg, dev, mode="fft_grouped")
    a, v = problem.angles, problem.angle_valid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    folded = radon_fft.precompute_grouped(geo, a, v, torch.bfloat16,
                                          fold_eval=True)
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t0
    wc_gib = _table_gib({k: folded.get(k) for k in ("WCre", "WCim")})
    fwd = radon_fft.project_nodes_grouped
    adj = radon_fft.backproject_nodes_grouped
    gen = torch.Generator(device=dev).manual_seed(37)
    x = torch.randn((geo.num_nodes, geo.N, geo.N), generator=gen, device=dev)
    plain = problem.fft_tables
    ref = adj(geo, fwd(geo, x, plain), plain)
    _reset_counts()
    got = adj(geo, fwd(geo, x, folded), folded)
    torch.cuda.synchronize()
    pair_counts = _counts()
    fold_rel = _max_rel(got, ref)
    ms = {k: _pair_ms(torch, fwd, adj, geo, t, x)
          for k, t in (("unfolded", plain), ("folded", folded))}
    t32 = radon_fft.precompute_grouped(geo, a, v, torch.float32,
                                       fold_eval=True)
    y = torch.randn((geo.num_nodes, a.shape[1], geo.n_det), generator=gen,
                    device=dev)
    adj_rel = _adjoint_rel(torch, lambda z: fwd(geo, z, t32),
                           lambda z: adj(geo, z, t32), x, y)
    del t32, ref, got
    torch.cuda.empty_cache()
    checks = {
        "wc_built": "WCre" in folded,
        "fold_vs_unfolded": fold_rel <= FOLD_RTOL,
        "adjoint_f32_wc": adj_rel <= ADJOINT_TOL,
        "k13_k14": all(pair_counts[k] == 1 for k in GROUPED),
        "no_hat_kernel": all(pair_counts[k] == 0 for k in HAT),
    }
    for k, ok in checks.items():
        if not ok:
            failures.append(f"fold_eval check {k} failed")
    fp = dataclasses.replace(problem, fft_tables=folded)
    _, counts, line = _drive(torch, fp, _recommended(cfg.admm), REF_REC_PSNR,
                             "fold_eval", failures, kernels=GROUPED)
    print(f"fold_eval: N=256 nodes=8 table_dtype=bfloat16 build_s={build_s} "
          f"wc_build_s={fold_s} wc_gib={wc_gib} "
          f"pair_ms={json.dumps(ms)} fold_rel_diff={fold_rel} "
          f"adjoint_rel_f32_wc={adj_rel} pair_launches="
          f"{json.dumps({k: pair_counts[k] for k in GROUPED + HAT})} {line} "
          f"ok={all(checks.values())}", flush=True)
    return [counts]


def _segments_rank(rank, device, root):
    """One rank of the mesh_segments phase: the bench problem under the
    recommended preset on a 2-node mesh, through ``run_one_strategy``:
    SEGMENT_OUTERS outers checkpointed every SEGMENT_EVERY, the same cut at
    the middle checkpoint and resumed from it, and snapshots every
    SEGMENT_EVERY. Returns the rank's launch counts of those runs."""
    import torch

    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.parallel import mesh as meshlib
    from dip_admm_tpu_torch.runners import experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(device)
    cfg = _bench_cfg("bfloat16")
    cfg = dataclasses.replace(cfg, admm=_recommended(cfg.admm))
    problem = loader.build_problem(cfg, device)
    mesh = meshlib.make_mesh(2, 1, device)
    middle = SEGMENT_OUTERS // 2 // SEGMENT_EVERY * SEGMENT_EVERY

    def run(name, outers, **kw):
        c = dataclasses.replace(cfg, admm=dataclasses.replace(
            cfg.admm, max_iters=outers))
        experiment.run_one_strategy(c, os.path.join(root, name), mesh=mesh,
                                    problem=problem, write_artifacts=False,
                                    device=device, **kw)

    mesh.barrier()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    run("unbroken", SEGMENT_OUTERS, checkpoint_every=SEGMENT_EVERY)
    run("part", middle, checkpoint_every=SEGMENT_EVERY)
    run("resumed", SEGMENT_OUTERS, checkpoint_every=SEGMENT_EVERY,
        resume=os.path.join(root, "part", "knn_k2", "checkpoint.npz"))
    run("snapshots", SEGMENT_OUTERS, snapshot_every=SEGMENT_EVERY)
    torch.cuda.synchronize()
    return {"counts": _counts(), "s": time.perf_counter() - t0,
            "transport": mesh.transport}


def phase_mesh_segments(torch, failures) -> list:
    """``_segments_rank`` on two gloo ranks sharing the card: the resumed
    run's state within RESUME_RTOL of the unbroken mesh run's (rank 0's
    checkpoints, of the gathered state) and the snapshots under the JAX
    package's file names, the last equal to the unbroken run's x."""
    from dip_admm_tpu_torch.data import serialization
    from dip_admm_tpu_torch.parallel import mesh as meshlib

    root = tempfile.mkdtemp(prefix="smoke_mesh_segments_")
    try:
        t0 = time.perf_counter()
        outs = meshlib.launch(_segments_rank, 2, torch.device("cuda", 0),
                              args=(root,))
        wall_s = time.perf_counter() - t0

        def ckpt(name):
            return serialization.load_checkpoint(
                os.path.join(root, name, "knn_k2", "checkpoint.npz"), "cpu")[0]

        whole, part, resumed = (ckpt(n) for n in ("unbroken", "part",
                                                  "resumed"))
        rel = _state_rel(torch, resumed, whole)
        bitwise = all(torch.equal(a, b) for a, b in (
            (resumed.node.x, whole.node.x), (resumed.Z, whole.Z),
            (resumed.Y, whole.Y)))
        snaps = os.path.join(root, "snapshots", "knn_k2", "snapshots")
        P = whole.node.x.shape[0]
        want = {f"iter_{k:04d}_node_{i}.npy"
                for k in range(SEGMENT_EVERY, SEGMENT_OUTERS + 1,
                               SEGMENT_EVERY) for i in range(P)}
        got = {f for f in os.listdir(snaps) if f.endswith(".npy")}
        last = np.stack([np.load(os.path.join(
            snaps, f"iter_{SEGMENT_OUTERS:04d}_node_{i}.npy")).reshape(-1)
            for i in range(P)])
        checks = {
            "k": (whole.k, part.k, resumed.k) == (
                SEGMENT_OUTERS, SEGMENT_OUTERS // 2 // SEGMENT_EVERY
                * SEGMENT_EVERY, SEGMENT_OUTERS),
            "resume": rel <= RESUME_RTOL,
            "snapshot_names": got == want,
            "snapshot_last": np.array_equal(last, whole.node.x.numpy()),
            "k5_sharded": all(o["counts"]["consensus_update_sharded"] > 0
                              for o in outs),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k, ok in checks.items():
        if not ok:
            failures.append(f"mesh_segments check {k} failed")
    print(f"mesh_segments: mesh=2x1 transport={outs[0]['transport']} "
          f"outers={SEGMENT_OUTERS} every={SEGMENT_EVERY} "
          f"rank_run_s={[o['s'] for o in outs]} launch_wall_s={wall_s} "
          f"resumed_rel_diff={rel} bitwise={bitwise} "
          f"snapshot_files={len(got)} rank_launches="
          f"{json.dumps([o['counts'] for o in outs])} "
          f"ok={all(checks.values())}", flush=True)
    return [{k: sum(o["counts"][k] for o in outs) for k in outs[0]["counts"]}]


def _multihost_rank(out: str) -> None:
    """One process of the multihost phase, started with an environment
    rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK):
    ``multihost.initialize``, ``global_mesh`` on the card,
    ``distribute_problem`` of the 256^2/8 mode-fft problem, and
    MULTIHOST_OUTERS outers of the parity contract through
    ``run_admm_sharded``. Writes ``<out>.<rank>.npz``: the rank's launch
    counts and, on rank 0, the gathered x, Z and Y."""
    import torch

    from dip_admm_tpu_torch.data import loader
    from dip_admm_tpu_torch.parallel import admm_sharded, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize()
    mesh = multihost.global_mesh(device="cuda:0")
    cfg = _bench_cfg("float32")
    run_cfg = dataclasses.replace(cfg.admm, max_iters=MULTIHOST_OUTERS)
    dp = multihost.distribute_problem(
        loader.build_problem(cfg, mesh.device, mode="fft"), mesh)
    torch.cuda.empty_cache()
    mesh.barrier()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = admm_sharded.run_admm_sharded(dp, run_cfg, mesh)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()
    full = admm_sharded.gather_result(res, mesh)
    arrays = {"x": full.x.cpu().numpy(), "Z": full.state.Z.cpu().numpy(),
              "Y": full.state.Y.cpu().numpy()} if mesh.rank == 0 else {}
    np.savez(f"{out}.{mesh.rank}.npz", counts=json.dumps(counts),
             run_s=run_s, transport=mesh.transport,
             node_block=np.asarray(dp.node_block), **arrays)
    torch.distributed.destroy_process_group()


def phase_multihost(torch, problem, failures) -> list:
    """Two processes joined by an environment rendezvous on 127.0.0.1
    (``_multihost_rank``), against MULTIHOST_OUTERS outers of the same
    mode-fft problem on one device (``problem``, built alike)."""
    import socket

    from dip_admm_tpu_torch.core import admm

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="smoke_multihost_")
    out = os.path.join(tmp, "rank")
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "WORLD_SIZE": "2", "PYTHONPATH": here}
    code = "import sys, chip_smoke; chip_smoke._multihost_rank(sys.argv[1])"
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, out], cwd=here,
                              env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    try:
        if any(p.returncode for p in procs):
            failures.append("multihost: a rank failed: " + " | ".join(
                err[-2000:] for _, err in logs))
            return []
        ranks = [np.load(f"{out}.{r}.npz") for r in range(2)]
        counts = [json.loads(str(z["counts"])) for z in ranks]
        ref = admm.run_admm(problem, dataclasses.replace(
            problem.cfg.admm, max_iters=MULTIHOST_OUTERS))
        rels = {k: _rel(ranks[0][k], v.cpu().numpy()) for k, v in (
            ("x", ref.x), ("Z", ref.state.Z), ("Y", ref.state.Y))}
        checks = {
            "state": max(rels.values()) <= MULTIHOST_RTOL,
            "blocks": [tuple(z["node_block"]) for z in ranks] == [(0, 4),
                                                                  (4, 8)],
            "k5_sharded": all(c["consensus_update_sharded"]
                              == MULTIHOST_OUTERS for c in counts),
        }
        for k, ok in checks.items():
            if not ok:
                failures.append(f"multihost check {k} failed")
        print(f"multihost: processes=2 rendezvous=env(127.0.0.1:{port}) "
              f"transport={ranks[0]['transport']} mode=fft N=256 nodes=8 "
              f"outers={MULTIHOST_OUTERS} rank_run_s="
              f"{[float(z['run_s']) for z in ranks]} wall_s={wall_s} "
              f"state_rel_diff={json.dumps(rels)} "
              f"rank_launches={json.dumps(counts)} "
              f"ok={all(checks.values())}", flush=True)
        return [{k: sum(c[k] for c in counts) for k in counts[0]}]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_dtype(torch, dev, failures) -> list:
    """64^2/5 dense (auto), 5 outers, under the problem dtypes bfloat16 and
    float64: each field's dtype and the loop state's the JAX package's
    (DTYPE_WANT), the results finite. Then bfloat16 on fft_skew at 64^2/8:
    b and the loop state in bfloat16, K1-K4 and K5 (which take float32,
    cast at their wrappers) launching."""
    from dip_admm_tpu_torch.core import admm

    counts = []
    for name, want in DTYPE_WANT.items():
        cfg = dataclasses.replace(_dense_cfg(max_iters=5), dtype=name)
        problem, build_s, _ = _build_timed(torch, cfg, dev)
        res, c, _, line = _dense_drive(torch, problem, cfg.admm,
                                       f"dtype_{name}", failures)
        counts.append(c)
        got = {k: str(getattr(problem, k).dtype).replace("torch.", "")
               for k in want if k != "x"}
        got["x"] = str(res.x.dtype).replace("torch.", "")
        ok = got == want and problem.mode == "dense"
        if not ok:
            failures.append(f"dtype_{name}: dtypes {got}, want {want}")
        print(f"dtype: dtype={name} N=64 nodes=5 build_s={build_s} "
              f"dtypes={json.dumps(got)} {line} dtypes_ok={ok}", flush=True)
    cfg = dataclasses.replace(_dense_cfg(nodes=8, max_iters=5),
                              dtype="bfloat16")
    problem = _build_timed(torch, cfg, dev, mode="fft_skew")[0]
    torch.cuda.synchronize()
    _reset_counts()
    res = admm.run_admm(problem, cfg.admm)
    torch.cuda.synchronize()
    counts.append(_counts())
    x = res.x.float().cpu().numpy()
    psnr = _mean_psnr(x, problem.x_true.float().cpu().numpy())
    ok = (problem.b.dtype == res.x.dtype == torch.bfloat16
          and bool(np.isfinite(x).all())
          and all(counts[-1][k] > 0 for k in SKEW)
          and counts[-1]["consensus_update"] == res.n_iters)
    if not ok:
        failures.append("dtype: bfloat16 fft_skew run")
    print(f"dtype: dtype=bfloat16 mode=fft_skew N=64 nodes=8 "
          f"b={problem.b.dtype} x={res.x.dtype} outers={res.n_iters} "
          f"mean_psnr={psnr} run_launches={json.dumps(counts[-1])} ok={ok}",
          flush=True)
    return counts


def phase_native_graphs(torch, dev, W, failures) -> None:
    """The native graph builder on the host at 256^2/8 (n = 65536), knn
    k = 2 and mst, on the mode-fft bench problem's column norms: masks
    equal to the torch build's on the card."""
    from dip_admm_tpu_torch.graph import native, precisions, topology

    t0 = time.perf_counter()
    built = native.available()
    build_s = time.perf_counter() - t0
    if not built:
        failures.append("native_graphs: the builder does not build (g++, "
                        "OpenMP)")
        return
    q = precisions.pairwise_q(torch.as_tensor(W, device=dev), "arithmetic")
    line = []
    for strategy, k in (("knn", 2), ("mst", 0)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep_t = topology.build_pixel_masks(q, strategy=strategy, k=k)
        torch.cuda.synchronize()
        torch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        keep_n = native.build_pixel_masks_native(q, strategy=strategy, k=k)
        native_s = time.perf_counter() - t0
        ok = np.array_equal(keep_n, keep_t.cpu().numpy())
        if not ok:
            failures.append(f"native_graphs: {strategy} masks differ")
        line.append(f"{strategy}: native_s={native_s} torch_card_s={torch_s}"
                    f" equal={ok}")
    print(f"native_graphs: n={W.shape[1]} nodes={W.shape[0]} "
          f"threads={native.num_threads()} build_s={build_s} "
          f"{' '.join(line)}", flush=True)


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


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
    phase_build()
    cfg, problem = phase_problem(torch, dev)
    kern = phase_kernels(torch, dev, problem, failures)
    phase_adjoint(torch, dev, failures)
    main_counts = phase_main(torch, cfg, problem, failures)
    rec_counts, rec_psnr = phase_recommended(torch, cfg, problem, failures)
    mesh_counts = _mesh_run(torch, "mesh_bench", False, 2, 2, REF_REC_PSNR,
                            failures, single=(rec_psnr, problem))
    del problem
    torch.cuda.empty_cache()
    mesh_fan_counts = _mesh_run(torch, "mesh_fan", True, 1, 2, REF_FAN_PSNR,
                                failures)
    fan_cfg, fan_problems = phase_fan_problem(torch, dev)
    kern.update({f"fan_{k}" if k in SKEW else k: v for k, v in
                 phase_fan_kernels(torch, dev, fan_problems, failures).items()})
    phase_fan_adjoint(torch, dev, failures)
    fan_counts = phase_fan_runs(torch, fan_cfg, fan_problems, failures)
    del fan_problems
    torch.cuda.empty_cache()
    p512_cfg, p512_problems = phase_p512_problem(torch, dev)
    kern.update(phase_p512_kernels(torch, dev, p512_problems, failures))
    phase_p512_adjoint(torch, dev, failures)
    p512_counts = phase_p512_runs(torch, p512_cfg, p512_problems, failures)
    del p512_problems
    torch.cuda.empty_cache()
    sm_cfg, sm_problems = phase_sm_problem(torch, dev)
    kern.update(phase_sm_kernels(torch, dev, sm_problems, failures))
    phase_sm_adjoint(torch, dev, failures)
    sm_counts = phase_sm_runs(torch, sm_cfg, sm_problems, failures)
    del sm_problems
    torch.cuda.empty_cache()
    stage_kern, stage_counts = phase_stages(torch, dev, failures)
    kern.update(stage_kern)
    t_dense = time.perf_counter()
    flagship_counts, flagship = phase_dense_flagship(torch, dev, failures)
    inner_counts = phase_inner_solvers(torch, flagship, failures)
    t_new = time.perf_counter()
    strategy_counts = phase_strategies(torch, flagship, failures)
    t_new = _phase_s("strategies", t_new)
    del flagship
    torch.cuda.empty_cache()
    dense_counts = (phase_dense_joseph(torch, dev, failures)
                    + phase_dense_128(torch, dev, failures)
                    + phase_adapt_rho(torch, dev, failures))
    _cli_default_check(failures)
    print(f"dense_phases: s={time.perf_counter() - t_dense}", flush=True)
    t_new = time.perf_counter()
    s256_counts, s256_kern, bench = phase_strategies_256(torch, dev, failures)
    kern.update(s256_kern)
    t_new = _phase_s("strategies_256", t_new)
    phase_experiment_cli(failures)
    t_new = _phase_s("experiment_cli", t_new)
    resume_counts = phase_checkpoint_resume(torch, bench, failures)
    t_new = _phase_s("checkpoint_resume", t_new)
    bundle_counts = phase_bundle(torch, bench, failures)
    t_new = _phase_s("bundle", t_new)
    batch64_counts = phase_batched_64(torch, dev, failures)
    t_new = _phase_s("batched_64", t_new)
    batch256_counts, batch_kern = phase_batched_256(torch, bench, failures)
    kern.update(batch_kern)
    t_new = _phase_s("batched_256", t_new)
    solver_counts = phase_solvers(torch, dev, failures)
    t_new = _phase_s("solvers", t_new)
    large_counts = phase_solvers_large(torch, dev, bench, failures)
    t_new = _phase_s("solvers_large", t_new)
    del bench
    torch.cuda.empty_cache()
    mf_counts, mf_problem = _mf_run(torch, dev, False, failures)
    t_new = _phase_s("matrix_free", t_new)
    host_counts = phase_multihost(torch, mf_problem, failures)
    t_new = _phase_s("multihost", t_new)
    W_bench = mf_problem.W.cpu().numpy()
    del mf_problem
    torch.cuda.empty_cache()
    mf_fan_counts, _ = _mf_run(torch, dev, True, failures)
    t_new = _phase_s("matrix_free_fan", t_new)
    torch.cuda.empty_cache()
    fold_counts = phase_fold_eval(torch, dev, failures)
    t_new = _phase_s("fold_eval", t_new)
    torch.cuda.empty_cache()
    segment_counts = phase_mesh_segments(torch, failures)
    t_new = _phase_s("mesh_segments", t_new)
    dtype_counts = phase_dtype(torch, dev, failures)
    t_new = _phase_s("dtype", t_new)
    phase_native_graphs(torch, dev, W_bench, failures)
    _phase_s("native_graphs", t_new)
    runs = (main_counts, rec_counts, mesh_counts, mesh_fan_counts,
            *fan_counts.values(), *p512_counts.values(), *sm_counts.values(),
            stage_counts, flagship_counts, *inner_counts, *dense_counts,
            *strategy_counts, *s256_counts, *resume_counts, *bundle_counts,
            *batch64_counts, *batch256_counts, *solver_counts,
            *large_counts, *mf_counts, *host_counts, *mf_fan_counts,
            *fold_counts, *segment_counts, *dtype_counts)
    launches = {name: sum(c[name] for c in runs) for name in REPLACES}
    failures += [f"kernel {name} launched in none of the runs"
                 for name, n in launches.items() if n == 0]
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name],
         "launches": launches[name],
         "max_abs_err": max(kern[k]["max_abs_err"] for k in (
             name, f"fan_{name}", f"rows_{name}", f"fan_rows_{name}",
             f"block_{name}", f"p512_{name}", f"p256_{name}",
             f"batched_{name}",
             *(f"{g}_{name}" for g in STRATEGIES_256)) if k in kern),
         **{k: kern[name][k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}}
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
