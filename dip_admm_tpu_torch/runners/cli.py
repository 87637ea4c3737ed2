"""Command-line interface of the port.

    python -m dip_admm_tpu_torch.runners.cli --device cuda --N 256 --nodes 8 \\
        --phantom shepp --fft-table-dtype bfloat16 --max-iters 20 \\
        --recommended [--fan-beam] [--mode fft_grouped]
    python -m dip_admm_tpu_torch.runners.cli --device cuda --all-strategies \\
        --out runs/strategies
    python -m dip_admm_tpu_torch.runners.cli --device cpu --mesh 2 \\
        --mesh-pixel 2 --N 32 --nodes 4 --max-iters 2
    python -m dip_admm_tpu_torch.runners.cli --device cuda \\
        --solver {pdhg-consensus,centralized,centralized-tv}

Builds the problem (projector mode ``dense``, ``joseph``, ``fft``,
``fft_skew`` or ``fft_grouped``, parallel or fan beam, or ``fft_shear``,
``fft_pallas`` or ``fft_mxu``, parallel beam; by default the JAX package's
rule, ``dense`` at N <= 128 and ``fft_skew`` above; ``--matrix-free``
forces ``fft``; ``--dtype`` is the problem dtype) or loads one
(``--load-problem``), runs
decentralized consensus ADMM under the ``--strategy`` graph, or mst, chain
and knn in turn (``--all-strategies``), writes the JAX package's artifacts
under ``--out`` (default ``Recon_Out_ADMM_<date>_<time>``), one directory
per strategy, and prints the JSON summary the JAX CLI prints
(``{strategy: {tag, n_iters, final_primal, final_dual, mean_psnr, graph,
out_dir}}``, and ``artifacts_skipped`` where matplotlib is missing).
``--solver`` runs one of the alternative solvers instead, as the JAX CLI
does: ``pdhg-consensus`` (the penalized-consensus PDHG solver,
``--pdhg-outer``, ``--pdhg-lam``, ``--pdhg-gamma``, ``--anchor-weights``),
``centralized`` (aggregate ridge least squares, ``--ridge-lam``) or
``centralized-tv`` (aggregate TV least squares at ``--lam-tv``), and prints
``{solver: summary}`` with the JAX CLI's keys. It
takes the subset of the JAX CLI's flags that the port implements; any
other flag or value is rejected. ``--device`` has no default, and
``--device cuda`` on a host without a GPU is an error.

``--mesh N [--mesh-pixel K]`` runs the loop on an N x K node x pixel mesh
(``parallel/admm_sharded.py``): the CLI starts the N*K ranks itself
(``torch.multiprocessing``, spawn), each builds the problem on
``--device``, and rank 0's gathered result gives the same summary and
writes the artifacts. On a host with a card per rank they talk over NCCL,
each on its own card; otherwise over gloo, every rank on ``--device`` (on a
one-card host the ranks share the card and their collectives pass through
host memory). Snapshots and checkpoints work on a mesh too: rank 0 writes
them from the gathered state, and on ``--resume`` every rank takes its
blocks of the checkpoint.
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("--device", required=True,
                   help="torch device to run on, e.g. 'cuda' or 'cpu'")
    p.add_argument("--N", type=int, default=64)
    p.add_argument("--nodes", type=int, default=5)
    p.add_argument("--angles", type=int, default=None)
    p.add_argument("--fan-beam", action="store_true",
                   help="flat-detector fan beam over [0, 2 pi), projected by "
                        "rebinning to a shared parallel stage")
    p.add_argument("--strategy", choices=["knn", "mst", "chain", "complete"],
                   default="knn",
                   help="per-pixel graph: knn (k nearest by precision, "
                        "reconnected by the maximum spanning tree), mst, "
                        "chain (a random node order per pixel, drawn from "
                        "--seed; not the JAX package's draw) or complete")
    p.add_argument("--k", type=int, default=2)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--q-mode", choices=["arithmetic", "harmonic"],
                   default="arithmetic")
    p.add_argument("--lam-tv", type=float, default=0.02)
    p.add_argument("--rho", type=float, default=2.0)
    p.add_argument("--max-iters", type=int, default=200)
    p.add_argument("--eps-pri", type=float, default=1e-3)
    p.add_argument("--eps-dual", type=float, default=1e-3)
    p.add_argument("--max-inner", type=int, default=None,
                   help="inner iteration budget per node solve (default 200; "
                        "15 under --recommended)")
    p.add_argument("--algorithm",
                   choices=["cv", "fcv", "pcv", "ppdhg", "fista"],
                   default="cv",
                   help="inner node solver: cv = Condat-Vu, fcv = Condat-Vu "
                        "in a circulant Fourier metric with a "
                        "Lanczos-certified step, pcv = Condat-Vu with "
                        "per-pixel (Jacobi) steps, ppdhg = diagonally "
                        "preconditioned PDHG, fista = accelerated proximal "
                        "gradient with a Chambolle TV prox")
    p.add_argument("--check-every", type=int, default=None,
                   help="inner iterations between stationarity checks "
                        "(default 10; 15 under --recommended)")
    p.add_argument("--eps0", type=float, default=2.0,
                   help="inexactness schedule eps_k = eps0/(k+1)^(1+gamma)")
    p.add_argument("--plateau-tol", type=float, default=0.01,
                   help="stop the inner loop when no node's stationarity "
                        "residual improves by this relative amount between "
                        "checks (0 disables)")
    p.add_argument("--eps-rel", type=float, default=0.0,
                   help="widen the acceptance target to "
                        "eps_rel*||A_i^T b_i||/(k+1)^(1+gamma) per node "
                        "(0 = the absolute eps0 schedule only)")
    p.add_argument("--z-fusion", choices=["midpoint", "weighted"],
                   default="midpoint")
    p.add_argument("--relax-alpha", type=float, default=1.0,
                   help="ADMM over-relaxation factor (1.0 = reference)")
    p.add_argument("--adapt-rho", action="store_true",
                   help="adapt rho after each outer (the scaled duals "
                        "rescaled, the scale clamped to [1/64, 64]); "
                        "e.g. '--rho 20 --adapt-rho --rho-mu 2'")
    p.add_argument("--rho-mu", type=float, default=10.0,
                   help="balance: the residual ratio that changes rho")
    p.add_argument("--rho-tau", type=float, default=2.0,
                   help="the factor of one rho change")
    p.add_argument("--rho-mode", choices=["balance", "stall"],
                   default="balance",
                   help="balance = raise rho when the primal residual "
                        "dominates the dual by --rho-mu, lower it the other "
                        "way round; stall = raise rho by --rho-tau whenever "
                        "the primal residual fell by less than "
                        "--rho-stall-tol over --rho-stall-window outers")
    p.add_argument("--rho-stall-window", type=int, default=10)
    p.add_argument("--rho-stall-tol", type=float, default=0.02)
    p.add_argument("--recommended", action="store_true",
                   help="the recommended operating point: fcv, "
                        "over-relaxation 1.8 and a 15-iteration inner budget "
                        "checked once; explicit flags win over it")
    p.add_argument("--noise", type=float, default=0.005)
    p.add_argument("--phantom", choices=["const", "rand", "shepp"],
                   default="const")
    p.add_argument("--fft-table-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the projector tables")
    p.add_argument("--dtype",
                   choices=["float32", "float64", "bfloat16", "float16"],
                   default="float32",
                   help="problem dtype, with the JAX package's per-field "
                        "result (float64 runs in float32; mode fft takes "
                        "float32 only)")
    p.add_argument("--matrix-free", action="store_true",
                   help="force the matrix-free projector (mode fft) where "
                        "--mode is auto")
    p.add_argument("--mode",
                   choices=["auto", "dense", "joseph", "fft", "fft_skew",
                            "fft_grouped", "fft_pallas", "fft_shear",
                            "fft_mxu"],
                   default="auto",
                   help="projector (auto = the JAX package's rule: dense at "
                        "N <= 128, fft_skew above, parallel and fan beam; "
                        "joseph is the matrix-free form of dense; fft is "
                        "the split-table projector of torch FFTs, no "
                        "kernel; fft_pallas, fft_shear and fft_mxu are "
                        "parallel beam only)")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard the nodes over this many ranks")
    p.add_argument("--mesh-pixel", type=int, default=1,
                   help="also shard the [P, P, n] edge state (and, for "
                        "fft_skew, the projector's row blocks) over this "
                        "many ranks along the pixel axis (ranks = --mesh * "
                        "--mesh-pixel)")
    p.add_argument("--out", default=None,
                   help="artifact root (default Recon_Out_ADMM_<date>_<time>)")
    p.add_argument("--all-strategies", action="store_true",
                   help="run mst, chain and knn in turn on the same data")
    p.add_argument("--snapshot-every", type=int, default=None,
                   help="write every node's image every K outers to "
                        "<out>/<tag>/snapshots")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="run in K-outer segments, queueing the loop state to "
                        "<out>/<tag>/checkpoint.npz after each")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="continue from a checkpoint.npz of either package "
                        "(with --checkpoint-every)")
    p.add_argument("--save-problem", default=None, metavar="NPZ",
                   help="write the built problem (operators, data, graph, "
                        "tables) to this bundle, which either package loads")
    p.add_argument("--load-problem", default=None, metavar="NPZ",
                   help="load a bundle of either package instead of building; "
                        "a different --strategy/--k rebuilds only the graph")
    p.add_argument("--per-node-phantoms", action="store_true",
                   help="each node measures its own random phantom")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run here")
    p.add_argument("--use-pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="fused edge-consensus kernel (default: auto, on a "
                        "CUDA device with >= 8 nodes)")
    p.add_argument("--solver",
                   choices=["admm", "pdhg-consensus", "centralized",
                            "centralized-tv"],
                   default="admm",
                   help="admm = decentralized consensus ADMM; "
                        "pdhg-consensus = penalized-consensus PDHG (the "
                        "reference's legacy solver); centralized = aggregate "
                        "ridge least squares; centralized-tv = aggregate "
                        "TV least squares")
    p.add_argument("--pdhg-outer", type=int, default=100,
                   help="pdhg-consensus outer iterations")
    p.add_argument("--pdhg-lam", type=float, default=0.005,
                   help="pdhg-consensus lambda (node and aggregate TV)")
    p.add_argument("--pdhg-gamma", type=float, default=2.0,
                   help="pdhg-consensus quadratic anchor weight")
    p.add_argument("--anchor-weights", choices=["oracle", "residual"],
                   default="oracle",
                   help="pdhg-consensus anchor weighting: oracle = column "
                        "norms over |x_i - x_true|, residual = over the "
                        "node's sinogram residual")
    p.add_argument("--ridge-lam", type=float, default=1e-3,
                   help="centralized ridge regularization")
    return p


def resolve_preset(args) -> None:
    """Fill the preset-dependent flags in place, as the JAX CLI does:
    ``--recommended`` turns cv into fcv, relax 1.0 into 1.8 and unset
    budgets into 15/15; other unset budgets become 200/10."""
    if args.recommended:
        if args.relax_alpha == 1.0:
            args.relax_alpha = 1.8
        if args.algorithm == "cv":
            args.algorithm = "fcv"
        if args.max_inner is None:
            args.max_inner = 15
        if args.check_every is None:
            args.check_every = 15
    if args.max_inner is None:
        args.max_inner = 200
    if args.check_every is None:
        args.check_every = 10


def config_from_args(args):
    from dip_admm_tpu_torch.config import (
        AdmmConfig, GeometryConfig, GraphConfig, NodeSolverConfig,
        ProblemConfig,
    )

    return ProblemConfig(
        geometry=GeometryConfig(N=args.N, num_nodes=args.nodes,
                                angles_total=args.angles,
                                fan_beam=args.fan_beam),
        graph=GraphConfig(strategy=args.strategy, k=args.k, seed=args.seed,
                          q_mode=args.q_mode),
        admm=AdmmConfig(
            lam_tv=args.lam_tv, rho=args.rho, max_iters=args.max_iters,
            eps_pri=args.eps_pri, eps_dual=args.eps_dual,
            z_fusion=args.z_fusion, relax_alpha=args.relax_alpha,
            use_pallas=args.use_pallas, adapt_rho=args.adapt_rho,
            rho_mu=args.rho_mu, rho_tau=args.rho_tau,
            adapt_rho_mode=args.rho_mode,
            rho_stall_window=args.rho_stall_window,
            rho_stall_tol=args.rho_stall_tol,
            node=NodeSolverConfig(
                max_inner=args.max_inner, check_every=args.check_every,
                algorithm=args.algorithm, eps0=args.eps0,
                plateau_tol=args.plateau_tol, eps_rel=args.eps_rel,
            ),
        ),
        noise_level=args.noise,
        phantom=args.phantom,
        dtype=args.dtype,
        fft_table_dtype=args.fft_table_dtype,
    )


def mode_from_args(args) -> str | None:
    """The projector mode (None: ``build_problem``'s rule), as the JAX
    CLI picks it: an explicit ``--mode``, else ``fft`` under
    ``--matrix-free``."""
    if args.mode != "auto":
        return args.mode
    return "fft" if args.matrix_free else None


def _out_root(args) -> str:
    return args.out or (
        f"Recon_Out_ADMM_{datetime.now().strftime('%Y%m%d_%H%M%S')}")


def _run(args, device, out_root, mesh=None) -> dict | None:
    """Build or load the problem on ``device``, run the experiment (on
    ``mesh`` when given) and return the summary (None on ranks other than
    0)."""
    from dip_admm_tpu_torch.data import loader, serialization
    from dip_admm_tpu_torch.runners import experiment
    from dip_admm_tpu_torch.utils import profiling

    cfg = config_from_args(args)
    mode = mode_from_args(args)
    rank0 = mesh is None or mesh.rank == 0
    problem = None
    if args.load_problem:
        problem = serialization.load_problem(args.load_problem, device)
    if args.save_problem:
        if problem is None:
            problem = loader.build_problem(
                cfg, device, mode=mode,
                per_node_phantoms=args.per_node_phantoms)
        if rank0:
            serialization.save_problem(problem, args.save_problem)

    def go():
        if args.solver == "pdhg-consensus":
            return {args.solver: experiment.run_pdhg_consensus(
                cfg, out_root, n_outer=args.pdhg_outer, lam=args.pdhg_lam,
                gamma=args.pdhg_gamma, anchor_weights=args.anchor_weights,
                mode=mode, device=device, problem=problem)}
        if args.solver in ("centralized", "centralized-tv"):
            return {args.solver: experiment.run_centralized(
                cfg, out_root, tv=args.solver == "centralized-tv",
                ridge_lam=args.ridge_lam, mode=mode, device=device,
                problem=problem)}
        if args.all_strategies:
            return experiment.run_all_strategies(
                cfg, out_root, mesh=mesh, mode=mode,
                per_node_phantoms=args.per_node_phantoms, problem=problem,
                device=device)
        _, _, summary = experiment.run_one_strategy(
            cfg, out_root, mesh=mesh, problem=problem, mode=mode,
            per_node_phantoms=args.per_node_phantoms,
            snapshot_every=args.snapshot_every,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            device=device)
        return {args.strategy: summary}

    if args.profile_dir and rank0:
        with profiling.trace(args.profile_dir):
            results = go()
    else:
        results = go()
    return results if rank0 else None


def _rank(rank, device, argv, out_root):
    """One rank of ``--mesh``: its summary on rank 0, else None."""
    from dip_admm_tpu_torch.parallel import mesh as meshlib

    args = build_parser().parse_args(argv)
    resolve_preset(args)
    mesh = meshlib.make_mesh(args.mesh, args.mesh_pixel, device)
    return _run(args, device, out_root, mesh)


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    resolve_preset(args)
    if args.check_every < 1:
        parser.error("--check-every must be >= 1")
    if args.mesh is not None and (args.mesh < 1 or args.mesh_pixel < 1):
        parser.error("--mesh and --mesh-pixel must be >= 1")
    if args.mesh is None and args.mesh_pixel != 1:
        parser.error("--mesh-pixel needs --mesh")
    if args.solver != "admm":
        if args.mesh is not None:
            parser.error(f"--mesh runs the admm solver, not --solver "
                         f"{args.solver}")
        if (args.all_strategies, args.snapshot_every, args.checkpoint_every,
                args.resume) != (False, None, None, None):
            parser.error("--all-strategies, --snapshot-every, "
                         "--checkpoint-every and --resume run the admm "
                         f"solver, not --solver {args.solver}")
    if args.all_strategies and (args.snapshot_every, args.checkpoint_every,
                                args.resume) != (None, None, None):
        parser.error("--snapshot-every, --checkpoint-every and --resume run "
                     "one strategy; they do not go with --all-strategies")
    from dip_admm_tpu_torch.runners import experiment

    try:
        experiment.check_segments(args.snapshot_every,
                                  args.checkpoint_every, args.resume)
    except ValueError as e:
        parser.error(str(e))

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")

    out_root = _out_root(args)
    if args.mesh is None:
        results = _run(args, device, out_root)
    else:
        import sys

        from dip_admm_tpu_torch.parallel import mesh as meshlib

        world = args.mesh * args.mesh_pixel
        argv = sys.argv[1:] if argv is None else list(argv)
        results = meshlib.launch(
            _rank, world, device, args=(argv, out_root),
            threads=max(1, torch.get_num_threads() // world))[0]
    print(json.dumps(results, indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
