"""Command-line interface.

The reference has no CLI/flag system — every knob is a hard-coded constant
(SURVEY §5, ``/root/reference/block_7_main_ver3.py:332-344``). This exposes
the canonical experiment (and the reference defaults) as flags:

    python -m dip_admm_tpu.runners.cli --N 64 --nodes 5 --strategy knn --k 2
    python -m dip_admm_tpu.runners.cli --all-strategies
    python -m dip_admm_tpu.runners.cli --mesh 4   # shard nodes over 4 devices
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--N", type=int, default=64)
    p.add_argument("--nodes", type=int, default=5)
    p.add_argument("--angles", type=int, default=None)
    p.add_argument("--fan-beam", action="store_true")
    p.add_argument("--strategy", choices=["knn", "mst", "chain", "complete"],
                   default="knn")
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
                   help="inner iteration budget per node solve (default 200 "
                        "= the reference's SCS cap; 15 under --recommended)")
    p.add_argument("--algorithm",
                   choices=["cv", "fcv", "pcv", "ppdhg", "fista"],
                   default="cv",
                   help="inner node-solver algorithm (cv = Condat-Vu, "
                        "fcv = circulant/Fourier-metric CV — the CT normal "
                        "operator is near shift-invariant, so a per-node "
                        "Fourier preconditioner matches its spectral decay; "
                        "pcv = SART/Jacobi-preconditioned CV, ppdhg = "
                        "Pock-Chambolle preconditioned PDHG, fista = "
                        "accelerated proximal gradient with Chambolle "
                        "TV prox)")
    p.add_argument("--eps0", type=float, default=2.0,
                   help="inexactness schedule eps_k = eps0/(k+1)^(1+gamma) "
                        "(ref block_6 ver2:100-103)")
    p.add_argument("--check-every", type=int, default=None,
                   help="inner iterations between stationarity checks "
                        "(default 10; 15 under --recommended — one check at "
                        "the 15-inner cap, matching the measured recipe)")
    p.add_argument("--plateau-tol", type=float, default=0.01,
                   help="early-exit when the stationarity residual stops "
                        "improving by this relative amount between checks "
                        "(0 disables)")
    p.add_argument("--eps-rel", type=float, default=None,
                   help="data-scale-relative inexactness: widen the "
                        "acceptance target to eps_rel*||A_i^T b_i||/"
                        "(k+1)^(1+gamma) per node (fires at every problem "
                        "size, unlike the reference's absolute eps0; "
                        "0 = reference-parity absolute-only, the default)")
    p.add_argument("--z-fusion", choices=["midpoint", "weighted"],
                   default="midpoint")
    p.add_argument("--relax-alpha", type=float, default=1.0,
                   help="ADMM over-relaxation factor (1.0 = reference)")
    p.add_argument("--adapt-rho", action="store_true",
                   help="residual balancing (Boyd sec. 3.4.1): rho grows/"
                        "shrinks x--rho-tau when one residual dominates the "
                        "other by x--rho-mu, duals rescaled. For many-node "
                        "fan problems start high and let balancing trim "
                        "(e.g. '--rho 20 --adapt-rho --rho-mu 2')")
    p.add_argument("--rho-mu", type=float, default=10.0,
                   help="residual dominance ratio that triggers a rho step")
    p.add_argument("--rho-tau", type=float, default=2.0,
                   help="multiplicative rho step on trigger")
    p.add_argument("--rho-mode", choices=["balance", "stall"],
                   default="balance",
                   help="adapt-rho policy: balance = classical residual "
                        "ratio; stall = raise rho x--rho-tau whenever the "
                        "primal residual fails to improve by "
                        "--rho-stall-tol over --rho-stall-window outers "
                        "(the quality-signal variant for the many-node fan "
                        "regime, where the dual dominates and balancing "
                        "can only lower rho)")
    p.add_argument("--rho-stall-window", type=int, default=10)
    p.add_argument("--rho-stall-tol", type=float, default=0.02)
    p.add_argument("--recommended", action="store_true",
                   help="recommended operating point: circulant-metric "
                        "inner solver (fcv) + over-relaxation 1.8 + "
                        "15-iteration inner budget (with the "
                        "Lanczos-certified step the preconditioner "
                        "converges the node subproblems in ~15 iterations)")
    p.add_argument("--noise", type=float, default=0.005)
    p.add_argument("--phantom", choices=["const", "rand", "shepp"],
                   default="const")
    p.add_argument("--dtype", default="float32")
    p.add_argument("--out", default=None, help="output root directory")
    p.add_argument("--all-strategies", action="store_true")
    p.add_argument("--mesh", type=int, default=None,
                   help="shard nodes over this many devices")
    p.add_argument("--mesh-pixel", type=int, default=1,
                   help="additionally shard the [P, P, n] edge state over "
                        "this many devices along the pixel axis (total "
                        "devices = --mesh * --mesh-pixel; the HBM-scaling "
                        "axis once the node axis is exhausted)")
    p.add_argument("--matrix-free", action="store_true",
                   help="force the matrix-free projector (mode=fft)")
    p.add_argument("--mode",
                   choices=["auto", "dense", "joseph", "fft", "fft_skew"],
                   default="auto",
                   help="measurement-operator implementation (auto: dense "
                        "for N<=128; above that the matrix-free projector "
                        "measured fastest on the GPU, for parallel and fan "
                        "beam)")
    p.add_argument("--fft-table-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the fft-projector phase tables")
    p.add_argument("--snapshot-every", type=int, default=None,
                   help="write per-node reconstruction snapshots every K "
                        "outer iterations (ref block_6 ver2:269-281)")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="run in K-iteration segments, queueing the full "
                        "loop state to <out>/<tag>/checkpoint.npz on the "
                        "native async packer after each segment (chunked "
                        "orchestrator capability, ref block_6 ver2:269-281)")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a checkpoint.npz written by "
                        "--checkpoint-every (exact continuation)")
    p.add_argument("--save-problem", default=None, metavar="NPZ",
                   help="persist the built problem (operators, data, graph, "
                        "projector tables) to this .npz after building")
    p.add_argument("--load-problem", default=None, metavar="NPZ",
                   help="load a problem saved by --save-problem instead of "
                        "building one (skips tables/colnorms/opnorms — IO "
                        "only); solver flags still apply, and a different "
                        "--strategy/--k rebuilds just the graph layer")
    p.add_argument("--per-node-phantoms", action="store_true",
                   help="each node measures its own randomized phantom "
                        "(build-mode loader parity, ref "
                        "block_2_load_odl_data.py:134-137)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler device trace into this dir")
    # --- solver family (every implemented solver is CLI-reachable; the
    # reference runs its legacy solvers as script entries,
    # ADMM_Tomo_Only.py:89, block_2_test.py:83-88) ---
    p.add_argument("--solver",
                   choices=["admm", "pdhg-consensus", "centralized",
                            "centralized-tv"],
                   default="admm",
                   help="admm = flagship decentralized consensus ADMM; "
                        "pdhg-consensus = legacy penalized-consensus PDHG "
                        "(ref ADMM_Tomo_Only.py); centralized = aggregate "
                        "ridge LS (ref block_2_test.py:83-88); "
                        "centralized-tv = aggregate TV-LS baseline")
    p.add_argument("--pdhg-outer", type=int, default=100,
                   help="pdhg-consensus outer iterations (ref niter=100)")
    p.add_argument("--pdhg-lam", type=float, default=0.005,
                   help="pdhg-consensus lambda penalty (ref :26)")
    p.add_argument("--pdhg-gamma", type=float, default=2.0,
                   help="pdhg-consensus quadratic anchor weight (ref :28)")
    p.add_argument("--anchor-weights", choices=["oracle", "residual"],
                   default="oracle",
                   help="pdhg-consensus anchor weighting (ref :100-113)")
    p.add_argument("--ridge-lam", type=float, default=1e-3,
                   help="centralized ridge regularization")
    return p


def config_from_args(args) -> "ProblemConfig":
    from dip_admm_tpu.config import (
        AdmmConfig,
        GeometryConfig,
        GraphConfig,
        NodeSolverConfig,
        ProblemConfig,
    )

    relax_alpha = getattr(args, "relax_alpha", 1.0)
    algorithm = getattr(args, "algorithm", "cv")
    max_inner = getattr(args, "max_inner", None)
    eps_rel = getattr(args, "eps_rel", None)
    check_every = getattr(args, "check_every", None)
    if getattr(args, "recommended", False):
        # Recommended operating point: circulant-metric CV (fcv) +
        # over-relaxation 1.8 + 15-inner budget, checked once at the cap.
        # The Lanczos-certified step (margin 0.95 vs the power method's
        # 0.7) converges the node subproblems in ~15 iterations. Explicit
        # flags win over the preset (None = unset, so an explicit 0
        # sticks).
        if relax_alpha == 1.0:
            relax_alpha = 1.8
        if algorithm == "cv":
            algorithm = "fcv"
        if max_inner is None:
            max_inner = 15
        if check_every is None:
            check_every = 15
    if max_inner is None:
        max_inner = 200  # the reference's SCS per-solve cap
    if eps_rel is None:
        eps_rel = 0.0
    if check_every is None:
        check_every = 10
    return ProblemConfig(
        geometry=GeometryConfig(
            N=args.N, num_nodes=args.nodes, angles_total=args.angles,
            fan_beam=args.fan_beam,
        ),
        graph=GraphConfig(
            strategy=args.strategy, k=args.k, seed=args.seed, q_mode=args.q_mode
        ),
        admm=AdmmConfig(
            lam_tv=args.lam_tv, rho=args.rho, max_iters=args.max_iters,
            eps_pri=args.eps_pri, eps_dual=args.eps_dual,
            z_fusion=args.z_fusion,
            relax_alpha=relax_alpha,
            adapt_rho=getattr(args, "adapt_rho", False),
            rho_mu=getattr(args, "rho_mu", 10.0),
            rho_tau=getattr(args, "rho_tau", 2.0),
            adapt_rho_mode=getattr(args, "rho_mode", "balance"),
            rho_stall_window=getattr(args, "rho_stall_window", 10),
            rho_stall_tol=getattr(args, "rho_stall_tol", 0.02),
            node=NodeSolverConfig(
                max_inner=max_inner,
                algorithm=algorithm,
                eps0=getattr(args, "eps0", 2.0),
                check_every=check_every,
                plateau_tol=getattr(args, "plateau_tol", 0.01),
                eps_rel=eps_rel,
            ),
        ),
        noise_level=args.noise,
        phantom=args.phantom,
        dtype=args.dtype,
        fft_table_dtype=getattr(args, "fft_table_dtype", "float32"),
    )


def mode_from_args(args) -> "str | None":
    """Projector mode override (None = build_problem's auto choice)."""
    if getattr(args, "mode", "auto") != "auto":
        return args.mode
    if getattr(args, "matrix_free", False):
        return "fft"
    return None


def main(argv=None) -> dict:
    """Run the experiment the flags describe; prints the per-strategy
    summaries as JSON and returns them."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    out_root = args.out or (
        f"Recon_Out_ADMM_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    )

    mesh = None
    if args.mesh:
        from dip_admm_tpu.parallel import mesh as meshlib

        mesh = meshlib.make_mesh(args.mesh, pixel=args.mesh_pixel)

    from dip_admm_tpu.runners import experiment

    mode = mode_from_args(args)

    problem = None
    if getattr(args, "load_problem", None):
        from dip_admm_tpu.data import serialization

        problem = serialization.load_problem(args.load_problem)
    if getattr(args, "save_problem", None):
        from dip_admm_tpu.data import loader, serialization

        if problem is None:
            problem = loader.build_problem(
                cfg, mode=mode,
                per_node_phantoms=getattr(args, "per_node_phantoms", False),
            )
        serialization.save_problem(problem, args.save_problem)

    def go():
        pnp = getattr(args, "per_node_phantoms", False)
        snap = getattr(args, "snapshot_every", None)
        solver = getattr(args, "solver", "admm")
        if solver == "pdhg-consensus":
            return {
                "pdhg-consensus": experiment.run_pdhg_consensus(
                    cfg, out_root, n_outer=args.pdhg_outer,
                    lam=args.pdhg_lam, gamma=args.pdhg_gamma,
                    anchor_weights=args.anchor_weights, mode=mode,
                )
            }
        if solver in ("centralized", "centralized-tv"):
            return {
                solver: experiment.run_centralized(
                    cfg, out_root, tv=(solver == "centralized-tv"),
                    ridge_lam=args.ridge_lam, mode=mode,
                )
            }
        if args.all_strategies:
            if getattr(args, "checkpoint_every", None) is not None or (
                getattr(args, "resume", None) is not None
            ):
                # The segmented checkpoint driver is single-strategy; silently
                # dropping the flags would leave a user believing their
                # all-strategy run is checkpointed.
                raise SystemExit(
                    "--checkpoint-every/--resume are not supported with "
                    "--all-strategies; run strategies individually"
                )
            return experiment.run_all_strategies(
                cfg, out_root, mesh=mesh, mode=mode, per_node_phantoms=pnp,
                problem=problem,
            )
        _, _, summary = experiment.run_one_strategy(
            cfg, out_root, mesh=mesh, mode=mode, per_node_phantoms=pnp,
            problem=problem,
            snapshot_every=snap,
            checkpoint_every=getattr(args, "checkpoint_every", None),
            resume=getattr(args, "resume", None),
        )
        return {args.strategy: summary}

    if args.profile_dir:
        from dip_admm_tpu.utils.profiling import trace

        with trace(args.profile_dir):
            results = go()
    else:
        results = go()
    print(json.dumps(results, indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
