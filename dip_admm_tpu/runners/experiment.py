"""Experiment orchestration (block-7 parity).

``run_one_strategy`` mirrors ``/root/reference/block_7_main_ver3.py:30-329``:
build the per-pixel graph for a strategy, run decentralized ADMM, and emit
the full artifact set; ``run_all_strategies`` mirrors the ver0 orchestrator
(``block_7_main_ver0.py:192-204``) running mst / chain / knn back-to-back.

Unlike the reference (one hard-coded ``main()``), runs are parameterized by
``ProblemConfig`` and can execute on a device mesh (``mesh=`` sharded over
graph nodes) or a single device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np

from dip_admm_tpu.config import ProblemConfig
from dip_admm_tpu.core import admm
from dip_admm_tpu.data import loader
from dip_admm_tpu.graph import topology
from dip_admm_tpu.utils import artifacts
from dip_admm_tpu.utils.imaging import psnr


def run_one_strategy(
    cfg: ProblemConfig,
    out_root: str,
    strategy: Optional[str] = None,
    k: Optional[int] = None,
    mesh=None,
    problem: Optional[loader.Problem] = None,
    write_artifacts: bool = True,
    mode: Optional[str] = None,
    per_node_phantoms: bool = False,
    snapshot_every: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    resume: Optional[str] = None,
):
    """Run decentralized ADMM for one graph strategy; returns
    (x [P, n] numpy, history dict numpy, summary dict).

    ``snapshot_every`` writes per-node reconstruction snapshots every K
    outer iterations (single-device path; ref block_6 ver2:269-281).
    ``checkpoint_every`` runs the solve in K-iteration segments
    (``state/hist/until`` contract) and queues the full loop state to
    ``<out_dir>/checkpoint.npz`` after each segment on the native async
    packer; ``resume`` restarts from such a checkpoint. Works on both the
    single-device and ``mesh=`` sharded paths (the reference's chunked
    orchestrator capability, block_6 ver2:269-281)."""
    if strategy is not None or k is not None:
        g = cfg.graph
        g = dataclasses.replace(
            g,
            strategy=strategy if strategy is not None else g.strategy,
            k=k if k is not None else g.k,
        )
        cfg = dataclasses.replace(cfg, graph=g)

    tag = (
        f"{cfg.graph.strategy}_k{cfg.graph.k}"
        if cfg.graph.strategy == "knn"
        else cfg.graph.strategy
    )
    out_dir = os.path.join(out_root, tag)

    if problem is None:
        problem = loader.build_problem(
            cfg, mode=mode, per_node_phantoms=per_node_phantoms
        )
    elif problem.cfg.graph != cfg.graph:
        problem = loader.rebuild_graph(problem, cfg.graph)

    if checkpoint_every is not None and snapshot_every is not None:
        raise ValueError(
            "checkpoint_every and snapshot_every are separate segmented "
            "drivers; pass one or the other"
        )
    if checkpoint_every is not None and checkpoint_every < 1:
        # <= 0 would make every segment end at until == state.k: the loop
        # body never advances and the segment driver spins forever.
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    t_solve = time.perf_counter()
    if snapshot_every is not None:
        res = admm.run_admm_snapshots(
            problem, cfg.admm,
            snapshot_dir=os.path.join(out_dir, "snapshots"),
            snapshot_every=snapshot_every,
            mesh=mesh,
        )
    elif checkpoint_every is not None:
        from dip_admm_tpu.data import serialization

        if mesh is not None:
            from dip_admm_tpu.parallel import admm_sharded

            run = lambda **kw: admm_sharded.run_admm_sharded(
                problem, cfg.admm, mesh=mesh, **kw
            )
        else:
            run = lambda **kw: admm.run_admm(problem, cfg.admm, **kw)
        state = hist = None
        if resume is not None:
            state, hist = serialization.load_checkpoint(resume)
            # A checkpoint written under a shorter run grows its history
            # buffers to this config's horizon (NaN-padded past state.k).
            hist = admm.grow_history(hist, cfg.admm.max_iters)
        ckpt_path = os.path.join(out_dir, "checkpoint.npz")
        while True:
            k0 = 0 if state is None else int(state.k)
            res = run(
                state=state, hist=hist,
                until=min(k0 + checkpoint_every, cfg.admm.max_iters),
            )
            state, hist = res.state, res.history
            serialization.save_checkpoint_async(ckpt_path, state, hist)
            if bool(state.stop) or int(state.k) >= cfg.admm.max_iters:
                break
        serialization.flush_checkpoints()
    elif mesh is not None:
        from dip_admm_tpu.parallel import admm_sharded

        res = admm_sharded.run_admm_sharded(problem, cfg.admm, mesh=mesh)
    else:
        res = admm.run_admm(problem, cfg.admm)

    n_iters = int(res.n_iters)
    x = np.asarray(res.x)
    solve_s = time.perf_counter() - t_solve
    hist = {kk: np.asarray(v) for kk, v in res.history.items()}
    N = problem.N
    x_true = np.asarray(problem.x_true)
    m_per_node = np.asarray(
        problem.angle_valid.sum(axis=1) * cfg.geometry.n_det
    )

    summary = {
        "tag": tag,
        "n_iters": n_iters,
        "final_primal": float(hist["primal"][n_iters - 1]),
        "final_dual": float(hist["dual"][n_iters - 1]),
        "mean_psnr": float(
            np.mean(
                [psnr(x[i], x_true, data_range=x_true.max()) for i in range(len(x))]
            )
        ),
        "graph": topology.union_summary(problem.keep),
        # wall seconds of the solve, including its compilation
        "solve_s": solve_s,
        "out_dir": out_dir,
    }

    if write_artifacts:
        artifacts.save_run_parameters(out_dir, cfg, extra=summary["graph"])
        artifacts.save_union_graph(
            problem.adj, os.path.join(out_dir, "union_figs"), tag
        )
        artifacts.save_recons(x, N, out_dir, tag)
        artifacts.save_history_artifacts(
            hist, n_iters, out_dir, tag, m_per_node=m_per_node, N=N
        )
        artifacts.flush_async()

    return x, hist, summary


def run_all_strategies(
    cfg: ProblemConfig, out_root: Optional[str] = None, mesh=None,
    mode: Optional[str] = None, per_node_phantoms: bool = False,
    problem: Optional[loader.Problem] = None,
):
    """mst, chain, knn back-to-back on the same data
    (ref ``block_7_main_ver0.py:192-204``); the problem operators/sinograms
    are shared (``problem`` may supply them pre-built/loaded), only the
    graph layer is rebuilt per strategy."""
    if out_root is None:
        out_root = f"Recon_Out_ADMM_{datetime.now().strftime('%Y%m%d_%H%M%S')}"
    if problem is None:
        problem = loader.build_problem(
            cfg, mode=mode, per_node_phantoms=per_node_phantoms
        )
    results = {}
    for strategy in ("mst", "chain", "knn"):
        x, hist, summary = run_one_strategy(
            cfg, out_root, strategy=strategy, mesh=mesh, problem=problem
        )
        results[strategy] = summary
    return results


def run_pdhg_consensus(
    cfg: ProblemConfig,
    out_root: Optional[str] = None,
    n_outer: int = 100,
    lam: float = 0.005,
    gamma: float = 2.0,
    anchor_weights: str = "oracle",
    mode: Optional[str] = None,
    write_artifacts: bool = True,
) -> dict:
    """Legacy penalized-consensus PDHG solver as a CLI-reachable experiment
    (the reference runs it as a script entry, ``ADMM_Tomo_Only.py:89-168``).
    Returns a summary with per-node and aggregate PSNR/MSE trajectories."""
    from dip_admm_tpu.solvers import pdhg_consensus

    problem = loader.build_problem(cfg, mode=mode)
    pcfg = pdhg_consensus.PdhgConsensusConfig(
        n_outer=n_outer, lam_tv=lam, lam_agg=lam, gamma=gamma,
        anchor_weights=anchor_weights,
    )
    res = pdhg_consensus.solve(problem, pcfg)
    x = np.asarray(res.x_nodes)
    x_agg = np.asarray(res.x_agg)
    x_true = np.asarray(problem.x_true)
    dr = float(x_true.max())
    summary = {
        "solver": "pdhg-consensus",
        "n_outer": n_outer,
        "mean_node_psnr": float(
            np.mean([psnr(xi, x_true, data_range=dr) for xi in x])
        ),
        "agg_psnr": float(psnr(x_agg, x_true, data_range=dr)),
        "final_img_mse_nodes": np.asarray(res.img_mse_nodes)[-1].tolist(),
        "final_img_mse_agg": float(np.asarray(res.img_mse_agg)[-1]),
    }
    if write_artifacts and out_root is not None:
        out_dir = os.path.join(out_root, "pdhg_consensus")
        artifacts.save_recons(x, problem.N, out_dir, "pdhg_nodes")
        artifacts.save_recons(
            x_agg[None, :], problem.N, out_dir, "pdhg_aggregate"
        )
        artifacts.save_mse_curves(
            {
                "img_mse_nodes": np.asarray(res.img_mse_nodes),
                "sino_mse_nodes": np.asarray(res.sino_mse_nodes),
                "img_mse_agg": np.asarray(res.img_mse_agg),
                "sino_mse_agg": np.asarray(res.sino_mse_agg),
            },
            out_dir,
        )
        artifacts.flush_async()
        summary["out_dir"] = out_dir
    return summary


def run_centralized(
    cfg: ProblemConfig,
    out_root: Optional[str] = None,
    tv: bool = False,
    ridge_lam: float = 1e-3,
    mode: Optional[str] = None,
    write_artifacts: bool = True,
) -> dict:
    """Centralized aggregate baseline: ridge LS (ref
    ``block_2_test.py:83-88``) or TV-LS (the quality ceiling)."""
    from dip_admm_tpu.solvers import centralized

    problem = loader.build_problem(cfg, mode=mode)
    if tv:
        x, g_norm = centralized.tv_reconstruction(
            problem, lam_tv=cfg.admm.lam_tv
        )
        extra = {"final_stationarity": float(g_norm)}
        tag = "centralized_tv"
    else:
        x = centralized.ridge_reconstruction(problem, lam=ridge_lam)
        extra = {"ridge_lam": ridge_lam}
        tag = "centralized_ridge"
    x = np.asarray(x)
    x_true = np.asarray(problem.x_true)
    summary = {
        "solver": tag,
        "psnr": float(psnr(x, x_true, data_range=float(x_true.max()))),
        "img_mse": float(np.mean((x - x_true) ** 2)),
        **extra,
    }
    if write_artifacts and out_root is not None:
        out_dir = os.path.join(out_root, tag)
        artifacts.save_recons(x[None, :], problem.N, out_dir, tag)
        artifacts.flush_async()
        summary["out_dir"] = out_dir
    return summary


def evaluate_strategies(cfg: ProblemConfig, mesh=None) -> dict:
    """Strategy comparison on final residuals and mean PSNR — the acceptance
    driver sketched by ``/root/reference/test_final_integration.py:35-50``."""
    out = {}
    problem = loader.build_problem(cfg)
    for strategy in ("mst", "chain", "knn"):
        _, _, summary = run_one_strategy(
            cfg, out_root="/tmp/dip_admm_eval", strategy=strategy, mesh=mesh,
            problem=problem, write_artifacts=False,
        )
        out[strategy] = {
            "final_primal": summary["final_primal"],
            "final_dual": summary["final_dual"],
            "mean_psnr": summary["mean_psnr"],
        }
    return out
