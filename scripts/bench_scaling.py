"""Multi-device scaling table: given >= 2 devices, times the headline
decentralized TV-LS problem on 1 device and on every mesh layout up to n
devices (node mesh and node x pixel legs).

On one device it degenerates to the 1-device row; the plumbing (mesh
construction, sharded placement, steady-state timing) is checked by the
virtual-mesh smoke test (tests/test_runners.py).

Usage:
  PYTHONPATH=. python scripts/bench_scaling.py [--N 256] [--nodes 8]
      [--outers 10] [--virtual]          # --virtual: 8-device CPU mesh
"""

from __future__ import annotations

import argparse
import dataclasses
import time


def build_layouts(n_devices: int, P: int, NB: int):
    """(node, pixel) mesh layouts: pure node-mesh powers of two up to
    min(P, n_devices), then node x pixel legs that use MORE devices than
    the node axis alone can (the pixel axis must divide NB)."""
    layouts = []
    dn = 1
    while dn <= min(P, n_devices):
        if P % dn == 0:
            layouts.append((dn, 1))
        dn *= 2
    dn_max = max(d for d, _ in layouts)
    for dp in (2, 4, 8):
        if dn_max * dp <= n_devices and NB % dp == 0:
            layouts.append((dn_max, dp))
    return layouts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--N", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--outers", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--row-block", type=int, default=None)
    ap.add_argument("--mode", default=None,
                    help="projector mode override (e.g. fft_skew; default "
                         "= the loader's auto choice)")
    ap.add_argument("--fan-beam", action="store_true")
    ap.add_argument("--virtual", action="store_true",
                    help="8-device virtual CPU mesh (smoke/plumbing check)")
    args = ap.parse_args(argv)

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import jax.numpy as jnp
    import numpy as np

    from dip_admm_tpu.config import (
        AdmmConfig, GeometryConfig, GraphConfig, NodeSolverConfig,
        ProblemConfig,
    )
    from dip_admm_tpu.core import admm
    from dip_admm_tpu.data import loader
    from dip_admm_tpu.parallel import admm_sharded, mesh as meshlib

    cfg = ProblemConfig(
        geometry=GeometryConfig(
            N=args.N, num_nodes=args.nodes, fan_beam=args.fan_beam,
            **(dict(det_width_factor=2.0) if args.fan_beam else {}),
        ),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=args.outers,
            eps_pri=0.0, eps_dual=0.0, relax_alpha=1.8,
            node=NodeSolverConfig(max_inner=15, check_every=15,
                                  algorithm="fcv"),
        ),
        noise_level=0.005, phantom="shepp",
        fft_table_dtype="float32" if args.virtual else "bfloat16",
    )
    float((jnp.ones((8, 8)) @ jnp.ones((8, 8))).sum())  # device bring-up
    problem = loader.build_problem(
        cfg, mode=args.mode, row_block=args.row_block
    )
    jax.block_until_ready(problem.b)

    if problem.fft_tables:
        t = problem.fft_tables
        row = t["shared"]["par"] if args.fan_beam else t
        NB = row["WtT"].shape[1] if isinstance(row, dict) and "WtT" in row \
            else 1
    else:
        NB = 1
    n_dev = len(jax.devices())
    layouts = build_layouts(n_dev, args.nodes, NB)
    print(f"devices={n_dev} layouts={layouts}", flush=True)

    base_rate = None
    print(f"{'layout':>8s} {'devices':>7s} {'it/s':>8s} {'scaling':>8s}")
    for dn, dp in layouts:
        mesh = meshlib.make_mesh(dn, pixel=dp)
        runner = (admm.run_admm if dn * dp == 1
                  else lambda p, c=None, **kw: admm_sharded.run_admm_sharded(
                      p, c, mesh=mesh, **kw))
        # Warm (compile), then best-of-reps steady state.
        warm = dataclasses.replace(cfg.admm, max_iters=2)
        jax.block_until_ready(runner(problem, warm).x)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            res = runner(problem, cfg.admm)
            float(np.asarray(res.history["primal"])[args.outers - 1])
            best = min(best, time.perf_counter() - t0)
        rate = args.outers / best
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * dn * dp)
        print(f"{dn}x{dp:>6d} {dn*dp:>7d} {rate:>8.2f} {100*eff:>7.1f}%",
              flush=True)


if __name__ == "__main__":
    main()
