"""Headline benchmark: decentralized consensus-ADMM throughput on a GPU.

Run on a machine with a GPU (it exits non-zero without one):

    python bench.py

Prints ONE JSON line:
  {"metric": "admm_iters_per_s_256x256_8nodes", "value": ..., "unit":
   "iters/s", "vs_baseline": ..., "extra": {...}}

Primary metric: outer ADMM iterations/s on the 8-node,
256x256 decentralized TV-LS problem (knn k=2 per-pixel graph, arithmetic
precision weights), with the reference-equivalent inner budget (<=200
first-order inner iterations per node solve, adaptive stationarity target —
matching SCS's <=200-iteration cap at
/root/reference/block_6_admm_loop_ver2.py:123).

``vs_baseline``: the reference publishes no numbers, so the
baseline is a *measured CPU proxy* of the reference's per-iteration work: a
numpy (BLAS) implementation of one outer iteration's dominant cost — per node
200 inner iterations of dense A/A^T matvecs at 64x64 (where the reference's
dense representation fits), FLOP-scaled by (m*n)_256 / (m*n)_64 = 256x to the
256x256 problem size. numpy BLAS is strictly faster than the reference's
SCS+CVXPY path, so this proxy *overestimates* the reference and the reported
speedup is conservative. ``extra`` names the device (platform, kind and the
card's name and power limit from nvidia-smi) beside the numbers.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def measure_throughput(N=256, P=8, timed_iters=20, dtype="float32"):
    import jax

    from dip_admm_tpu.config import (
        AdmmConfig,
        GeometryConfig,
        GraphConfig,
        NodeSolverConfig,
        ProblemConfig,
    )
    from dip_admm_tpu.core import admm
    from dip_admm_tpu.data import loader

    cfg = ProblemConfig(
        geometry=GeometryConfig(N=N, num_nodes=P),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02,
            rho=2.0,
            max_iters=timed_iters,
            eps_pri=0.0,  # never stop early while timing
            eps_dual=0.0,
            node=NodeSolverConfig(max_inner=200, check_every=25),
        ),
        noise_level=0.005,
        phantom="shepp",
        dtype=dtype,
    )
    build_start = time.perf_counter()
    # mode=None -> the loader's auto choice (loader.auto_mode), the path
    # every default-mode user gets.
    problem = loader.build_problem(cfg)
    jax.block_until_ready(problem.b)
    build_s = time.perf_counter() - build_start

    # Warmup / compile.
    warm_cfg = dataclasses.replace(cfg.admm, max_iters=2)
    admm.run_admm(problem, warm_cfg).x.block_until_ready()

    t0 = time.perf_counter()
    res = admm.run_admm(problem)
    res.x.block_until_ready()
    elapsed = time.perf_counter() - t0
    iters = int(res.n_iters)
    pri = np.asarray(res.history["primal"])[:iters]
    inner = np.asarray(res.history["inner_iters"])[:iters]

    # Secondary datapoint: the RECOMMENDED operating point (circulant-metric
    # fcv inner solver, over-relaxation 1.8, 15-inner budget). Same
    # problem/tables.
    rec_cfg = dataclasses.replace(
        cfg.admm,
        relax_alpha=1.8,
        node=dataclasses.replace(
            cfg.admm.node, max_inner=15, algorithm="fcv", check_every=15
        ),
    )
    admm.run_admm(problem, dataclasses.replace(rec_cfg, max_iters=2))
    t0 = time.perf_counter()
    r2 = admm.run_admm(problem, rec_cfg)
    r2.x.block_until_ready()
    rec_elapsed = time.perf_counter() - t0

    from dip_admm_tpu.utils.imaging import psnr

    x_true = np.asarray(problem.x_true)
    dr = float(x_true.max())

    def mean_psnr(r):
        x = np.asarray(r.x)
        return float(np.mean(
            [psnr(xi, x_true, data_range=dr) for xi in x]
        ))

    # The projector apply pair (one forward + one adjoint): wall clock per
    # pair over a chained in-program loop, and the achieved FLOP/s from
    # XLA's cost analysis of one pair.
    import functools

    import jax.numpy as jnp
    from dip_admm_tpu.data.loader import make_node_ops

    def _pair(mode, geo, angles, valid, A, tables, x):
        fwd, adj = make_node_ops(mode, geo, angles, valid, A, tables)
        return adj(fwd(x))  # exactly one fwd + one adj

    @functools.partial(jax.jit, static_argnames=("mode", "geo", "chain"))
    def _chain_pair(mode, geo, chain, angles, valid, A, tables, x):
        fwd, adj = make_node_ops(mode, geo, angles, valid, A, tables)
        acc = jnp.float32(0.0)
        for _ in range(chain):
            g = adj(fwd(x + acc * 1e-20))
            acc = acc + jnp.sum(g[..., :1].astype(jnp.float32))
        return acc

    x0 = jnp.asarray(np.asarray(res.x))
    pair_args = (problem.angles, problem.angle_valid, problem.A,
                 problem.fft_tables)
    chain = 40
    _chain_pair(problem.mode, cfg.geometry, chain, *pair_args,
                x0).block_until_ready()  # compile
    t0 = time.perf_counter()
    _chain_pair(problem.mode, cfg.geometry, chain, *pair_args,
                x0).block_until_ready()
    pair_ms = (time.perf_counter() - t0) / chain * 1e3
    c = (
        jax.jit(_pair, static_argnames=("mode", "geo"))
        .lower(problem.mode, cfg.geometry, *pair_args, x0)
        .compile().cost_analysis()
    )
    flops_pair = float(c["flops"])

    dev = jax.devices()[0]
    return {
        "iters_per_s": iters / elapsed,
        "elapsed_s": elapsed,
        "outer_iters": iters,
        "mean_inner_iters": float(np.nanmean(inner)),
        "final_primal_residual": float(pri[-1]),
        "parity_psnr": mean_psnr(res),
        "recommended_iters_per_s": timed_iters / rec_elapsed,
        "recommended_psnr": mean_psnr(r2),
        "build_s": build_s,
        "projector_mode": problem.mode,
        "apply_pair_ms": pair_ms,
        "apply_pair_tflops": flops_pair / (pair_ms * 1e-3) / 1e12,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card(),
    }


def measure_cpu_reference_proxy(P=8, inner_iters=200, reps=3):
    """Numpy proxy of the reference's per-outer-iteration cost (see module
    docstring). Returns proxied reference outer-iterations/s at 256x256."""
    N64 = 64
    n = N64 * N64
    m = (max(180, 3 * N64) // P) * N64  # rows per node at 64x64
    rng = np.random.default_rng(0)
    A = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=m).astype(np.float32)

    def one_outer():
        xx = x
        for _ in range(inner_iters):
            r = A @ xx - b  # forward
            g = A.T @ r  # adjoint
            xx = xx - 1e-6 * g  # stand-in for the cone/prox step
        return xx

    one_outer()  # warm BLAS
    t0 = time.perf_counter()
    for _ in range(reps):
        one_outer()
    per_node_s = (time.perf_counter() - t0) / reps
    outer_64_s = P * per_node_s  # the reference solves nodes sequentially
    flop_scale = 256.0  # (m*n) grows 16*16 from 64^2 -> 256^2
    outer_256_s = outer_64_s * flop_scale
    return {"ref_proxy_iters_per_s_256": 1.0 / outer_256_s,
            "ref_proxy_outer_64_s": outer_64_s}


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX reports "
                 f"{jax.devices()[0].platform!r}")
    ref = measure_cpu_reference_proxy()
    gpu = measure_throughput()
    out = {
        "metric": "admm_iters_per_s_256x256_8nodes",
        "value": gpu["iters_per_s"],
        "unit": "iters/s",
        "vs_baseline": gpu["iters_per_s"] / ref["ref_proxy_iters_per_s_256"],
        "extra": {**gpu, **ref},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
