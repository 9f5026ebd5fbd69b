"""In-process A/B of the projector modes on one GPU.

Run from the repository root on a machine with a GPU:

    python scripts/ab_h100.py [--out results.jsonl]

Cells: 256^2 / 8 nodes parallel beam (knn k=2) and 512^2 / 32 nodes fan
beam (knn k=2), at the recommended operating point (fcv inner solver,
over-relaxation 1.8, 15 inner iterations). For each, the script reports
problem build seconds, one projector apply pair (forward + adjoint) in ms,
and outer iterations/s over a few outers after a compiling warm-up outer.
Every line carries the card's name and power limit. Writes JSON lines to
stdout and, with ``--out PATH``, appends them to PATH.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dip_admm_tpu.config import (  # noqa: E402
    AdmmConfig, GeometryConfig, GraphConfig, NodeSolverConfig, ProblemConfig,
)
from dip_admm_tpu.core import admm  # noqa: E402
from dip_admm_tpu.data import loader  # noqa: E402
from dip_admm_tpu.utils.imaging import psnr  # noqa: E402

CELLS = {
    "par256x8": dict(N=256, P=8, fan=False),
    "fan512x32": dict(N=512, P=32, fan=True),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def emit(rec: dict) -> None:
    rec = {"card": CARD, "device_kind": jax.devices()[0].device_kind, **rec}
    line = json.dumps(rec)
    print(line, flush=True)
    if OUT:
        os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
        with open(OUT, "a") as f:
            f.write(line + "\n")


def peak_bytes():
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def cell_cfg(cell: str, table_dtype: str = "float32") -> ProblemConfig:
    c = CELLS[cell]
    return ProblemConfig(
        geometry=GeometryConfig(N=c["N"], num_nodes=c["P"],
                                fan_beam=c["fan"]),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            max_iters=64, eps_pri=0.0, eps_dual=0.0, relax_alpha=1.8,
            node=NodeSolverConfig(max_inner=15, check_every=15,
                                  algorithm="fcv"),
        ),
        fft_table_dtype=table_dtype,
    )


@functools.partial(jax.jit, static_argnames=("mode", "geo", "reps"))
def _pair_chain(mode, geo, reps, angles, valid, A, tables, x):
    fwd, adj = loader.make_node_ops(mode, geo, angles, valid, A, tables)

    def body(_, x):
        return x + 1e-30 * adj(fwd(x))

    return jax.lax.fori_loop(0, reps, body, x)


def pair_ms(mode, prob, reps=10, trials=5) -> float:
    geo = prob.cfg.geometry
    args = (prob.angles, prob.angle_valid, prob.A,
            prob.fft_tables if mode.startswith("fft") else None)
    x = jnp.tile(prob.x_true[None], (geo.num_nodes, 1))
    _pair_chain(mode, geo, reps, *args, x).block_until_ready()
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        _pair_chain(mode, geo, reps, *args, x).block_until_ready()
        ts.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(ts))


def outer_rate(prob, cfg, n=5):
    st, h = admm.init_state(prob, cfg)
    t0 = time.perf_counter()
    r = admm.run_admm(prob, cfg, st, h, until=1)
    r.x.block_until_ready()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = admm.run_admm(prob, cfg, r.state, r.history, until=1 + n)
    r.x.block_until_ready()
    dt = time.perf_counter() - t0
    x_true = np.asarray(prob.x_true)
    val = float(np.mean([psnr(xi, x_true, data_range=float(x_true.max()))
                         for xi in np.asarray(r.x)]))
    return n / dt, first_s, val


def run_modes() -> None:
    for cell in CELLS:
        for mode in ("fft_skew", "fft"):
            cfg = cell_cfg(cell)
            t0 = time.perf_counter()
            prob = loader.build_problem(cfg, mode=mode)
            jax.block_until_ready(prob.b)
            build_s = time.perf_counter() - t0
            ms = pair_ms(mode, prob)
            rate, first_s, val = outer_rate(prob, cfg.admm)
            emit(dict(cell=cell, mode=mode, build_s=build_s,
                      apply_pair_ms=ms, outer_it_per_s=rate,
                      first_outer_s=first_s, psnr_after_6=val,
                      peak_bytes=peak_bytes()))
            if mode == "fft_skew":
                # The gather projector needs no tables: time its apply pair
                # on the same problem (its own build would recompute
                # colnorms for the gather kernel).
                emit(dict(cell=cell, mode="joseph",
                          apply_pair_ms=pair_ms("joseph", prob, reps=2,
                                                trials=3)))
            del prob


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also append the JSON lines to this file")
    OUT = ap.parse_args().out
    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU")
    CARD = card()
    run_modes()
