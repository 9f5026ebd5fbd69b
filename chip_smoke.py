"""Smoke test of the consensus-ADMM solver on a GPU.

    python chip_smoke.py          # one card: phases (a)-(e)
    python chip_smoke.py --four   # four cards: phase (f) only

Phases, each printed with its sizes, its result against its tolerance, wall
seconds and the card's peak memory in use so far:

  (a) the first JAX device is a GPU;
  (b) operator parity at 256^2/8 parallel and 512^2/32 fan beam: the
      default projector (``loader.auto_mode``) against the dense-phase-table
      reference (mode "fft", f32 tables, Precision.HIGHEST), forward,
      adjoint and the adjoint identity, with f32 and bf16 tables;
  (c) the flagship run through ``runners.cli.main`` (64^2, 5 nodes, knn
      k=2, dense operator, 30 outer iterations);
  (d) 256^2/8 knn through the CLI, recommended preset and the 200-inner
      parity budget;
  (e) 512^2/32 fan through the CLI, recommended preset;
  (f) (--four) the sharded solver on a node mesh of 4 and a node x pixel
      mesh of 2x2 against ``run_admm`` on one card, at 256^2/8 and 512^2/32
      fan.

Any failed phase exits non-zero without the result line, and so does a run
still going after DEADLINE_S seconds (a device program that hangs, e.g. in
a collective, is reported with the phase it hung in). The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import threading
import time

# f32 tables: the factored operator is exact, only f32 rounding differs.
# bf16 tables: taps, DFT and twiddles carry 8 mantissa bits (~4e-3 each);
# the bound is the CPU test grid's, above its measured worst case (6e-3).
REL_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Adjoint identity |<Ax,y> - <x,A^T y>| relative to ||Ax|| ||y||.
ADJ_TOL = {"float32": 1e-6, "bfloat16": 3e-4}
# tests/test_admm_e2e.py's reconstruction floor for the small flagship run.
FLAGSHIP_PSNR = 18.0
# 256^2/8 knn, const phantom: recommended preset after 10 outers, parity
# budget after 3 (an H100 run reached 29.25 and 26.34 dB).
REC_PSNR = 25.0
PARITY_PSNR = 20.0
SHARD_TOL = 1e-4
# Whole-run watchdog, inside the 1200 s a caller allows the script.
DEADLINE_S = 1100

FAILED: list[str] = []
CURRENT = ["start"]  # what is running now, for the watchdog's message


def log(msg: str) -> None:
    print(msg, flush=True)


def check(phase: str, ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILED.append(f"{phase}: {what}")


def peak_bytes() -> int:
    """Peak bytes in use on the first card (where phases (b)-(e) run)."""
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


class Phase:
    def __init__(self, name: str, sizes: str):
        self.name, self.sizes = name, sizes

    def __enter__(self):
        log(f"phase {self.name}: {self.sizes}")
        CURRENT[0] = f"phase {self.name}"
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"  wall {time.perf_counter() - self.t0:.1f} s, "
                f"peak {peak_bytes() / 2**30:.2f} GiB")


def _geometry(N, P, fan):
    from dip_admm_tpu.config import GeometryConfig

    return GeometryConfig(N=N, num_nodes=P, fan_beam=fan)


def _apply(mode, geo, angles, valid, tables, x, y):
    """Forward of x and adjoint of y; the tables are jit arguments (closed
    over, multi-GB tables would be baked into the program as constants)."""
    from dip_admm_tpu.data import loader

    f, a = loader.make_node_ops(mode, geo, angles, valid, None, tables)
    return f(x), a(y)


def phase_parity(N: int, P: int, fan: bool) -> None:
    import jax
    import jax.numpy as jnp

    from dip_admm_tpu.config import ProblemConfig
    from dip_admm_tpu.data import loader
    from dip_admm_tpu.ops import radon

    apply = jax.jit(_apply, static_argnames=("mode", "geo"))

    geo = _geometry(N, P, fan)
    mode = loader.auto_mode(N)
    name = f"b/{'fan' if fan else 'parallel'}{N}x{P}"
    with Phase(name, f"{N}^2, {P} nodes, {'fan' if fan else 'parallel'} "
                     f"beam, {mode} vs fft (all {P} nodes)"):
        angles_np, valid_np, _ = radon.node_angles(geo)
        angles = jnp.asarray(angles_np, jnp.float32)
        valid = jnp.asarray(valid_np)

        def run(m, dtype, x, y):
            cfg = ProblemConfig(geometry=geo, fft_table_dtype=dtype)
            t = loader.build_fft_tables(cfg, angles, valid, m)
            return apply(mode=m, geo=geo, angles=angles, valid=valid,
                         tables=t, x=x, y=y)

        key = jax.random.PRNGKey(0)
        x = jax.random.normal(key, (P, geo.n))
        y = jax.random.normal(
            jax.random.fold_in(key, 1),
            (P, angles.shape[1] * geo.n_det),
        )
        Ax_ref, Aty_ref = run("fft", "float32", x, y)
        for dtype in ("float32", "bfloat16"):
            Ax, Aty = run(mode, dtype, x, y)
            e_f = float(jnp.max(jnp.abs(Ax - Ax_ref)) /
                        jnp.max(jnp.abs(Ax_ref)))
            e_a = float(jnp.max(jnp.abs(Aty - Aty_ref)) /
                        jnp.max(jnp.abs(Aty_ref)))
            gap = abs(float(jnp.vdot(Ax, y)) - float(jnp.vdot(x, Aty)))
            e_i = gap / float(jnp.linalg.norm(Ax) * jnp.linalg.norm(y))
            tol, adj_tol = REL_TOL[dtype], ADJ_TOL[dtype]
            check(name, e_f <= tol, f"{dtype} forward rel max err "
                  f"{e_f:.3e} <= {tol:g}")
            check(name, e_a <= tol, f"{dtype} adjoint rel max err "
                  f"{e_a:.3e} <= {tol:g}")
            check(name, e_i <= adj_tol, f"{dtype} adjoint identity "
                  f"{e_i:.3e} <= {adj_tol:g}")


def run_cli(name: str, argv: list[str]) -> dict:
    """One run through the CLI; returns its summary plus the primal
    residual history."""
    import numpy as np

    from dip_admm_tpu.runners import cli

    out = os.path.join("runs", "chip_smoke", name.replace("/", "_"))
    (summary,) = cli.main(argv + ["--out", out]).values()
    tag = summary["tag"]
    summary["primal"] = np.load(
        os.path.join(summary["out_dir"], f"{tag}_primal_hist.npy")
    )
    n = summary["n_iters"]
    log(f"  {n} outer iterations, solve {summary['solve_s']:.1f} s "
        f"(incl. compile; {n / summary['solve_s']:.2f} outer it/s, for "
        f"information); primal {summary['primal'][0]:.4g} -> "
        f"{summary['primal'][-1]:.4g}, mean PSNR {summary['mean_psnr']:.2f} "
        f"dB")
    return summary


def check_run(name: str, s: dict, psnr_floor: float | None) -> None:
    import numpy as np

    pri = s["primal"]
    check(name, bool(np.isfinite(pri).all()), "residuals finite")
    check(name, bool(pri[-1] < pri[0]),
          f"primal residual falls ({pri[0]:.4g} -> {pri[-1]:.4g})")
    if psnr_floor is not None:
        check(name, s["mean_psnr"] >= psnr_floor,
              f"mean PSNR {s['mean_psnr']:.2f} >= {psnr_floor} dB")
    else:
        check(name, bool(np.isfinite(s["mean_psnr"])),
              f"mean PSNR {s['mean_psnr']:.2f} dB finite")


def phase_cli(name, sizes, argv, psnr_floor):
    with Phase(name, sizes):
        check_run(name, run_cli(name, argv), psnr_floor)


@functools.lru_cache(maxsize=None)
def _sharded_case(N: int, P: int, fan: bool):
    """(problem, one-card x, its scale, one-card n_iters) for phase (f),
    built once per geometry and shared by its mesh legs."""
    import numpy as np

    from dip_admm_tpu.config import (
        AdmmConfig, GraphConfig, NodeSolverConfig, ProblemConfig,
    )
    from dip_admm_tpu.core import admm
    from dip_admm_tpu.data import loader

    cfg = ProblemConfig(
        geometry=_geometry(N, P, fan),
        graph=GraphConfig(strategy="knn", k=2, seed=123),
        admm=AdmmConfig(
            max_iters=3, eps_pri=0.0, eps_dual=0.0, relax_alpha=1.8,
            node=NodeSolverConfig(max_inner=15, check_every=15,
                                  algorithm="fcv"),
        ),
    )
    problem = loader.build_problem(cfg)
    ref = admm.run_admm(problem)
    x_ref = np.asarray(ref.x)
    return problem, x_ref, float(np.abs(x_ref).max()), int(ref.n_iters)


def phase_sharded(N: int, P: int, fan: bool, n_node: int, pixel: int) -> None:
    import numpy as np

    from dip_admm_tpu.parallel import admm_sharded, mesh as meshlib

    name = f"f/{'fan' if fan else 'parallel'}{N}x{P}/mesh{n_node}x{pixel}"
    with Phase(name, f"{N}^2, {P} nodes, {'fan' if fan else 'parallel'} "
                     f"beam, 3 outers (recommended preset), {n_node}x{pixel} "
                     f"mesh vs one card"):
        problem, x_ref, scale, n_ref = _sharded_case(N, P, fan)
        t0 = time.perf_counter()
        got = admm_sharded.run_admm_sharded(
            problem, mesh=meshlib.make_mesh(n_node, pixel=pixel)
        )
        err = float(np.abs(np.asarray(got.x) - x_ref).max()) / scale
        check(name, int(got.n_iters) == n_ref and err <= SHARD_TOL,
              f"rel max err vs one card {err:.3e} <= {SHARD_TOL:g} "
              f"({time.perf_counter() - t0:.1f} s)")


def plan(four: bool) -> list:
    """(phase, args) in run order: the four-card run is phase (f) alone,
    its node-mesh legs first, so a node x pixel leg that fails cannot hide
    them."""
    if four:
        return [(phase_sharded, (N, P, fan, n_node, pixel))
                for n_node, pixel in ((4, 1), (2, 2))
                for N, P, fan in ((256, 8, False), (512, 32, True))]
    return [
        (phase_parity, (256, 8, False)),
        (phase_parity, (512, 32, True)),
        (phase_cli, ("c/flagship", "64^2, 5 nodes, knn k=2, dense, 30 outers",
                     ["--N", "64", "--nodes", "5", "--strategy", "knn",
                      "--k", "2", "--max-iters", "30"], FLAGSHIP_PSNR)),
        (phase_cli, ("d/recommended",
                     "256^2, 8 nodes, knn k=2, --recommended, 10 outers",
                     ["--N", "256", "--nodes", "8", "--recommended",
                      "--max-iters", "10"], REC_PSNR)),
        (phase_cli, ("d/parity",
                     "256^2, 8 nodes, knn k=2, 200 inner, 3 outers",
                     ["--N", "256", "--nodes", "8", "--max-inner", "200",
                      "--max-iters", "3"], PARITY_PSNR)),
        (phase_cli, ("e/fan",
                     "512^2, 32 nodes, fan beam, knn k=2, --recommended, "
                     "3 outers",
                     ["--N", "512", "--nodes", "32", "--fan-beam",
                      "--recommended", "--max-iters", "3"], None)),
    ]


def _give_up() -> None:
    """Watchdog: a device program that never returns cannot be
    interrupted from Python, so report where it hung and end the process."""
    print(f"timed out after {DEADLINE_S} s in {CURRENT[0]}", file=sys.stderr,
          flush=True)
    sys.stdout.flush()
    os._exit(3)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded phase (f)")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"phase a: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"phase a: {len(devices)} GPU(s), need {need}", file=sys.stderr)
        return 2
    import dip_admm_tpu  # noqa: F401  (fails where only this file exists)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(card)
    log(f"phase a: {len(devices)} x {devices[0].device_kind} "
        f"({devices[0].platform})")

    watchdog = threading.Timer(DEADLINE_S, _give_up)
    watchdog.daemon = True
    watchdog.start()
    for phase, phase_args in plan(args.four):
        phase(*phase_args)
    watchdog.cancel()

    if FAILED:
        print("FAILED phases:\n  " + "\n  ".join(FAILED), file=sys.stderr)
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
