"""Operator persistence and run checkpoint/resume.

The reference persists operators as pickles
(``/root/reference/block_2_load_odl_data.py:198-201``, consumed by
``block_2_test.py:28-42``) and has *no* mid-run resume (SURVEY §5). Here:

- ``save_problem`` / ``load_problem``: the full Problem (operators, data,
  graph) as a portable ``.npz`` + JSON config — the pickle-free equivalent of
  ``saved_operators_Incmp_Span/``.
- ``save_checkpoint`` / ``load_checkpoint``: the complete ADMM loop state
  ``(x, TV duals, z, y, k, histories)`` enabling exact resume — combined with
  ``core.admm.run_admm(state=..., hist=...)`` a run continues bit-for-bit
  where it stopped.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from dip_admm_tpu.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.core.admm import AdmmState
from dip_admm_tpu.core.node_solver import NodeState
from dip_admm_tpu.data.loader import Problem


def _cfg_to_json(cfg: ProblemConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def _known(cls, d: dict) -> dict:
    """Drop keys that are no longer dataclass fields (problems saved under
    older configs stay loadable after a knob is removed)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _cfg_from_json(s: str) -> ProblemConfig:
    d = json.loads(s)
    return ProblemConfig(
        geometry=GeometryConfig(**_known(GeometryConfig, d["geometry"])),
        graph=GraphConfig(**_known(GraphConfig, d["graph"])),
        admm=AdmmConfig(
            **{
                **_known(AdmmConfig, d["admm"]),
                "node": NodeSolverConfig(
                    **_known(NodeSolverConfig, d["admm"]["node"])
                ),
            }
        ),
        **_known(
            ProblemConfig,
            {k: v for k, v in d.items() if k not in ("geometry", "graph", "admm")},
        ),
    )


def _flatten_tables(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        kk = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_tables(v, kk + "/"))
        else:
            out[kk] = v
    return out


def _unflatten_tables(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


# npz key prefixes for persisted projector tables. bf16 leaves round-trip as
# uint16 bit views (numpy's zip format voids ml_dtypes arrays).
_TBL = "__tbl__/"
_TBL16 = "__tbl16__/"


def save_problem(problem: Problem, path: str, include_tables: bool = True) -> None:
    """Persist the full Problem as a portable .npz + JSON config.

    ``include_tables`` (default) also stores the precomputed projector
    geometry tables, so :func:`load_problem` skips the table build, the
    dominant derived-state cost — a reloaded problem pays IO only. Stored
    uncompressed (np.savez): float tables barely deflate and the write/read
    speed is the point of persisting them.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {
        "angles": problem.angles,
        "angle_valid": problem.angle_valid,
        "b": problem.b,
        "W": problem.W,
        "Q": problem.Q,
        "keep": problem.keep,
        "adj": problem.adj,
        "x_true": problem.x_true,
        "opnorm": problem.opnorm,
    }
    if problem.A is not None:
        arrays["A"] = problem.A
    out = {k: np.asarray(v) for k, v in arrays.items()}
    if include_tables and problem.fft_tables is not None:
        import ml_dtypes

        for k, v in _flatten_tables(problem.fft_tables).items():
            a = np.asarray(v)
            if a.dtype == ml_dtypes.bfloat16:
                out[_TBL16 + k] = a.view(np.uint16)
            else:
                out[_TBL + k] = a
    np.savez(
        path,
        __cfg__=np.frombuffer(_cfg_to_json(problem.cfg).encode(), dtype=np.uint8),
        __mode__=np.frombuffer(problem.mode.encode(), dtype=np.uint8),
        **out,
    )


def _backfill_tap_layout(tables: dict) -> None:
    """Older problem bundles carry only the t-major tap
    table ``Wt``; the skew kernels now read the d-major ``WtT``. Derive it
    in place (both the parallel-beam top level and the fan ``shared.par``
    nesting). Only called for mode="fft_skew" bundles — fft_shear bundles
    keep their t-major-only layout."""
    for t in (tables, tables.get("shared", {}).get("par")):
        if isinstance(t, dict) and "Wt" in t and "WtT" not in t:
            t["WtT"] = jnp.transpose(t["Wt"], (0, 1, 3, 2, 4))


def load_problem(path: str) -> Problem:
    z = np.load(path)
    cfg = _cfg_from_json(bytes(z["__cfg__"]).decode())
    mode = bytes(z["__mode__"]).decode()
    fft_tables = None
    if mode.startswith("fft"):
        flat = {}
        for k in z.files:
            if k.startswith(_TBL):
                flat[k[len(_TBL):]] = jnp.asarray(z[k])
            elif k.startswith(_TBL16):
                import ml_dtypes

                flat[k[len(_TBL16):]] = jnp.asarray(
                    z[k].view(ml_dtypes.bfloat16)
                )
        if flat:
            fft_tables = _unflatten_tables(flat)
            if mode == "fft_skew":
                _backfill_tap_layout(fft_tables)
        else:
            # Problem saved without tables: rebuild the derived state.
            from dip_admm_tpu.data.loader import build_fft_tables

            fft_tables = build_fft_tables(
                cfg, jnp.asarray(z["angles"]), jnp.asarray(z["angle_valid"]),
                mode,
            )
    return Problem(
        fft_tables=fft_tables,
        cfg=cfg,
        mode=mode,
        angles=jnp.asarray(z["angles"]),
        angle_valid=jnp.asarray(z["angle_valid"]),
        A=jnp.asarray(z["A"]) if "A" in z.files else None,
        b=jnp.asarray(z["b"]),
        W=jnp.asarray(z["W"]),
        Q=jnp.asarray(z["Q"]),
        keep=jnp.asarray(z["keep"]),
        adj=jnp.asarray(z["adj"]),
        x_true=jnp.asarray(z["x_true"]),
        opnorm=jnp.asarray(z["opnorm"]),
    )


def _checkpoint_payload(state: AdmmState, hist: dict) -> dict:
    return {
        "x": np.asarray(state.node.x),
        "ux": np.asarray(state.node.ux),
        "uy": np.asarray(state.node.uy),
        "ua": np.asarray(state.node.ua),
        "xp": np.asarray(state.node.xp),
        "tk": np.asarray(state.node.tk),
        "Z": np.asarray(state.Z),
        "Y": np.asarray(state.Y),
        "k": np.asarray(state.k),
        "stop": np.asarray(state.stop),
        "rho_scale": np.asarray(state.rho_scale),
        **{f"hist_{k}": np.asarray(v) for k, v in hist.items()},
    }


def _save_npz(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **payload)


def save_checkpoint(path: str, state: AdmmState, hist: dict) -> None:
    _save_npz(path, _checkpoint_payload(state, hist))


def save_checkpoint_async(path: str, state: AdmmState, hist: dict) -> None:
    """Queue the same payload as :func:`save_checkpoint` on the native C++
    packer thread (``native/checkpoint_packer.cpp``) — the solve loop never
    blocks on zlib/zipfile. Falls back to the synchronous numpy writer when
    the native toolchain is unavailable. Call :func:`flush_checkpoints`
    before reading the file back (the write is also atomic: tmp + rename).
    """
    from dip_admm_tpu.utils import native_checkpoint as nc

    payload = _checkpoint_payload(state, hist)
    if not nc.available():
        return _save_npz(path, payload)
    try:
        nc.pack_npz(path, payload)
    except RuntimeError:
        # Defensive only: the packer writes zip64 records past the 4 GiB /
        # 65535-member zip32 limits, so size is never a reason to land here.
        _save_npz(path, payload)


def flush_checkpoints() -> None:
    """Block until queued :func:`save_checkpoint_async` writes hit disk."""
    from dip_admm_tpu.utils import native_checkpoint as nc

    if nc.available():
        nc.flush()


def save_checkpoint_orbax(path: str, state: AdmmState, hist: dict) -> None:
    """Orbax-backed checkpoint (async-capable, multi-host aware) of the same
    payload as :func:`save_checkpoint`."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(
        os.path.abspath(path),
        {"state": state._asdict() | {"node": state.node._asdict()},
         "hist": dict(hist)},
        force=True,
    )
    ckptr.wait_until_finished()


def load_checkpoint_orbax(path: str) -> tuple[AdmmState, dict]:
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    payload = ckptr.restore(os.path.abspath(path))
    s = payload["state"]
    nd = {k: jnp.asarray(v) for k, v in s["node"].items()}
    nd.setdefault("xp", jnp.zeros_like(nd["x"]))  # pre-fista checkpoints
    nd.setdefault(
        "tk", jnp.full((nd["x"].shape[0],), jnp.inf, nd["x"].dtype)
    )  # fresh-step sentinel (see node_solver.init_state)
    node = NodeState(**nd)
    state = AdmmState(
        node=node,
        Z=jnp.asarray(s["Z"]),
        Y=jnp.asarray(s["Y"]),
        k=jnp.asarray(s["k"]),
        stop=jnp.asarray(s["stop"]),
        # Pre-adapt_rho checkpoints carry no multiplier: 1.0 resumes the
        # fixed-rho trajectory exactly.
        rho_scale=jnp.asarray(s.get("rho_scale", 1.0), nd["x"].dtype),
    )
    hist = {k: jnp.asarray(v) for k, v in payload["hist"].items()}
    return state, _upgrade_history(hist)


def _upgrade_history(hist: dict) -> dict:
    """Backfill history fields added after a checkpoint was written (NaN,
    like unreached iterations) so old checkpoints resume under the current
    HISTORY_FIELDS contract — the sharded driver needs the full pytree."""
    from dip_admm_tpu.core.admm import HISTORY_FIELDS

    T = hist["primal"].shape[0]
    P = hist["g_norm"].shape[1]
    dtype = hist["primal"].dtype
    for name, per_node in HISTORY_FIELDS:
        if name not in hist:
            shape = (T, P) if per_node else (T,)
            hist[name] = jnp.full(shape, jnp.nan, dtype)
    return hist


def load_checkpoint(path: str) -> tuple[AdmmState, dict]:
    z = np.load(path)
    state = AdmmState(
        node=NodeState(
            x=jnp.asarray(z["x"]),
            ux=jnp.asarray(z["ux"]),
            uy=jnp.asarray(z["uy"]),
            ua=jnp.asarray(z["ua"]),
            # Momentum fields are absent in pre-fista checkpoints; their
            # neutral values reproduce the old behavior exactly.
            xp=jnp.asarray(z["xp"]) if "xp" in z.files
            else jnp.zeros_like(jnp.asarray(z["x"])),
            tk=jnp.asarray(z["tk"]) if "tk" in z.files
            else jnp.full(
                (z["x"].shape[0],), jnp.inf, jnp.asarray(z["x"]).dtype
            ),  # fresh-step sentinel (see node_solver.init_state)
        ),
        Z=jnp.asarray(z["Z"]),
        Y=jnp.asarray(z["Y"]),
        k=jnp.asarray(z["k"]),
        stop=jnp.asarray(z["stop"]),
        # Pre-adapt_rho checkpoints carry no multiplier: 1.0 resumes the
        # fixed-rho trajectory exactly.
        rho_scale=jnp.asarray(z["rho_scale"]) if "rho_scale" in z.files
        else jnp.asarray(1.0, jnp.asarray(z["x"]).dtype),
    )
    hist = {
        k[len("hist_"):]: jnp.asarray(z[k])
        for k in z.files
        if k.startswith("hist_")
    }
    return state, _upgrade_history(hist)
