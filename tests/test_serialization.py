"""Persistence: problem save/load round-trip and exact checkpoint/resume."""

import dataclasses

import numpy as np

from dip_admm_tpu.config import (
    AdmmConfig,
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    ProblemConfig,
)
from dip_admm_tpu.core import admm
from dip_admm_tpu.data import loader, serialization


def _cfg(max_iters=8):
    return ProblemConfig(
        geometry=GeometryConfig(N=12, num_nodes=3, angles_total=18),
        graph=GraphConfig(strategy="knn", k=1, seed=123),
        admm=AdmmConfig(
            lam_tv=0.02, rho=2.0, max_iters=max_iters,
            eps_pri=1e-9, eps_dual=1e-9,
            node=NodeSolverConfig(max_inner=40, check_every=20),
        ),
        phantom="const",
    )


def test_problem_roundtrip(tmp_path):
    problem = loader.build_problem(_cfg())
    path = str(tmp_path / "problem.npz")
    serialization.save_problem(problem, path)
    loaded = serialization.load_problem(path)
    assert loaded.cfg == problem.cfg
    assert loaded.dense == problem.dense
    np.testing.assert_array_equal(np.asarray(loaded.b), np.asarray(problem.b))
    np.testing.assert_array_equal(np.asarray(loaded.Q), np.asarray(problem.Q))
    res_a = admm.run_admm(problem)
    res_b = admm.run_admm(loaded)
    np.testing.assert_allclose(np.asarray(res_a.x), np.asarray(res_b.x))


def test_checkpoint_resume_exact(tmp_path):
    problem = loader.build_problem(_cfg(max_iters=8))
    cfg = problem.cfg.admm

    # Full run in one go.
    full = admm.run_admm(problem)

    # Run 4 iterations, checkpoint, reload, continue to 8.
    part = admm.run_admm(problem, until=4)
    path = str(tmp_path / "ckpt.npz")
    serialization.save_checkpoint(path, part.state, part.history)
    state, hist = serialization.load_checkpoint(path)
    assert int(state.k) == 4
    resumed = admm.run_admm(problem, cfg, state=state, hist=hist)

    assert int(resumed.n_iters) == int(full.n_iters) == 8
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(full.x), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(resumed.history["primal"]),
        np.asarray(full.history["primal"]),
        rtol=1e-5,
    )


def test_batched_scenarios():
    problem = loader.build_problem(_cfg(max_iters=4))
    import jax.numpy as jnp

    B = 3
    b_batch = jnp.stack([problem.b * (1.0 + 0.01 * i) for i in range(B)])
    res = admm.run_admm_batched(problem, b_batch)
    assert res.x.shape == (B, 3, 144)
    assert res.history["primal"].shape == (B, 4)
    # Batch element 0 matches the unbatched run.
    single = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(res.x[0]), np.asarray(single.x), rtol=1e-4, atol=1e-4
    )


def test_snapshots(tmp_path):
    problem = loader.build_problem(_cfg(max_iters=6))
    res = admm.run_admm_snapshots(
        problem, snapshot_dir=str(tmp_path), snapshot_every=2
    )
    assert int(res.n_iters) == 6
    files = sorted(p.name for p in tmp_path.glob("*.npy"))
    # Snapshots at iterations 2, 4, 6 for each of 3 nodes.
    assert len(files) == 9
    assert files[0].startswith("iter_0002_")


def test_checkpoint_native_async_roundtrip(tmp_path):
    # The C++ packer's stored-zip .npz must load back bit-identically to
    # the numpy writer's payload (np.load reads both), and resuming from it
    # must reproduce the uninterrupted run exactly.
    import pytest

    from dip_admm_tpu.utils import native_checkpoint as nc

    if not nc.available():
        pytest.skip("native toolchain unavailable")
    problem = loader.build_problem(_cfg(max_iters=8))
    full = admm.run_admm(problem)
    part = admm.run_admm(problem, until=4)

    path_native = str(tmp_path / "ckpt_native.npz")
    path_numpy = str(tmp_path / "ckpt_numpy.npz")
    serialization.save_checkpoint_async(path_native, part.state, part.history)
    serialization.save_checkpoint(path_numpy, part.state, part.history)
    serialization.flush_checkpoints()

    za, zb = np.load(path_native), np.load(path_numpy)
    assert sorted(za.files) == sorted(zb.files)
    for k in zb.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)

    state, hist = serialization.load_checkpoint(path_native)
    assert int(state.k) == 4
    resumed = admm.run_admm(problem, problem.cfg.admm, state=state, hist=hist)
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(full.x), rtol=1e-6, atol=1e-6
    )


def test_checkpoint_native_zip64_roundtrip(tmp_path):
    # Past the zip32 limits the packer must emit zip64 records instead of
    # bowing out to the blocking numpy writer (VERDICT r3 #7). Forcing the
    # cut-over down exercises the zip64 local/central/EOCD paths with small
    # payloads; np.load (python zipfile) reads zip64 natively.
    import pytest

    from dip_admm_tpu.utils import native_checkpoint as nc

    if not nc.available():
        pytest.skip("native toolchain unavailable")
    problem = loader.build_problem(_cfg(max_iters=8))
    part = admm.run_admm(problem, until=4)
    path64 = str(tmp_path / "ckpt_zip64.npz")
    path32 = str(tmp_path / "ckpt_zip32.npz")
    serialization.save_checkpoint_async(path32, part.state, part.history)
    serialization.flush_checkpoints()  # threshold is read at write time
    nc.set_zip64_threshold(256)  # far below every member's size
    try:
        serialization.save_checkpoint_async(path64, part.state, part.history)
        serialization.flush_checkpoints()
    finally:
        nc.set_zip64_threshold(0)

    # zip64 records were genuinely used: EOCD64 signature present.
    raw = (tmp_path / "ckpt_zip64.npz").read_bytes()
    assert b"PK\x06\x06" in raw
    assert b"PK\x06\x06" not in (tmp_path / "ckpt_zip32.npz").read_bytes()

    za, zb = np.load(path64), np.load(path32)
    assert sorted(za.files) == sorted(zb.files)
    for k in zb.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)

    state, hist = serialization.load_checkpoint(path64)
    assert int(state.k) == 4
    resumed = admm.run_admm(problem, problem.cfg.admm, state=state, hist=hist)
    full = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(full.x), rtol=1e-6, atol=1e-6
    )


def test_checkpoint_native_chunked_crc(tmp_path):
    # zlib's crc32 length argument is 32-bit: a single call over a >=4 GiB
    # member computes the CRC of size mod 2^32 bytes, so np.load would
    # reject exactly the checkpoints the zip64 path enables (ADVICE r4
    # high). The packer therefore chunks the CRC; shrinking the chunk far
    # below the member sizes runs that loop many times per member, and the
    # stored CRC field must still equal the whole-buffer zlib.crc32.
    import pytest
    import zipfile
    import zlib

    from dip_admm_tpu.utils import native_checkpoint as nc

    if not nc.available():
        pytest.skip("native toolchain unavailable")
    problem = loader.build_problem(_cfg(max_iters=8))
    part = admm.run_admm(problem, until=4)
    path = str(tmp_path / "ckpt_crcchunk.npz")
    nc.set_crc_chunk(64)  # dozens-to-thousands of chunks per member
    nc.set_zip64_threshold(256)  # combined with the zip64 record paths
    try:
        serialization.save_checkpoint_async(path, part.state, part.history)
        serialization.flush_checkpoints()
    finally:
        nc.set_crc_chunk(0)
        nc.set_zip64_threshold(0)

    # Validate the CRC *field* itself against an independent whole-buffer
    # computation, then let np.load (which verifies CRCs on read) decode.
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            data = zf.read(info.filename)  # raises BadZipFile on CRC error
            assert zlib.crc32(data) & 0xFFFFFFFF == info.CRC, info.filename

    state, hist = serialization.load_checkpoint(path)
    resumed = admm.run_admm(problem, problem.cfg.admm, state=state, hist=hist)
    full = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(full.x), rtol=1e-6, atol=1e-6
    )


def test_checkpoint_orbax_roundtrip(tmp_path):
    problem = loader.build_problem(_cfg(max_iters=6))
    part = admm.run_admm(problem, until=3)
    path = str(tmp_path / "orbax_ckpt")
    serialization.save_checkpoint_orbax(path, part.state, part.history)
    state, hist = serialization.load_checkpoint_orbax(path)
    assert int(state.k) == 3
    resumed = admm.run_admm(problem, problem.cfg.admm, state=state, hist=hist)
    full = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(full.x), rtol=1e-6, atol=1e-6
    )


def test_async_write_failure_raises(tmp_path):
    # A background write that cannot land (tmp path occupied by a directory)
    # must surface in flush_checkpoints, not silently drop the checkpoint.
    import pytest

    from dip_admm_tpu.utils import native_checkpoint as nc

    if not nc.available():
        pytest.skip("native toolchain unavailable")
    problem = loader.build_problem(_cfg(max_iters=4))
    part = admm.run_admm(problem, until=2)
    path = str(tmp_path / "ckpt.npz")
    (tmp_path / "ckpt.npz.tmp").mkdir()  # blocks fopen of the tmp file
    serialization.save_checkpoint_async(path, part.state, part.history)
    with pytest.raises(RuntimeError, match="checkpoint write"):
        serialization.flush_checkpoints()
    # The counter clears: a subsequent good write flushes cleanly.
    (tmp_path / "ckpt.npz.tmp").rmdir()
    serialization.save_checkpoint_async(path, part.state, part.history)
    serialization.flush_checkpoints()
    state, _ = serialization.load_checkpoint(path)
    assert int(state.k) == 2


def test_async_packer_fallback_on_overflow(tmp_path, monkeypatch):
    # Defensive path: if the packer ever raises at submit time (size is no
    # longer a reason — it writes zip64 — but e.g. an unknown rc could),
    # save_checkpoint_async must fall back to the numpy writer, not crash.
    from dip_admm_tpu.utils import native_checkpoint as nc

    problem = loader.build_problem(_cfg(max_iters=4))
    part = admm.run_admm(problem, until=2)
    path = str(tmp_path / "ckpt.npz")
    monkeypatch.setattr(nc, "available", lambda: True)
    monkeypatch.setattr(
        nc, "pack_npz",
        lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("cp_commit failed (rc=3)")
        ),
    )
    serialization.save_checkpoint_async(path, part.state, part.history)
    state, hist = serialization.load_checkpoint(path)
    assert int(state.k) == 2


def test_cfg_json_tolerates_removed_fields():
    # Problems saved under older configs may carry knobs that no longer
    # exist (e.g. the removed NodeSolverConfig.stationarity) — loading must
    # drop them, not crash.
    import json

    cfg = _cfg()
    d = json.loads(serialization._cfg_to_json(cfg))
    d["admm"]["node"]["stationarity"] = "subgrad"
    d["geometry"]["legacy_knob"] = 1
    loaded = serialization._cfg_from_json(json.dumps(d))
    assert loaded == cfg


def test_checkpoint_every_validation(tmp_path):
    import pytest

    from dip_admm_tpu.runners import experiment

    cfg = _cfg(max_iters=2)
    with pytest.raises(ValueError, match="checkpoint_every"):
        experiment.run_one_strategy(
            cfg, str(tmp_path), checkpoint_every=0, write_artifacts=False
        )


def test_problem_roundtrip_with_tables(tmp_path):
    # Persisted projector tables (incl. bf16 leaves as uint16 bit views)
    # must reload bit-exactly and produce the identical operator, skipping
    # the table rebuild.
    import jax
    import jax.numpy as jnp

    cfg = dataclasses.replace(
        _cfg(max_iters=4), fft_table_dtype="bfloat16"
    )
    problem = loader.build_problem(cfg, mode="fft_skew")
    path = str(tmp_path / "problem_tbl.npz")
    serialization.save_problem(problem, path)
    loaded = serialization.load_problem(path)
    assert loaded.mode == "fft_skew"
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        problem.fft_tables, loaded.fft_tables,
    )
    x = jnp.ones((problem.num_nodes, problem.n), problem.b.dtype)
    np.testing.assert_array_equal(
        np.asarray(problem.forward(x)), np.asarray(loaded.forward(x))
    )
    # Without tables the loader falls back to rebuilding them.
    path2 = str(tmp_path / "problem_notbl.npz")
    serialization.save_problem(problem, path2, include_tables=False)
    reloaded = serialization.load_problem(path2)
    np.testing.assert_allclose(
        np.asarray(problem.forward(x)), np.asarray(reloaded.forward(x)),
        rtol=1e-6, atol=1e-6,
    )


def test_fan_skew_problem_roundtrip(tmp_path):
    # Fan-beam fft_skew tables nest the factored-shear parallel stage under
    # shared/par/...; the recursive flatten must round-trip the whole tree.
    import jax
    import jax.numpy as jnp

    from dip_admm_tpu.config import GeometryConfig

    cfg = dataclasses.replace(
        _cfg(max_iters=2),
        geometry=GeometryConfig(
            N=12, num_nodes=2, angles_total=24, fan_beam=True,
            det_width_factor=2.0, src_radius=4.0, det_radius=4.0,
        ),
    )
    problem = loader.build_problem(cfg, mode="fft_skew")
    path = str(tmp_path / "fan_skew.npz")
    serialization.save_problem(problem, path)
    loaded = serialization.load_problem(path)
    assert loaded.mode == "fft_skew"
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)
        ),
        problem.fft_tables, loaded.fft_tables,
    )
    x = jnp.ones((problem.num_nodes, problem.n), problem.b.dtype)
    np.testing.assert_array_equal(
        np.asarray(problem.forward(x)), np.asarray(loaded.forward(x))
    )


def test_batched_scenarios_fcv():
    # The circulant-precond build (impulse probe + power method) must
    # compose with the whole-run vmap of scenario batching.
    import dataclasses as dc

    import jax.numpy as jnp

    cfg = _cfg(max_iters=4)
    cfg = dc.replace(
        cfg, admm=dc.replace(
            cfg.admm, node=dc.replace(cfg.admm.node, algorithm="fcv")
        )
    )
    problem = loader.build_problem(cfg)
    B = 2
    b_batch = jnp.stack([problem.b * (1.0 + 0.01 * i) for i in range(B)])
    res = admm.run_admm_batched(problem, b_batch)
    assert res.x.shape == (B, 3, 144)
    single = admm.run_admm(problem)
    np.testing.assert_allclose(
        np.asarray(res.x[0]), np.asarray(single.x), rtol=1e-4, atol=1e-4
    )


def test_pre_r5_bundle_backfills_wtt(tmp_path):
    """Problem bundles saved before round 5 carry only the t-major tap
    table Wt; the skew kernels now read the d-major WtT. load_problem must
    derive it (code-review r5 finding: a KeyError otherwise)."""
    import jax.numpy as jnp

    cfg = _cfg(max_iters=4)
    problem = loader.build_problem(cfg, mode="fft_skew")
    path = str(tmp_path / "old_bundle.npz")
    # Simulate a pre-r5 bundle: re-save with WtT stripped and Wt present
    # (round-5 skew tables drop Wt, so re-add the t-major layout).
    tables = dict(problem.fft_tables)
    tables["Wt"] = jnp.transpose(tables.pop("WtT"), (0, 1, 3, 2, 4))
    old = dataclasses.replace(problem, fft_tables=tables)
    serialization.save_problem(old, path)
    loaded = serialization.load_problem(path)
    assert "WtT" in loaded.fft_tables
    x = jnp.ones((problem.num_nodes, problem.n), problem.b.dtype)
    np.testing.assert_allclose(
        np.asarray(problem.forward(x)), np.asarray(loaded.forward(x)),
        rtol=1e-6, atol=1e-6,
    )
