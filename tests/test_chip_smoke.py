"""``chip_smoke.py``: it refuses to report without a GPU, and ``--four``
runs the four-card sharded phase alone."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_exits_nonzero_without_gpu(argv):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "DIP_ADMM_NO_XLA_CACHE": "1"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py", *argv], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_four_selects_only_the_sharded_phase():
    phases = [phase for phase, _ in chip_smoke.plan(True)]
    assert phases and set(phases) == {chip_smoke.phase_sharded}


def test_one_card_plan_runs_phases_b_to_e():
    phases = chip_smoke.plan(False)
    assert chip_smoke.phase_sharded not in {p for p, _ in phases}
    names = [a[0] for p, a in phases if p is chip_smoke.phase_cli]
    assert names == ["c/flagship", "d/recommended", "d/parity", "e/fan"]
    assert [a for p, a in phases if p is chip_smoke.phase_parity] == [
        (256, 8, False), (512, 32, True)]


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_card(gpu):
    """The whole smoke run on the card (python -m pytest -m gpu)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
