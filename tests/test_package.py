"""Package-level contracts: where the persistent compilation cache lives,
and what importing the CLI path pulls in."""

import os
import subprocess
import sys

import pytest

import dip_admm_tpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "environ, expect",
    [
        ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),  # JAX's own
        ({}, os.path.join(ROOT, ".jax_cache")),  # fixed in-checkout path
        ({"DIP_ADMM_NO_XLA_CACHE": "1"}, None),  # opt-out
    ],
)
def test_compilation_cache_rule(environ, expect):
    assert dip_admm_tpu.compilation_cache_dir(environ) == expect


def _child(code, **env):
    base = {k: v for k, v in os.environ.items()
            if k not in ("JAX_COMPILATION_CACHE_DIR", "DIP_ADMM_NO_XLA_CACHE")}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env={**base, **env},
        capture_output=True, text=True, timeout=300, check=True,
    )
    return out.stdout.strip().splitlines()[-1]


def test_import_points_jax_at_the_cache(tmp_path):
    code = ("import dip_admm_tpu, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    assert _child(code, JAX_PLATFORMS="cpu") == os.path.join(ROOT, ".jax_cache")
    assert _child(code, JAX_PLATFORMS="cpu",
                  JAX_COMPILATION_CACHE_DIR=str(tmp_path)) == str(tmp_path)


def test_cli_path_imports_no_pallas_or_matplotlib():
    code = (
        "import sys; import dip_admm_tpu.runners.cli, "
        "dip_admm_tpu.runners.experiment, dip_admm_tpu.parallel.admm_sharded; "
        "print([m for m in sys.modules if 'pallas' in m "
        "or m.startswith('matplotlib')])"
    )
    assert _child(code, JAX_PLATFORMS="cpu",
                  DIP_ADMM_NO_XLA_CACHE="1") == "[]"
