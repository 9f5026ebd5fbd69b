"""dip_admm_tpu — decentralized consensus-ADMM framework in JAX for
TV-regularized least-squares tomographic inverse problems.

A from-scratch JAX/XLA re-design of the capabilities of
prsinha1/Distributed-Inverse-Problem-Admm (see SURVEY.md):

- ``ops``      : Radon projectors (dense + matrix-free), TV operators/prox,
                 batched linear algebra (CG, power method).
- ``graph``    : per-pixel communication graphs (knn / mst / chain) and
                 precision weights W_i / Q_ij (harmonic & arithmetic means).
- ``core``     : the consensus ADMM runtime — vmapped inexact node solver
                 (Condat-Vu primal-dual) and the jitted edge-consensus loop.
- ``parallel`` : device mesh + shard_map collectives (all_to_all dual
                 exchange, psum residual reduction) for multi-device/multi-host.
- ``solvers``  : alternative solver families — PDHG penalized-consensus,
                 centralized aggregate baseline, node/edge-objective graph API.
- ``data``     : problem construction (phantoms, operators, sinograms) and
                 serialization/checkpointing.
- ``runners``  : experiment orchestration + artifact writers (block-7 parity).

The reference executes its "distributed" graph sequentially in one Python
process; here the node axis is sharded over a ``jax.sharding.Mesh`` and edge
consensus is a masked pairwise-average collective between devices.
"""

import os

__version__ = "0.1.0"

# Fixed in-checkout location of the persistent compilation cache: the path is
# part of what a later process must find again, so it never moves.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def compilation_cache_dir(environ=os.environ):
    """Directory this package points JAX's persistent compilation cache at,
    or None to set nothing: JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself
    when it is set, and ``DIP_ADMM_NO_XLA_CACHE`` opts out (the CPU test
    suite). Otherwise ``<checkout>/.jax_cache``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR") or environ.get(
        "DIP_ADMM_NO_XLA_CACHE"
    ):
        return None
    return CACHE_DIR


def _enable_compilation_cache() -> None:
    """Problem construction compiles several independent programs (tables,
    forward, colnorms, graph, opnorms); the persistent cache lets every
    process after the first skip them."""
    path = compilation_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)


_enable_compilation_cache()

from dip_admm_tpu.config import (  # noqa: F401
    GeometryConfig,
    GraphConfig,
    NodeSolverConfig,
    AdmmConfig,
    ProblemConfig,
)
