"""Device-mesh construction.

The reference has no communication backend at all — its "distributed" nodes
are entries of Python dicts in one process (SURVEY §2.2). Here graph nodes
are sharded over a ``jax.sharding.Mesh`` axis ``"node"``; on multi-host
systems the same axis simply spans hosts (collectives ride NVLink within a
host and the network across hosts — XLA picks the transport from the mesh).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as PS

NODE_AXIS = "node"
# Optional second mesh axis sharding the [P_loc, P, n] edge state (Z/Y/Q)
# along the pixel dim — the memory ceiling once the node axis is exhausted
# (per-pixel consensus is embarrassingly parallel; node solves keep full
# images and replicate along this axis).
PIXEL_AXIS = "pixel"

def table_partition_specs(tables, num_nodes: int):
    """PartitionSpec pytree for a projector-table pytree: THE single source
    of truth for table placement, used by both the shard_map runtime
    (``admm_sharded`` in_specs) and host-side placement
    (``multihost.distribute_problem``), so the two can never disagree.

    Rule: every leaf under a ``"shared"`` subtree is node-shared geometry
    (fft_skew's DFT-back and tail twiddles, the fan path's single-set
    parallel tables and rebin/DFT filters) and replicates; everything else
    is per-node and shards by its leading node axis. The subtree marker
    exists because a shared leaf's leading dim can coincide with the node
    count (e.g. PhiD [16, F] on a 16-node graph) — a shape heuristic alone
    would shard it."""

    def spec(path, leaf):
        if any(getattr(p, "key", None) == "shared" for p in path):
            return PS()
        if getattr(leaf, "ndim", 0) > 0 and leaf.shape[0] == num_nodes:
            return PS(NODE_AXIS)
        return PS()

    return jax.tree_util.tree_map_with_path(spec, tables)


def make_mesh(n_devices: int | None = None, pixel: int = 1) -> Mesh:
    """1-D node mesh, or a 2-D (node x pixel) mesh when ``pixel`` > 1.

    ``n_devices`` counts the NODE axis; total devices used =
    ``n_devices * pixel``. Consecutive devices land on the pixel axis (the
    per-iteration pixel all_gather runs between neighbouring devices)."""
    devices = jax.devices()
    n_node = n_devices if n_devices is not None else len(devices) // pixel
    need = n_node * pixel
    if need > len(devices):
        raise ValueError(
            f"requested {n_node}x{pixel} devices, only {len(devices)} present"
        )
    if pixel == 1:
        return Mesh(np.asarray(devices[:need]), (NODE_AXIS,))
    grid = np.asarray(devices[:need]).reshape(n_node, pixel)
    return Mesh(grid, (NODE_AXIS, PIXEL_AXIS))


def shards_for(num_nodes: int, mesh: Mesh) -> int:
    """Nodes per device; the node count must tile the mesh axis."""
    n_dev = mesh.shape[NODE_AXIS]
    if num_nodes % n_dev != 0:
        raise ValueError(
            f"num_nodes={num_nodes} must be divisible by mesh size {n_dev}"
        )
    return num_nodes // n_dev
