"""Multi-host execution support.

The reference has no transport at all (SURVEY §2.2); the sharded runtime in
``parallel.admm_sharded`` is host-count-agnostic — the node mesh axis simply
spans all global devices, and XLA routes the ``all_to_all``/``psum``
collectives over NVLink within a host and the network across hosts. This
module holds the host-side plumbing that makes that work:

- ``initialize()``: ``jax.distributed`` bring-up (coordinator discovery via
  env or explicit args) — call once per process before any jax op.
- ``global_mesh()``: a 1-D node mesh over all global devices, ordered so
  consecutive node blocks are intra-host first (keeps the heavy half of the
  pair-transpose all_to_all on NVLink).
- ``distribute_problem()``: device_put every Problem array with its
  PartitionSpec so a multi-host jit consumes addressable shards only.

Single-host multi-device behaves identically (jax.distributed not required),
which is how the CPU-mesh tests exercise this path.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

from dip_admm_tpu.data.loader import Problem
from dip_admm_tpu.parallel.mesh import NODE_AXIS, table_partition_specs


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed (no-op if single-process / already up)."""
    if jax.process_count() > 1:
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        return  # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D node mesh over all global devices, host-major ordering."""
    devices = sorted(
        jax.devices(), key=lambda d: (d.process_index, d.id)
    )
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (NODE_AXIS,))


def problem_shardings(problem: Problem, mesh: Mesh):
    """PartitionSpec pytree matching run_admm_sharded's input contract.

    Table leaves use the SAME key-/shape-based rule as the shard_map
    runtime (``mesh.table_partition_specs``): per-node tables shard over
    the node axis, node-shared geometry (fft_skew DFT/twiddle tables, the
    fan path's single-set parallel tables and rebin filters) replicates —
    placement and in_specs can never disagree."""
    node = PS(NODE_AXIS)
    repl = PS()
    specs = dict(
        angles=node, angle_valid=node, A=node if problem.A is not None else None,
        b=node, W=node, Q=node, keep=node, adj=node,
        x_true=repl, opnorm=node,
        fft_tables=(
            table_partition_specs(problem.fft_tables, problem.num_nodes)
            if problem.fft_tables is not None
            else None
        ),
    )
    return specs


def distribute_problem(problem: Problem, mesh: Mesh) -> Problem:
    """device_put each array with its sharding (multi-host: every process
    passes the same global arrays; jax shards them addressably)."""
    import dataclasses

    specs = problem_shardings(problem, mesh)

    def put(x, spec):
        if x is None or spec is None:
            return x
        return jax.device_put(x, NamedSharding(mesh, spec))

    updates = {}
    for name, spec in specs.items():
        val = getattr(problem, name)
        if name == "fft_tables":
            if val is not None:
                updates[name] = jax.tree.map(
                    lambda a, s: put(a, s), val, spec
                )
            continue
        updates[name] = put(val, spec)
    return dataclasses.replace(problem, **updates)
