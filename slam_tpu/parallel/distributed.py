"""Multi-host runtime initialization.

The reference is single-machine pthreads only (SURVEY.md section 2); this
framework scales across hosts with `jax.distributed` + a mesh whose
particle axis spans all GPUs. Each host runs the same program; after
`initialize()`, `jax.devices()` is global and the sharded engines in
slam_tpu.parallel work unchanged — within a host the GPUs are joined all
to all by NVLink, so XLA's collectives (NCCL) carry the beam-axis psum
there, and the (rare) cross-host resampling exchanges cross the network.

Data feeding: each host simulates/ingests scans for its own shard via
`host_local_slice`, or host 0 broadcasts via `multihost_utils` (scans are a
few KB; broadcast is the simple default).

Single-process testing: the 8-device virtual CPU mesh (tests/conftest.py)
exercises the same code path; this module only wires process discovery.
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the jax.distributed runtime. Nothing in a plain GPU cluster
    tells JAX its layout: pass ``coordinator_address`` (``host:port`` of
    process 0), ``num_processes`` and ``process_id`` explicitly, unless a
    cluster manager JAX detects (e.g. SLURM) provides them."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def is_multihost() -> bool:
    return jax.process_count() > 1


def host_local_slice(n_global: int) -> slice:
    """The [start, stop) range of a length-n_global particle axis owned by
    this process under even 'p'-axis sharding."""
    per = n_global // jax.process_count()
    start = jax.process_index() * per
    return slice(start, start + per)


def replicate_to_all_hosts(tree):
    """Host-local pytree -> globally replicated arrays (broadcast from
    process 0). Thin wrapper so callers need no multihost_utils import."""
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(tree)
