"""Multi-host (DCN) initialization helpers.

The reference splits RU/L1 across hosts over fronthaul Ethernet and
MAC/PHY over nFAPI UDP (SURVEY.md C7/C8).  Here both become a
bigger mesh: jax.distributed joins N hosts into one device namespace and
the same shard_map programs from parallel/sharded.py / pusch_sp.py run
unchanged — subcarrier blocks and code blocks land on devices that may
be on different hosts, with XLA running the collectives within a host
and across hosts.

Single-host round-1 environments cannot exercise this live; the entry
point is here so a multi-host deployment is `init_multihost()` +
existing code.
"""
from __future__ import annotations

import os


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join the jax.distributed cluster (no-op if already initialized or
    running single-process).

    Args default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers stay thin.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=process_id or int(os.environ.get("JAX_PROCESS_ID", "0")),
    )


def global_mesh(axis: str = "dp"):
    """Mesh over every device in the (possibly multi-host) cluster."""
    import numpy as np

    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=(axis,))
