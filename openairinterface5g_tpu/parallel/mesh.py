"""Device mesh + sharding helpers (C7/C8/C11 analog).

The reference scales by splitting RU from L1 over fronthaul and MAC from
PHY over nFAPI UDP (SURVEY.md C7/C8); the equivalents here are mesh
axes, which follow the algorithm (the devices are joined all to all):
  dp — slots / Monte-Carlo trials / UEs (data parallel)
  cb — code blocks within a TB (the reference's per-CB thread jobs)
  sp — subcarrier blocks (fronthaul-split analog; FFT halo = CP)
Collectives are jax.lax calls under shard_map.
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(n_devices: int | None = None, axis: str = "dp") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=(axis,))


def make_mesh_2d(dp: int, cb: int) -> Mesh:
    devs = np.array(jax.devices()[: dp * cb]).reshape(dp, cb)
    return Mesh(devs, axis_names=("dp", "cb"))


def shard_batch(mesh: Mesh, x, axis: str = "dp"):
    """Place array with its leading dim sharded over `axis`."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))
