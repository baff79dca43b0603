"""Sharded multi-robot MCL fleet: robots over the 'p' mesh axis.

The fleet axis is embarrassingly parallel (robots share only the read-only
map), so the multi-GPU serving layout is the simplest possible sharding:
stack R filters (slam_tpu.models.fleet) and place every [R, ...] state leaf
on P('p'). GSPMD partitions the vmapped step with zero cross-robot
collectives — each device advances its robots independently while the
LUT/EDT stays replicated (or block-sharded via parallel.mapshard for huge
maps). Contrast with ShardedMCL, which shards ONE filter's particle axis
and needs the reduce-scatter resampler; a fleet of modest filters needs
neither.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_tpu.core.config import MCLConfig, RaycastConfig
from slam_tpu.core.types import Pose
from slam_tpu.models import fleet as fleet_mod


def robot_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("p"))


def shard_fleet(mesh: Mesh, states):
    """Place [R, ...]-stacked fleet states with robots over 'p'."""
    r = robot_sharding(mesh)

    def put(leaf):
        spec = P(*(("p",) + (None,) * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree.map(put, states)


class ShardedMCLFleet(fleet_mod.MCLFleet):
    """MCLFleet whose robot axis lives on a device mesh. `n_robots` must be
    divisible by the 'p' axis size."""

    def __init__(
        self,
        mesh: Mesh,
        n_robots: int,
        cfg: MCLConfig,
        rc: RaycastConfig = RaycastConfig(),
        seed: int = 0,
    ):
        p_size = mesh.shape["p"]
        if n_robots % p_size != 0:
            raise ValueError(
                f"n_robots {n_robots} not divisible by mesh 'p' axis {p_size}"
            )
        super().__init__(n_robots, cfg, rc, seed)
        self.mesh = mesh

    def init(self, poses: Pose):
        # Steps need no re-placement: the robot axis has no cross-robot
        # collectives, so GSPMD propagates the input sharding to outputs.
        return shard_fleet(self.mesh, super().init(poses))
