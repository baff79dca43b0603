"""Multi-robot MCL: R independent filters on ONE shared map, one program.

The reference runs one filter per process (`slam/mcl.h:12-46`); the
serving configuration batches a whole fleet. Stacking R robots' [N]
panorama row gathers into one [R, N] stream amortizes the per-step fixed
costs across the fleet, and the map/LUT is shared once in device memory.

Everything is `jax.vmap` over the pure single-filter step (models/mcl.py),
so fleet numerics match R independent filters EXACTLY (same per-robot
keys; `lax.cond` resampling lowers to compute-both+select under vmap,
which changes cost, not values) — asserted by tests/test_fleet.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_tpu.core.config import MCLConfig, RaycastConfig
from slam_tpu.core.types import Odometry, Pose, Scan
from slam_tpu.models import mcl as mcl_mod


def init_fleet(key, n_robots: int, n_particles: int, poses: Pose):
    """Stacked MCLState for R filters; `poses` carries batch shape [R]."""
    keys = jax.random.split(key, n_robots)
    return jax.vmap(mcl_mod.init, in_axes=(0, None, 0))(
        keys, n_particles, poses
    )


def fleet_step(states, odoms: Odometry, scans: Scan, field, alphas,
               cfg: MCLConfig, rc: RaycastConfig):
    """One predict+update step for every robot ([R]-stacked pytrees); the
    map/`field` is shared (unbatched)."""

    def one(st, od, sc):
        st = mcl_mod.predict(st, od, alphas)
        return mcl_mod.update(st, sc, field, cfg, rc)

    return jax.vmap(one, in_axes=(0, 0, 0))(states, odoms, scans)


class MCLFleet:
    """Facade: R reference-API filters advanced in lockstep on one chip."""

    def __init__(
        self,
        n_robots: int,
        cfg: MCLConfig,
        rc: RaycastConfig = RaycastConfig(),
        seed: int = 0,
    ):
        self.n_robots = n_robots
        self.cfg = cfg
        self.rc = rc
        self._key = jax.random.key(seed)
        self._step = jax.jit(
            lambda st, od, sc, field, alphas: fleet_step(
                st, od, sc, field, alphas, cfg, rc
            )
        )

    def init(self, poses: Pose):
        return init_fleet(
            self._key, self.n_robots, self.cfg.n_particles, poses
        )

    def step(self, states, odoms: Odometry, scans: Scan, field, alphas):
        return self._step(states, odoms, scans, field, jnp.asarray(alphas))


def mean_poses(states) -> Pose:
    """[R]-batched circular-mean poses."""
    return jax.vmap(mcl_mod.mean_pose)(states)
