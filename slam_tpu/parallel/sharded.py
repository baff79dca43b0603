"""Sharded (multi-device) particle filter and grid SLAM.

Vectorized replacement for the reference's pthread particle fan-out
(`slam/mcl.cpp:108-144`): the particle axis of the SoA state is sharded over
the 'p' mesh axis, the [N, B] ray batch of each measurement update is
additionally split over the 'b' axis, and the occupancy grid is replicated
(it is small — the reference's own maps are ≤1297×599 u8). The step functions
are the SAME pure functions as the single-chip path (slam_tpu.models.mcl /
.slam); parallelism enters only through shardings — GSPMD inserts the
collectives (psum for the beam-axis log-weight reduction and weight
normalization, all-gather for the cross-shard resampling gather), which is
the idiomatic pjit recipe rather than a translation of the reference's
explicit thread ranges.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_tpu.core.config import MCLConfig, RaycastConfig, SLAMConfig
from slam_tpu.core.types import Odometry, Pose, Scan
from slam_tpu.models import mcl as mcl_mod
from slam_tpu.models import slam as slam_mod
from slam_tpu.parallel import resample as dist_resample


def _resample_fn(mesh: Mesh, cfg: MCLConfig):
    """Reduce-scatter systematic resampler for the sharded engines (no
    [N]-sized all-gather; see slam_tpu.parallel.resample). Multinomial
    fidelity mode keeps the general GSPMD path.

    A trivial particle axis (|p| == 1: one chip, or a beams-only mesh)
    keeps the plain resampler too — its seed-routing scatters cost ~25 ms
    at 1M (measured, shard_bench on one chip: 91 vs 66 ms local) and with
    one shard there is nothing to exchange; the plain path's gather has no
    cross-shard source to all-gather either."""
    if cfg.resample != "systematic" or mesh.shape.get("p", 1) == 1:
        return None
    return lambda key, p: dist_resample.systematic_resample_sharded(
        mesh, key, p
    )


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """[N, ...] arrays sharded over the particle axis."""
    return NamedSharding(mesh, P("p"))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """[N, B] ray batches sharded over both mesh axes."""
    return NamedSharding(mesh, P("p", "b"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def state_shardings(state, mesh: Mesh, n_particles: int):
    """Sharding pytree for an MCL/SLAM state: leaves whose leading axis is
    the particle axis go to P('p'), everything else is replicated."""
    p = particle_sharding(mesh)
    r = replicated(mesh)

    def spec(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == n_particles:
            return p
        return r

    return jax.tree.map(spec, state)


def shard_state(state, mesh: Mesh, n_particles: int):
    """Place a host/single-device state onto the mesh."""
    return jax.device_put(state, state_shardings(state, mesh, n_particles))


class ShardedMCL:
    """Multi-chip MCL localization (static map).

    Usage:
        mesh = make_mesh()
        m = ShardedMCL(mesh, cfg, rc)
        state = m.init(h, w)            # sharded over the mesh
        state = m.predict(state, odom, alphas)
        state = m.update(state, scan, blocked)
    """

    def __init__(self, mesh: Mesh, cfg: MCLConfig, rc: RaycastConfig = RaycastConfig()):
        self.mesh = mesh
        self.cfg = cfg
        self.rc = rc
        rs = ray_sharding(mesh)
        rfn = _resample_fn(mesh, cfg)
        self._predict = jax.jit(mcl_mod.predict)
        self._update = jax.jit(
            lambda s, scan, blocked: mcl_mod.update(
                s, scan, blocked, cfg, rc, ray_sharding=rs, resample_fn=rfn
            )
        )

    def init(self, h: int, w: int, seed: int = 0) -> mcl_mod.MCLState:
        state = mcl_mod.init(
            jax.random.key(seed), self.cfg.n_particles, mcl_mod.starting_pose(h, w)
        )
        return shard_state(state, self.mesh, self.cfg.n_particles)

    def predict(self, state, odom: Odometry, alphas):
        return self._predict(state, odom, jnp.asarray(alphas))

    def update(self, state, scan: Scan, blocked):
        return self._update(state, scan, blocked)


class ShardedGridSLAM:
    """Multi-chip full grid SLAM (particles sharded, log-odds grid replicated).

    The full step (predict + weight + estimate + map + resample) is one jitted
    SPMD program over the mesh.
    """

    def __init__(self, mesh: Mesh, cfg: SLAMConfig):
        self.mesh = mesh
        self.cfg = cfg
        rs = ray_sharding(mesh)

        def make_step(c):
            rfn = _resample_fn(mesh, c.mcl)
            return jax.jit(
                lambda s, o, z: slam_mod.step(
                    s, o, z, c, ray_sharding=rs, resample_fn=rfn
                )
            )

        self._auto = None
        if cfg.mcl.measurement == "likelihood_field_auto":
            # Host-lagged tier dispatch (slam.AutoTierDispatcher) instead
            # of an in-program lax.cond; the predicate's reductions psum
            # over the sharded particle axis like every other cloud
            # statistic.
            self._auto = slam_mod.AutoTierDispatcher(cfg, make_step)
        else:
            self._step = make_step(cfg)
        self._predict = jax.jit(
            lambda s, o: slam_mod.predict_only(s, o, cfg)
        )

    def init(self, pose: Pose | None = None, seed: int = 0) -> slam_mod.SLAMState:
        if self._auto is not None:
            self._auto.reset()
        state = slam_mod.init(jax.random.key(seed), self.cfg, pose)
        return shard_state(state, self.mesh, self.cfg.mcl.n_particles)

    def step(self, state, odom: Odometry, scan: Scan):
        if self._auto is not None:
            return self._auto.step(state, odom, scan)
        return self._step(state, odom, scan)

    def predict(self, state, odom: Odometry):
        return self._predict(state, odom)
