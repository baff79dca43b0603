"""Fidelity-mode RBPF: every particle carries its own map.

This is the reference's actual algorithm — `Particle{pose, weight, cv::Mat
map}` (`slam/pose.h:32-37`), weighting fused with per-particle mapping
(`slam/mcl.cpp:49-77` -> `slam/raycast.cpp:143-223`), and map deep-copies on
resample (`slam/mcl.cpp:205-227`). It costs N x H x W bytes, which is why
the production architecture uses the shared grid (slam_tpu.models.slam);
this mode exists for small-N A/B fidelity against the C++ behavior
(SURVEY.md section 7 item 2).

The maps are uint8 quantized P(free) with the reference's multiplicative
clamped updates (floor 1/255, init 128 = 0.5); resampling "copies" maps by a
single batched gather — the vectorized form of the reference's core-pinned
deep-copy threads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from slam_tpu.core import struct

from slam_tpu.core.config import MCLConfig, RaycastConfig
from slam_tpu.core.types import Odometry, Particles, Pose, Scan
from slam_tpu.models import mcl as mcl_mod
from slam_tpu.ops import mapping, motion, resample


@struct.dataclass
class RBPFState:
    particles: Particles
    maps: jax.Array  # u8[N, H, W] per-particle P(free) maps
    key: jax.Array
    best_pose: Pose
    best_map_idx: jax.Array  # i32 index of the best particle's map
    step: jax.Array


def init(key, n_particles: int, pose: Pose, shape) -> RBPFState:
    """All particles at `pose`, uniform-gray maps (`slam/mcl.cpp:27-39`)."""
    h, w = shape
    return RBPFState(
        particles=Particles.uniform_at(pose, n_particles),
        maps=jnp.full((n_particles, h, w), 128, jnp.uint8),
        key=key,
        best_pose=pose,
        best_map_idx=jnp.int32(0),
        step=jnp.int32(0),
    )


def step(
    state: RBPFState,
    odom: Odometry,
    scan: Scan,
    cfg: MCLConfig,
    rc: RaycastConfig,
) -> RBPFState:
    """One full RBPF step: predict -> fused weight+map -> resample."""
    key, k_mot, k_rs = jax.random.split(state.key, 3)

    pose = motion.sample_motion_model_odometry(
        k_mot, odom, state.particles.pose, jnp.asarray((5e-4, 5e-4, 1e-2, 1e-2))
    )

    lw, new_maps = mapping.fidelity_measurement_and_mapping(
        state.maps,
        pose,
        scan,
        scanner_offset=cfg.scanner_offset,
        stddev=cfg.meas_stddev,
        eps=cfg.meas_epsilon,
        max_dist=rc.max_dist,
        step=rc.step,
    )
    log_weight = state.particles.log_weight + lw
    best_idx = jnp.argmax(log_weight)
    best_pose = jax.tree.map(lambda a: a[best_idx], pose)

    # Resample particles AND their maps (the reference's threaded map
    # deep-copies, `slam/mcl.cpp:205-227`, as one gather).
    if cfg.resample == "multinomial":
        idx = resample.multinomial_indices(k_rs, log_weight)
    else:
        idx = resample.systematic_indices(k_rs, log_weight)
    n = log_weight.shape[0]
    new_pose = jax.tree.map(lambda a: a[idx], pose)
    new_maps = new_maps[idx]
    # A surviving copy of the best particle; under multinomial resampling the
    # best particle can draw zero copies, in which case fall back to the
    # highest-weight particle that DID survive (ADVICE r1).
    best_map_idx = jnp.where(
        jnp.any(idx == best_idx),
        jnp.argmax(idx == best_idx),
        jnp.argmax(log_weight[idx]),
    )

    return RBPFState(
        particles=Particles(
            pose=new_pose,
            log_weight=jnp.full((n,), -jnp.log(n), jnp.float32),
        ),
        maps=new_maps,
        key=key,
        best_pose=best_pose,
        best_map_idx=best_map_idx,
        step=state.step + 1,
    )


def best_map_prob_free(state: RBPFState) -> jax.Array:
    """f32[H, W] P(free) of the best particle's map — what the reference
    renders (`apps/grid_slam.cpp:112`)."""
    return state.maps[state.best_map_idx].astype(jnp.float32) / 255.0


class RBPF:
    """Jitted wrapper (cfg static)."""

    def __init__(self, cfg: MCLConfig, rc: RaycastConfig = RaycastConfig(), seed: int = 0):
        self.cfg = cfg
        self.rc = rc
        self._step = jax.jit(lambda s, o, z: step(s, o, z, cfg, rc))
        self._key = jax.random.key(seed)

    def init(self, pose: Pose, shape) -> RBPFState:
        return init(self._key, self.cfg.n_particles, pose, shape)

    def step(self, state, odom: Odometry, scan: Scan) -> RBPFState:
        return self._step(state, odom, scan)


def mean_pose(state: RBPFState) -> Pose:
    from slam_tpu.core import stats

    x, y, th = stats.average_pose(
        state.particles.pose.x, state.particles.pose.y, state.particles.pose.theta
    )
    return Pose(x=x, y=y, theta=th)
