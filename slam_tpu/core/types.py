"""Core SoA pose/particle types.

The reference keeps AoS structs (`slam/pose.h:7-45`: Pose{x,y,theta},
Odometry, Velocity, Particle{pose, weight, cv::Mat map}). On an
accelerator the idiomatic layout is structure-of-arrays pytrees so every phase of the filter
vectorizes over the particle axis and shards cleanly over a device mesh.

All fields are JAX arrays with an arbitrary (shared) leading batch shape, so
the same type describes a single pose (shape ()) or N particles (shape (N,)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from slam_tpu.core import struct


@struct.dataclass
class Pose:
    """SE(2) pose(s): world coordinates, y-up, theta in radians."""

    x: jax.Array
    y: jax.Array
    theta: jax.Array

    @classmethod
    def create(cls, x, y, theta, dtype=jnp.float32) -> "Pose":
        return cls(
            x=jnp.asarray(x, dtype),
            y=jnp.asarray(y, dtype),
            theta=jnp.asarray(theta, dtype),
        )

    @property
    def batch_shape(self):
        return self.x.shape

    def replace_theta(self, theta) -> "Pose":
        return self.replace(theta=jnp.asarray(theta, self.theta.dtype))


@struct.dataclass
class Odometry:
    """Relative motion decomposed as rotate(rot1) -> translate -> rotate(rot2).

    Matches the reference's Odometry{rotation_1, translation, rotation_2}
    (`slam/pose.h:19-24`).
    """

    rot1: jax.Array
    trans: jax.Array
    rot2: jax.Array

    @classmethod
    def create(cls, rot1, trans, rot2, dtype=jnp.float32) -> "Odometry":
        return cls(
            rot1=jnp.asarray(rot1, dtype),
            trans=jnp.asarray(trans, dtype),
            rot2=jnp.asarray(rot2, dtype),
        )


@struct.dataclass
class Velocity:
    """Differential-drive command: linear v, angular w (`slam/pose.h:26-30`)."""

    v: jax.Array
    w: jax.Array

    @classmethod
    def create(cls, v, w, dtype=jnp.float32) -> "Velocity":
        return cls(v=jnp.asarray(v, dtype), w=jnp.asarray(w, dtype))


@struct.dataclass
class Particles:
    """SoA particle set: poses plus unnormalized log-weights.

    Replaces `vector<Particle>` (`slam/pose.h:32-37`). Per-particle maps (the
    reference's `cv::Mat map` member) are deliberately NOT part of this type:
    the shared-map architecture keeps one log-odds grid for the filter, and
    the small-N fidelity mode carries maps separately as a `u8/f32 [N,H,W]`
    array (see slam_tpu.models.mcl).
    """

    pose: Pose
    log_weight: jax.Array

    @property
    def n(self) -> int:
        return self.pose.x.shape[0]

    @classmethod
    def uniform_at(cls, pose: Pose, n: int, dtype=jnp.float32) -> "Particles":
        """All particles at one pose with uniform weights (`slam/mcl.cpp:27-39`)."""
        ones = jnp.ones((n,), dtype)
        return cls(
            pose=Pose(
                x=ones * pose.x, y=ones * pose.y, theta=ones * pose.theta
            ),
            log_weight=jnp.full((n,), -jnp.log(n), dtype),
        )


@struct.dataclass
class Scan:
    """A lidar scan as parallel arrays: beam angles (relative to the sensor
    heading) and measured ranges. Max-range misses are encoded as
    ``dist == max_dist`` exactly, as the reference app does
    (`apps/grid_slam.cpp:147-166`).
    """

    angles: jax.Array  # f32[B]
    dists: jax.Array  # f32[B]

    @property
    def n_beams(self) -> int:
        return self.angles.shape[0]


class Box:
    """Inclusive image-coordinate box (`slam/pose.h:39-45`), host-side."""

    __slots__ = ("start_i", "start_j", "stop_i", "stop_j")

    def __init__(self, start_i: int, start_j: int, stop_i: int, stop_j: int):
        self.start_i = start_i
        self.start_j = start_j
        self.stop_i = stop_i
        self.stop_j = stop_j
