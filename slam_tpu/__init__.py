"""slam_tpu: an accelerator-native 2D grid-SLAM framework.

Built from scratch in JAX/XLA with the capabilities of the C++
reference (ferasboulala/slam): Monte-Carlo localization with occupancy-grid
mapping, a simulated lidar, and motion planners (A*, Hybrid A*, RRT*) —
re-designed as vectorized, compiler-friendly programs over device meshes
rather than a translation of the reference's pointer/thread-based C++.

Layer map (mirrors SURVEY.md section 1, rebuilt accelerator-first):
  core/      — SoA pose/particle types, grid coordinate transforms, math
  ops/       — vectorized kernels: motion sampling, raycast, beam model,
               log-odds mapping, resampling, batched spatial queries
  models/    — MCL particle filter, grid SLAM, fake lidar, planners
  parallel/  — jax.sharding mesh helpers, sharded MCL step, collectives
  utils/     — map IO, rendering, config, logging, checkpointing, bench
"""

__version__ = "0.1.0"

from slam_tpu.core.types import Odometry, Pose, Velocity  # noqa: F401
