"""Particle resampling as prefix sums + searchsorted.

The reference resamples multinomially with a serial cumulative sum and a
per-draw binary search (`slam/mcl.cpp:157-203`, O(N log N) scalar), then
deep-copies maps across core-pinned threads. Here the cumulative distribution
is one vectorized cumsum, draws are a batched `searchsorted`, and "copying"
a particle is a gather over the SoA state — no maps to clone in shared-map
mode.

Two selection schemes:
  * `multinomial_indices` — reference fidelity (independent draws);
  * `systematic_indices` — low-variance/systematic resampling (the upgrade
    SURVEY.md section 5 quirk 2 names; the notebook prototype's direction).

Plus augmented-MCL adaptive random-particle injection (notebook cell 9) and
the ESS trigger for optional resample throttling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_tpu.core import grid as gridlib
from slam_tpu.core.types import Particles, Pose


def normalized_weights(log_w):
    return jax.nn.softmax(log_w)


def effective_sample_size(log_w):
    """ESS = 1 / sum(w_i^2) for normalized w."""
    w = normalized_weights(log_w)
    return 1.0 / jnp.sum(w * w)


def multinomial_indices(key, log_w):
    """N independent draws from the weight distribution — the reference's
    `probabilistic_fitness_selection` (`slam/mcl.cpp:157-203`)."""
    n = log_w.shape[0]
    c = jnp.cumsum(normalized_weights(log_w))
    u = jax.random.uniform(key, (n,)) * c[-1]
    return jnp.clip(jnp.searchsorted(c, u, side="left"), 0, n - 1)


def systematic_indices(key, log_w):
    """Low-variance systematic resampling, O(N) without binary search.

    Draw k selects particle i iff c_{i-1} <= (k + u0)/n < c_i, so particle
    i's output range is [ceil(n c_{i-1} - u0), ceil(n c_i - u0)). Those
    range starts are scattered (max of the particle index) and filled with a
    cumulative max — three elementwise passes + one scatter instead of a
    log(N)-deep searchsorted gather chain."""
    n = log_w.shape[0]
    c = jnp.cumsum(normalized_weights(log_w))
    c = c / c[-1]
    u0 = jax.random.uniform(key, ())
    ends = jnp.ceil(n * c - u0).astype(jnp.int32)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32), ends[:-1]])
    occupied = ends > starts  # count > 0
    pos = jnp.where(occupied, jnp.clip(starts, 0, n - 1), n)
    seed = (
        jnp.full((n,), -1, jnp.int32)
        .at[pos]
        .max(jnp.arange(n, dtype=jnp.int32), mode="drop")
    )
    idx = jax.lax.cummax(seed)
    # Guard the (floating-point-edge) case where slot 0 got no seed.
    return jnp.clip(idx, 0, n - 1)


def gather_pose_packed(pose, idx):
    """pose[idx] via ONE [N, L] row gather instead of L scalar gathers.

    A gather's cost has a large per-row constant, so packing the pose SoA
    fields into one row-gathered matrix replaces L gathers of N rows by
    one. Not measured on the H100."""
    leaves, treedef = jax.tree.flatten(pose)
    packed = jnp.stack(leaves, axis=1)[idx]
    return jax.tree.unflatten(treedef, [packed[:, k] for k in range(len(leaves))])


def resample(key, particles: Particles, method: str = "systematic") -> Particles:
    """Select a new particle set and reset weights to uniform."""
    if method == "systematic":
        idx = systematic_indices(key, particles.log_weight)
    elif method == "multinomial":
        idx = multinomial_indices(key, particles.log_weight)
    else:
        raise ValueError(f"unknown resample method: {method}")
    n = particles.n
    return Particles(
        pose=gather_pose_packed(particles.pose, idx),
        log_weight=jnp.full((n,), -jnp.log(n), particles.log_weight.dtype),
    )


# --------------------------------------------------------------------------
# Augmented MCL (notebook cell 9): track fast/slow weight averages and inject
# uniform random particles over free space when the fast average collapses.
# --------------------------------------------------------------------------


def update_w_averages(log_w, w_slow, w_fast, alpha_slow=0.1, alpha_fast=0.9):
    """w_slow/w_fast EMAs of the mean unnormalized weight."""
    w_avg = jnp.mean(jnp.exp(log_w))
    w_slow = w_slow + alpha_slow * (w_avg - w_slow)
    w_fast = w_fast + alpha_fast * (w_avg - w_fast)
    return w_slow, w_fast


def injection_ratio(w_slow, w_fast):
    return jnp.maximum(0.0, 1.0 - w_fast / jnp.maximum(w_slow, 1e-30))


def inject_random_particles(
    key, particles: Particles, blocked: jax.Array, ratio
) -> Particles:
    """Replace a `ratio` fraction of particles with uniform poses over free
    space (rejection via the blocked mask; rejected draws keep the original
    particle, so the realized ratio is slightly lower near clutter)."""
    n = particles.n
    h, w = blocked.shape
    k_sel, k_i, k_j, k_t = jax.random.split(key, 4)

    replace = jax.random.uniform(k_sel, (n,)) < ratio
    i = jax.random.randint(k_i, (n,), 0, h)
    j = jax.random.randint(k_j, (n,), 0, w)
    free = ~blocked[i, j]
    use = replace & free

    x, y = gridlib.cell_to_world((h, w), i, j)
    theta = jax.random.uniform(k_t, (n,), minval=-jnp.pi, maxval=jnp.pi)
    pose = Pose(
        x=jnp.where(use, x, particles.pose.x),
        y=jnp.where(use, y, particles.pose.y),
        theta=jnp.where(use, theta, particles.pose.theta),
    )
    return particles.replace(pose=pose)
