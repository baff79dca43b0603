"""Vectorized raycasting over occupancy grids.

The reference's `raycast<T>` (`slam/raycast.cpp:8-141`) is a scalar fixed-step
DDA march with data-dependent exit — per-ray Python/C++ control flow that XLA
cannot vectorize. Here a ray batch of any shape marches together in fixed-size
chunks with masked "first event" semantics; a `lax.while_loop` exits as soon
as every ray in the batch has resolved, preserving the early-exit economics of
the scalar loop while keeping all compute vector-shaped.

Semantics match the reference exactly:
  * step positions are p_k = origin + k * step * dir, k = 1..K;
  * the origin's own cell is never tested (`prev_i == i` skip at
    `slam/raycast.cpp:33-36` dedups; the first tested cell is the first one
    that differs from the start cell);
  * at each step, distance-exceeded (d >= max_dist) or out-of-bounds resolves
    the ray as a MISS; otherwise a blocked cell resolves it as a HIT at
    distance k*step (`slam/raycast.cpp:38-46`).

A miss reports dist == max_dist (the convention the reference app applies on
the {-1,-1} sentinel, `apps/grid_slam.cpp:152-160`) and hit == False.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from slam_tpu.core import grid as gridlib


def raycast_march(
    blocked: jax.Array,
    x: jax.Array,
    y: jax.Array,
    theta: jax.Array,
    *,
    step: float = 0.5,
    max_dist: float = 500.0,
    chunk: int = 64,
    row_offset=None,
    full_h: int | None = None,
):
    """March rays through a boolean occupancy grid.

    Args:
      blocked: bool[H, W], True where a cell stops rays. May be a row-block
        of a larger map (see row_offset/full_h): cells outside the block are
        treated as free, so block-partial results combine exactly with a
        min over blocks (a ray's true first hit is the min of its per-block
        first hits — the halo-free decomposition slam_tpu.parallel.mapshard
        builds on).
      x, y, theta: ray origins/headings, broadcastable to a common batch shape.
      step: march step in pixels (`slam/raycast.h` default 0.5).
      max_dist: maximum ray length in pixels.
      chunk: steps advanced per early-exit round.
      row_offset: global row index of blocked's first row (traced ok).
      full_h: full-map height when blocked is a row-block.

    Returns:
      (dist, hit): f32[batch] event distance (== max_dist for misses) and
      bool[batch] hit flag.
    """
    blocked = jnp.asarray(blocked, bool)  # host arrays would np-index tracers
    lh, w = blocked.shape
    h = lh if full_h is None else full_h
    ro = jnp.int32(0 if row_offset is None else row_offset)
    x, y, theta = jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(theta, jnp.float32),
    )
    batch_shape = x.shape
    m = int(jnp.size(x)) if batch_shape else 1
    x = x.reshape(m)
    y = y.reshape(m)
    theta = theta.reshape(m)

    k_total = int(math.ceil(max_dist / step))
    n_chunks = -(-k_total // chunk)

    dx = jnp.cos(theta) * step
    dy = jnp.sin(theta) * step
    i0, j0 = gridlib.world_to_cell((h, w), x, y)
    cell0 = i0 * w + j0  # may be out of range; only used for inequality tests

    flat = blocked.reshape(-1)
    ks_rel = jnp.arange(1, chunk + 1, dtype=jnp.float32)

    def body(carry):
        k0, resolved, hit, dist = carry
        ks = k0.astype(jnp.float32) + ks_rel  # [chunk]
        d = ks * step
        px = x[:, None] + ks[None, :] * dx[:, None]
        py = y[:, None] + ks[None, :] * dy[:, None]
        i, j = gridlib.world_to_cell((h, w), px, py)
        inb = gridlib.in_bounds((h, w), i, j)
        il = i - ro  # block-local row; out-of-block cells read as free
        inblk = (il >= 0) & (il < lh)
        ilc = jnp.clip(il, 0, lh - 1)
        jc = jnp.clip(j, 0, w - 1)
        occ = flat[(ilc * w + jc).reshape(-1)].reshape(i.shape) & inblk
        cell = i * w + j
        miss = (d[None, :] >= max_dist) | ~inb
        hit_k = occ & (cell != cell0[:, None]) & ~miss
        event = miss | hit_k

        any_event = jnp.any(event, axis=-1)
        first = jnp.argmax(event, axis=-1)
        d_first = (k0.astype(jnp.float32) + first.astype(jnp.float32) + 1.0) * step
        hit_first = jnp.take_along_axis(hit_k, first[:, None], axis=-1)[:, 0]

        newly = any_event & ~resolved
        resolved = resolved | any_event
        hit = jnp.where(newly, hit_first, hit)
        dist = jnp.where(newly & hit_first, d_first, dist)
        return k0 + chunk, resolved, hit, dist

    def cond(carry):
        k0, resolved, _, _ = carry
        return (k0 < n_chunks * chunk) & ~jnp.all(resolved)

    init = (
        jnp.int32(0),
        jnp.zeros((m,), bool),
        jnp.zeros((m,), bool),
        jnp.full((m,), max_dist, jnp.float32),
    )
    _, _, hit, dist = jax.lax.while_loop(cond, body, init)
    return dist.reshape(batch_shape), hit.reshape(batch_shape)


def raycast_sdf(
    edt: jax.Array,
    x: jax.Array,
    y: jax.Array,
    theta: jax.Array,
    *,
    step: float = 0.5,
    max_dist: float = 500.0,
    margin: float = 1.0,
    max_iters: int | None = None,
):
    """Sphere-trace rays over a Euclidean distance transform.

    Vectorized replacement for the fixed-step DDA march: each iteration
    gathers the EDT at the current position and advances by
    ``max(step, edt - margin)`` — obstacle-free stretches are crossed in one
    jump, so typical rays resolve in tens of iterations instead of
    ``max_dist/step`` (1000). Near surfaces the advance collapses to the
    reference's fixed `step`, preserving its hit quantization
    (`slam/raycast.cpp:8-141` semantics: blocked cell -> HIT at the marched
    distance; out-of-bounds or distance exhausted -> MISS at max_dist).

    A cell is blocked iff ``edt == 0``, so one gather serves both the
    occupancy test and the step size. `margin` guards against EDT
    overestimation (use >= 1.5 with `edt_jfa`, 1.0 with `edt_exact`).
    """
    h, w = edt.shape
    x, y, theta = jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(theta, jnp.float32),
    )
    batch_shape = x.shape
    m = int(jnp.size(x)) if batch_shape else 1
    x = x.reshape(m)
    y = y.reshape(m)
    theta = theta.reshape(m)

    if max_iters is None:
        max_iters = int(math.ceil(max_dist / step)) + 4

    dx = jnp.cos(theta)
    dy = jnp.sin(theta)
    i0, j0 = gridlib.world_to_cell((h, w), x, y)
    cell0 = i0 * w + j0

    flat = edt.reshape(-1)

    def body(carry):
        k, t, resolved, hit, dist = carry
        px = x + t * dx
        py = y + t * dy
        i, j = gridlib.world_to_cell((h, w), px, py)
        inb = gridlib.in_bounds((h, w), i, j)
        ic, jc = gridlib.clamp_cell((h, w), i, j)
        d_cell = flat[ic * w + jc]
        cell = i * w + j

        miss = (t >= max_dist) | ~inb
        hit_now = (d_cell <= 0.0) & (cell != cell0) & ~miss & ~resolved
        newly = (hit_now | miss) & ~resolved
        dist = jnp.where(hit_now, t, dist)
        hit = hit | hit_now
        resolved = resolved | newly

        advance = jnp.maximum(step, d_cell - margin)
        t = jnp.where(resolved, t, t + advance)
        return k + 1, t, resolved, hit, dist

    def cond(carry):
        k, _, resolved, _, _ = carry
        return (k < max_iters) & ~jnp.all(resolved)

    init = (
        jnp.int32(0),
        jnp.full((m,), step, jnp.float32),
        jnp.zeros((m,), bool),
        jnp.zeros((m,), bool),
        jnp.full((m,), max_dist, jnp.float32),
    )
    _, _, _, hit, dist = jax.lax.while_loop(cond, body, init)
    return dist.reshape(batch_shape), hit.reshape(batch_shape)


def raycast_hit_points(x, y, theta, dist, hit):
    """Continuous hit coordinates (origin + dist * dir) for hitting rays;
    the reference returns these directly (`slam/raycast.cpp:44`)."""
    hx = jnp.where(hit, x + dist * jnp.cos(theta), -1.0)
    hy = jnp.where(hit, y + dist * jnp.sin(theta), -1.0)
    return hx, hy
