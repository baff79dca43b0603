"""Batched spatial queries: nearest-neighbor and box range queries.

Vectorized replacement for the reference's pointer-based spatial indexes —
the kd-tree (`slam/kdtree.cpp:111-180`, recursive NN with axis pruning) and
the point quadtree (`slam/quadtree.cpp:89-139`, bbox-pruned range query).
Pointer chasing does not vectorize; on an accelerator the idiomatic form is a dense
masked distance tile: points live in a fixed-capacity SoA buffer
(`x: f32[N], y: f32[N], valid: bool[N]`) and queries evaluate all N
candidates with vector/matrix ops. Brute force wins here — the reference's
own NN demo ships a linear-scan oracle for exactly this comparison
(`apps/nearest_neighbor.cpp:25-38`).

For large N x Q workloads the squared-distance tile is formed in point
blocks (`nearest_neighbor_blocked`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Host scalar: a module-level jnp array would initialize the device backend
# at import time.
INF = 1e30


def sq_dist_tile(px, py, qx, qy):
    """f32[Q, N] squared distances between query and point sets."""
    return (qx[:, None] - px[None, :]) ** 2 + (qy[:, None] - py[None, :]) ** 2


def nearest_neighbor(px, py, valid, qx, qy):
    """Nearest valid point per query.

    Args:
      px, py: f32[N] point buffer. valid: bool[N].
      qx, qy: f32[Q] queries.
    Returns:
      (idx i32[Q], dist f32[Q]) — index of the nearest valid point and its
      Euclidean distance (idx -1 / dist INF when no point is valid).
    """
    d2 = jnp.where(valid[None, :], sq_dist_tile(px, py, qx, qy), INF)
    idx = jnp.argmin(d2, axis=1)
    best = jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
    none = best >= INF
    return (
        jnp.where(none, -1, idx).astype(jnp.int32),
        jnp.where(none, INF, jnp.sqrt(best)),
    )


def within_radius(px, py, valid, qx, qy, radius):
    """bool[Q, N]: valid points within Euclidean `radius` of each query
    (the RRT* rewire neighborhood; the reference approximates this with a
    quadtree box query of half-width `radius`, `slam/rrtstar.cpp:84-89`)."""
    d2 = sq_dist_tile(px, py, qx, qy)
    return valid[None, :] & (d2 <= radius * radius)


def in_box(px, py, valid, box):
    """bool[N]: valid points inside an inclusive box (x0, y0, x1, y1) —
    the quadtree range query semantics (`slam/quadtree.cpp:89-139`)."""
    x0, y0, x1, y1 = box
    return valid & (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)


def range_query_boxes(px, py, valid, boxes):
    """bool[Q, N] membership masks for a batch of boxes f32[Q, 4]."""
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    inx = (px[None, :] >= x0[:, None]) & (px[None, :] <= x1[:, None])
    iny = (py[None, :] >= y0[:, None]) & (py[None, :] <= y1[:, None])
    return valid[None, :] & inx & iny


def nearest_neighbor_blocked(px, py, valid, qx, qy, block: int = 4096):
    """NN for large point buffers: scan over point blocks to bound the tile
    to [Q, block] (memory O(Q*block) instead of O(Q*N))."""
    n = px.shape[0]
    q = qx.shape[0]
    pad = (-n) % block
    if pad:
        px = jnp.pad(px, (0, pad))
        py = jnp.pad(py, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    nb = (n + pad) // block

    def body(carry, blk):
        best_d2, best_i = carry
        bpx, bpy, bval, base = blk
        d2 = jnp.where(bval[None, :], sq_dist_tile(bpx, bpy, qx, qy), INF)
        bi = jnp.argmin(d2, axis=1)
        bd = jnp.take_along_axis(d2, bi[:, None], axis=1)[:, 0]
        better = bd < best_d2
        return (
            jnp.where(better, bd, best_d2),
            jnp.where(better, base + bi.astype(jnp.int32), best_i),
        ), None

    blocks = (
        px.reshape(nb, block),
        py.reshape(nb, block),
        valid.reshape(nb, block),
        (jnp.arange(nb, dtype=jnp.int32) * block),
    )
    (best_d2, best_i), _ = jax.lax.scan(
        body, (jnp.full((q,), INF), jnp.full((q,), -1, jnp.int32)), blocks
    )
    none = best_d2 >= INF
    return best_i, jnp.where(none, INF, jnp.sqrt(best_d2))
