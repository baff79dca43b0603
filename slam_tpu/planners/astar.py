"""Grid shortest-path planning as batched wavefront relaxation.

The reference's A* (`slam/astar.cpp:40-106`) pops one heap node per
`pathfind()` call: 8-connected grid, edge cost 1 straight / sqrt(2) diagonal
(`slam/astar.cpp:85-91`), free iff P(free) >= 0.5 (`slam/astar.cpp:65`),
Manhattan-heuristic heap order, and path recovery by greedy steepest descent
over the distance field — no parent pointers (`slam/astar.cpp:108-133`).

A serial heap is hostile to an accelerator; the wavefront reformulation (SURVEY.md
section 7) iterates the Bellman relaxation

    dist <- min(dist, shift_d(dist) + cost_d)  over the 8 directions

to a fixpoint: every round is 8 shifted adds + mins over the whole [H, W]
grid, and the number of rounds equals the longest geodesic, not
the node count. The result is the exact Dijkstra distance field from the
start (the reference's heuristic only reorders expansion; its Manhattan
heuristic over-estimates diagonals anyway — SURVEY section 5 quirk 5 — so
matching on path cost, not expansion order, is the correct parity test).

Path recovery keeps the reference's pointerless greedy-descent semantics.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Host scalar: a module-level jnp array would initialize the device backend
# at import time.
INF = 1e30
SQRT2 = float(np.sqrt(2.0))

# (di, dj, cost) for the 8-connected neighborhood (`slam/util.h:76-98`).
DIRS = [
    (-1, 0, 1.0),
    (1, 0, 1.0),
    (0, -1, 1.0),
    (0, 1, 1.0),
    (-1, -1, SQRT2),
    (-1, 1, SQRT2),
    (1, -1, SQRT2),
    (1, 1, SQRT2),
]


def _min_pool(a: jax.Array, window) -> jax.Array:
    """Windowed min with INF padding (erosion). The init value must be a
    host scalar: reduce_window's padding setup branches on it."""
    return jax.lax.reduce_window(
        a, 1e30, jax.lax.min, (window[0], window[1]), (1, 1), "SAME"
    )


def relax_round(dist: jax.Array, free: jax.Array, rounds: int = 1) -> jax.Array:
    """`rounds` Bellman relaxation sweeps (one wavefront ring each).

    One sweep is min(d, cross_min(d) + 1, pool3x3(d) + sqrt2): the 3x3 pool
    also covers the cross/center entries, but at cost sqrt2 those never beat
    the dedicated cross/identity terms, so the operator equals the exact
    8-direction relaxation while using only reduce_window min-pools (the
    XLA-fused form; per-direction shift+scatter is ~20x slower)."""

    def one(_, d):
        cross = jnp.minimum(_min_pool(d, (3, 1)), _min_pool(d, (1, 3)))
        best = jnp.minimum(d, cross + 1.0)
        best = jnp.minimum(best, _min_pool(d, (3, 3)) + SQRT2)
        return jnp.where(free, best, INF)

    return jax.lax.fori_loop(0, rounds, one, dist)


@jax.jit
def distance_field(free: jax.Array, start_ij: jax.Array) -> jax.Array:
    """Exact geodesic (8-connected, 1/sqrt2 costs) distance field from
    `start_ij` = (i, j), INF on blocked/unreachable cells."""
    h, w = free.shape
    dist = jnp.full((h, w), INF).at[start_ij[0], start_ij[1]].set(0.0)
    dist = jnp.where(free, dist, INF)

    # Relax in chunks; stop when a full chunk changes nothing.
    chunk = 32

    def cond(carry):
        dist, changed, rounds = carry
        return changed & (rounds < h * w)

    def body(carry):
        dist, _, rounds = carry
        new = relax_round(dist, free, chunk)
        return new, jnp.any(new < dist), rounds + chunk

    dist, _, _ = jax.lax.while_loop(cond, body, (dist, jnp.bool_(True), 0))
    return dist


def recover_path(
    dist: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int]
) -> List[Tuple[int, int]]:
    """Greedy steepest descent from goal to start over the distance field —
    the reference's pointerless recovery (`slam/astar.cpp:108-133`)."""
    h, w = dist.shape
    path = []
    cur = tuple(goal)
    start = tuple(start)
    limit = h * w
    while cur != start and limit > 0:
        path.append(cur)
        best, best_d = None, np.inf
        for di, dj, _ in DIRS:
            ni, nj = cur[0] + di, cur[1] + dj
            if 0 <= ni < h and 0 <= nj < w and dist[ni, nj] < best_d:
                best, best_d = (ni, nj), dist[ni, nj]
        if best is None or not np.isfinite(best_d):
            return []
        cur = best
        limit -= 1
    if cur != start:
        return []
    path.append(start)
    path.reverse()
    return path


class AStar:
    """Planner facade mirroring the reference's incremental API
    (`slam/astar.h:10-48`): construct with (map, A, B), call `pathfind()`
    until it returns True, then `recover_path()`.

    `pathfind(rounds)` advances the wavefront by `rounds` rings per call
    (the reference advances one node per call for animation; one ring is the
    batched analogue). A and B are image coordinates (i, j).
    """

    def __init__(self, free: jax.Array, a: Tuple[int, int], b: Tuple[int, int]):
        self.free = jnp.asarray(free, bool)
        self.a = tuple(int(v) for v in a)
        self.b = tuple(int(v) for v in b)
        h, w = self.free.shape
        d = jnp.full((h, w), INF).at[self.a[0], self.a[1]].set(0.0)
        self.dist = jnp.where(self.free, d, INF)
        self.success = False
        self.used_up = False

    def pathfind(self, rounds: int = 32) -> bool:
        """Advance the wavefront; True when settled (success or exhausted)."""
        if self.used_up:
            return True
        new = relax_round(self.dist, self.free, rounds)
        done = bool(jnp.all(new >= self.dist))
        self.dist = new
        if done:
            self.used_up = True
            self.success = bool(self.dist[self.b[0], self.b[1]] < INF)
        return done

    def solve(self) -> bool:
        self.dist = distance_field(self.free, jnp.asarray(self.a, jnp.int32))
        self.used_up = True
        self.success = bool(self.dist[self.b[0], self.b[1]] < INF)
        return self.success

    def recover_path(self) -> List[Tuple[int, int]]:
        if not self.success:
            return []
        return recover_path(np.asarray(self.dist), self.a, self.b)

    def path_cost(self) -> float:
        return float(self.dist[self.b[0], self.b[1]])
