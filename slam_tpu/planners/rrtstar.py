"""RRT*: sampling-based optimal planning, batched for accelerators.

Reference: `slam/rrtstar.cpp`. Per iteration it draws ONE uniform sample,
finds the nearest tree node via the kd-tree (`slam/rrtstar.cpp:71`), steers
exactly `reach` px toward the sample with a straight-line collision raycast
(`slam/rrtstar.cpp:38-64`), inserts, then rewires inside a `radius` box from
the quadtree (choose-parent pass `slam/rrtstar.cpp:91-105`, rewire pass
`:117-144`), and declares success when a new node lands within `reach` of the
goal with a clear connection (`:146-155`). `recover_path` returns goal->start
order (`:166-179`).

Batched reformulation (SURVEY.md section 7): a fixed-capacity SoA node buffer
replaces the pointer trees; each round draws a BATCH of samples, answers all
nearest-neighbor and radius queries as dense masked distance tiles
(slam_tpu.ops.spatial — the kd-tree/quadtree equivalents), collision-checks
every candidate edge in one raycast call, and commits the batch with
scatter-min cost resolution. Candidates within one round see the tree frozen
at the round start, so the tree grows in waves rather than strictly one node
at a time — acceptance is on path cost/feasibility, as with the other
planners. The whole solve is a single `lax.while_loop` device program, and
the jitted core is module-level with static (cfg, rc) so compilation caches
across planner instances.

Deliberate fixes vs the reference:
  * steer distance is min(reach, dist-to-sample) — the reference overshoots
    closer samples to exactly `reach` (`slam/rrtstar.cpp:47-49`);
  * collision rays are bounded by the true edge length — the reference
    passes reach^2 (`slam/rrtstar.cpp:61`);
  * neighbor connections re-raycast the FULL edge p->q — the reference
    reuses the fixed-`reach` probe as a proxy for arbitrary-length edges
    (`slam/rrtstar.cpp:99-101,123-125`);
  * the rewire neighborhood is a true Euclidean radius, not the quadtree's
    radius/2 half-width box (`slam/rrtstar.cpp:84-89`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from slam_tpu.core import struct

from slam_tpu.core.config import RRTStarConfig, RaycastConfig
from slam_tpu.ops import spatial
from slam_tpu.ops.rayfield import RayField, make_ray_field, raycast_field

# Host scalar: a module-level jnp array would initialize the device backend
# at import time.
INF = 1e30


@struct.dataclass
class RRTState:
    x: jax.Array  # f32[N] node world-x
    y: jax.Array  # f32[N]
    cost: jax.Array  # f32[N] cost from root
    parent: jax.Array  # i32[N] (-1 for root / unset)
    valid: jax.Array  # bool[N]
    size: jax.Array  # i32 nodes used
    best_goal_node: jax.Array  # i32 (-1 until success)
    best_goal_cost: jax.Array  # f32 total cost through that node to goal
    key: jax.Array


def _edges_clear(field: RayField, rc: RaycastConfig, x0, y0, x1, y1):
    """Straight-line feasibility for a batch of edges (endpoint must be
    free and in bounds; no obstacle strictly before the endpoint)."""
    h, w = field.blocked.shape
    dx = x1 - x0
    dy = y1 - y0
    d = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)
    i = jnp.floor(h - y1 - 1.0).astype(jnp.int32)
    j = jnp.floor(x1).astype(jnp.int32)
    inb = (i >= 0) & (i < h) & (j >= 0) & (j < w)
    ic = jnp.clip(i, 0, h - 1)
    jc = jnp.clip(j, 0, w - 1)
    dst_free = ~field.blocked[ic, jc] & inb
    hd, hit = raycast_field(field, x0, y0, ang, rc)
    return dst_free & (~hit | (hd >= d)) & (d > 0)


def _rrt_round(
    st: RRTState,
    field: RayField,
    goal: jax.Array,
    cfg: RRTStarConfig,
    rc: RaycastConfig,
    neighbor_cap: int,
) -> RRTState:
    h, w = field.blocked.shape
    k = cfg.batch
    m = neighbor_cap
    bx, by = goal[0], goal[1]

    key, k_x, k_y = jax.random.split(st.key, 3)

    # 1. Sample K points uniformly over the map (`slam/util.cpp:53-64`).
    sx = jax.random.uniform(k_x, (k,), minval=0.0, maxval=float(w))
    sy = jax.random.uniform(k_y, (k,), minval=0.0, maxval=float(h))

    # 2. Nearest tree node per sample (kd-tree NN equivalent).
    nn_idx, nn_dist = spatial.nearest_neighbor(st.x, st.y, st.valid, sx, sy)
    rx = st.x[nn_idx]
    ry = st.y[nn_idx]

    # 3. Steer min(reach, dist) toward the sample; collision-check.
    step_d = jnp.minimum(cfg.reach, nn_dist)
    scale = step_d / jnp.maximum(nn_dist, 1e-9)
    cx = rx + (sx - rx) * scale
    cy = ry + (sy - ry) * scale
    ok = _edges_clear(field, rc, rx, ry, cx, cy)

    # 4. Choose parent among the M nearest in-radius tree nodes
    #    (quadtree range query equivalent; `slam/rrtstar.cpp:91-105`).
    d2 = spatial.sq_dist_tile(st.x, st.y, cx, cy)
    d2 = jnp.where(st.valid[None, :], d2, INF)
    in_rad = d2 <= cfg.radius * cfg.radius
    neg_d2, nbr = jax.lax.top_k(jnp.where(in_rad, -d2, -INF), m)
    nbr_ok = -neg_d2 < INF  # [K, M]

    nbx = st.x[nbr]
    nby = st.y[nbr]
    ndist = jnp.sqrt((nbx - cx[:, None]) ** 2 + (nby - cy[:, None]) ** 2)
    reach_ok = nbr_ok & _edges_clear(
        field,
        rc,
        nbx,
        nby,
        jnp.broadcast_to(cx[:, None], nbx.shape),
        jnp.broadcast_to(cy[:, None], nbx.shape),
    )
    through = jnp.where(reach_ok, st.cost[nbr] + ndist, INF)
    pbest = jnp.argmin(through, axis=1)
    new_cost = jnp.take_along_axis(through, pbest[:, None], 1)[:, 0]
    new_parent = jnp.take_along_axis(nbr, pbest[:, None], 1)[:, 0]
    ok = ok & (new_cost < INF)

    # 5. Compact accepted candidates into fresh slots (after ALL rejections,
    #    so the slot range stays contiguous).
    offs = jnp.cumsum(ok.astype(jnp.int32)) - 1
    slots = jnp.where(ok, st.size + offs, cfg.max_nodes)
    ok = ok & (slots < cfg.max_nodes)
    slots = jnp.where(ok, slots, cfg.max_nodes)  # OOB -> scatter-dropped

    # Commit the new nodes.
    x = st.x.at[slots].set(cx, mode="drop")
    y = st.y.at[slots].set(cy, mode="drop")
    cost = st.cost.at[slots].set(new_cost, mode="drop")
    parent = st.parent.at[slots].set(new_parent, mode="drop")
    valid = st.valid.at[slots].set(True, mode="drop")
    size = st.size + jnp.sum(ok)

    # 6. Rewire pass (`slam/rrtstar.cpp:117-144`): route in-radius neighbors
    #    through the new nodes when cheaper.
    rew_cand = jnp.where(reach_ok, new_cost[:, None] + ndist, INF)
    rew_cand = jnp.where(ok[:, None], rew_cand, INF)
    nbr_f = nbr.reshape(-1)
    cand_f = rew_cand.reshape(-1)
    improved_cost = cost.at[nbr_f].min(cand_f)
    won = (cand_f <= improved_cost[nbr_f]) & (cand_f < INF) & (cand_f < cost[nbr_f])
    nbr_w = jnp.where(won, nbr_f, cfg.max_nodes)
    slot_src = jnp.broadcast_to(slots[:, None], rew_cand.shape).reshape(-1)
    parent = parent.at[nbr_w].set(slot_src.astype(jnp.int32), mode="drop")
    cost = improved_cost

    # 7. Goal connection (`slam/rrtstar.cpp:146-155`).
    dgoal = jnp.sqrt((cx - bx) ** 2 + (cy - by) ** 2)
    can_goal = (
        ok
        & (dgoal <= cfg.reach)
        & _edges_clear(field, rc, cx, cy, jnp.full((k,), bx), jnp.full((k,), by))
    )
    total = jnp.where(can_goal, new_cost + dgoal, INF)
    gbest = jnp.argmin(total)
    gcost = total[gbest]
    better = gcost < st.best_goal_cost
    best_goal_node = jnp.where(
        better, slots[gbest].astype(jnp.int32), st.best_goal_node
    )
    best_goal_cost = jnp.where(better, gcost, st.best_goal_cost)

    return RRTState(
        x=x,
        y=y,
        cost=cost,
        parent=parent,
        valid=valid,
        size=size,
        best_goal_node=best_goal_node,
        best_goal_cost=best_goal_cost,
        key=key,
    )


def _rrt_solve(st, field, goal, max_rounds, min_nodes, cfg, rc, neighbor_cap):
    """Whole search as ONE device program: loop until a goal connection
    exists AND the tree has min_nodes (the `apps/rrt_planner.cpp:50` densify
    condition), the node budget is exhausted, or max_rounds pass."""

    def cond(carry):
        st, rounds = carry
        want_more = (st.best_goal_node < 0) | (st.size < min_nodes)
        return want_more & (st.size < cfg.max_nodes) & (rounds < max_rounds)

    def body(carry):
        st, rounds = carry
        return _rrt_round(st, field, goal, cfg, rc, neighbor_cap), rounds + 1

    st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
    return st


def _rrt_query_init(a_xy, b_xy, seed, cfg):
    """Fresh-query state as a traced constructor (see _rrt_solve_query)."""
    n = cfg.max_nodes
    goal = b_xy
    state = RRTState(
        x=jnp.zeros((n,), jnp.float32).at[0].set(a_xy[0]),
        y=jnp.zeros((n,), jnp.float32).at[0].set(a_xy[1]),
        cost=jnp.full((n,), INF).at[0].set(0.0),
        parent=jnp.full((n,), -1, jnp.int32),
        valid=jnp.zeros((n,), bool).at[0].set(True),
        size=jnp.int32(1),
        best_goal_node=jnp.int32(-1),
        best_goal_cost=jnp.float32(INF),
        key=jax.random.key(seed),
    )
    return goal, state


def _rrt_solve_query(
    a_xy, b_xy, seed, field, max_rounds, min_nodes, cfg, rc, neighbor_cap
):
    """Fresh query end-to-end (state init + full search) as ONE device
    program — eager per-query state fills were ~9 dispatches, each a host
    round trip."""
    goal, st = _rrt_query_init(a_xy, b_xy, seed, cfg)
    st = _rrt_solve(st, field, goal, max_rounds, min_nodes, cfg, rc,
                    neighbor_cap)
    return goal, st


_rrt_round_jit = jax.jit(_rrt_round, static_argnums=(3, 4, 5))
_rrt_solve_jit = jax.jit(_rrt_solve, static_argnums=(5, 6, 7))
_rrt_query_init_jit = jax.jit(_rrt_query_init, static_argnums=(3,))
_rrt_solve_query_jit = jax.jit(_rrt_solve_query, static_argnums=(6, 7, 8))


class RRTStar:
    """Facade mirroring `slam/rrtstar.h:12-64`: pathfind() per round,
    recover_path() when done. Coordinates are world (x, y)."""

    def __init__(
        self,
        free: jax.Array,
        a: Tuple[float, float],
        b: Tuple[float, float],
        cfg: RRTStarConfig = RRTStarConfig(),
        rc: RaycastConfig = RaycastConfig(backend="sdf", step=1.0),
        seed: int = 0,
        neighbor_cap: int = 16,
    ):
        assert cfg.radius >= cfg.reach, "radius must cover reach"
        self.cfg = cfg
        # Edges are bounded by the rewire radius; clamp collision rays so
        # they resolve in few sphere-trace iterations.
        self.rc = dataclasses.replace(
            rc, max_dist=min(rc.max_dist, cfg.radius + 2.0)
        )
        self.neighbor_cap = neighbor_cap
        free = jnp.asarray(free, bool)
        self.shape = free.shape
        self.field = make_ray_field(~free, self.rc)
        self.reset_query(a, b, seed)

    def reset_query(self, a, b, seed: int = 0):
        """Re-target start/goal on the same map (the ray field is reused).
        LAZY: `solve` on a fresh query fuses state init + search into one
        dispatch; the incremental `pathfind` materializes first."""
        self.a = (float(a[0]), float(a[1]))
        self.b = (float(b[0]), float(b[1]))
        self._goal = jnp.asarray([self.b[0], self.b[1]], jnp.float32)
        self.success = False
        self.used_up = False
        self._pending_seed = seed
        self.state = None

    def _ensure_query_state(self):
        if self.state is None:
            a_xy = jnp.asarray(self.a, jnp.float32)
            self._goal, self.state = _rrt_query_init_jit(
                a_xy, self._goal, self._pending_seed, self.cfg
            )

    # -- driver -----------------------------------------------------------

    @property
    def size(self) -> int:
        self._ensure_query_state()
        return int(self.state.size)

    def pathfind(self) -> bool:
        """One batched round; True once a goal connection exists (the
        reference's success latch — callers may keep iterating to densify,
        `apps/rrt_planner.cpp:50`)."""
        if self.used_up:
            return True
        self._ensure_query_state()
        self.state = _rrt_round_jit(
            self.state, self.field, self._goal, self.cfg, self.rc, self.neighbor_cap
        )
        if int(self.state.best_goal_node) >= 0:
            self.success = True
        if int(self.state.size) >= self.cfg.max_nodes:
            self.used_up = True
        return self.success or self.used_up

    def solve(self, max_rounds: int = 256, min_nodes: int = 0) -> bool:
        if self.state is None:
            # Fresh query: init + search in one fused dispatch.
            a_xy = jnp.asarray(self.a, jnp.float32)
            self._goal, self.state = _rrt_solve_query_jit(
                a_xy,
                self._goal,
                self._pending_seed,
                self.field,
                jnp.int32(max_rounds),
                jnp.int32(min_nodes),
                self.cfg,
                self.rc,
                self.neighbor_cap,
            )
        else:
            self.state = _rrt_solve_jit(
                self.state,
                self.field,
                self._goal,
                jnp.int32(max_rounds),
                jnp.int32(min_nodes),
                self.cfg,
                self.rc,
                self.neighbor_cap,
            )
        if int(self.state.best_goal_node) >= 0:
            self.success = True
        if int(self.state.size) >= self.cfg.max_nodes:
            self.used_up = True
        return self.success

    def recover_path(self) -> List[Tuple[float, float]]:
        """Goal -> start node chain (`slam/rrtstar.cpp:166-179` order)."""
        if not self.success:
            return []
        xs = np.asarray(self.state.x)
        ys = np.asarray(self.state.y)
        parent = np.asarray(self.state.parent)
        path = [(self.b[0], self.b[1])]
        idx = int(self.state.best_goal_node)
        hops = 0
        while idx >= 0 and hops <= len(parent):
            path.append((float(xs[idx]), float(ys[idx])))
            idx = int(parent[idx])
            hops += 1
        return path

    def path_cost(self) -> float:
        return float(self.state.best_goal_cost)
