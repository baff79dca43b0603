"""Hybrid A*: kinematically-feasible SE(2) planning, batched for accelerators.

Reference: `slam/hastar.{h,cpp}`. State = continuous pose deduplicated into a
rows x cols x theta_res cuboid (`slam/hastar.cpp:54-55,234-241`); successors
= bicycle-model steering arcs theta' = theta + v/L * tan(steer) for
`branching_factor` steer angles and velocities {+v, -v}, edge cost
v + steering_cost * (10 if reverse) (`slam/hastar.cpp:88-112`); edge
feasibility = straight-line raycast + free destination cell
(`slam/hastar.cpp:123-140`); heuristic = Euclidean distance to goal; success
= first expansion within `tol` of the goal (any heading for diff-drive, else
matching theta bin) (`slam/hastar.cpp:178-184`).

The serial heap pops ONE node per `pathfind()` call; here each round pops the
`batch` best open cuboid cells at once (top-k over the open set), expands all
of their 2 x branching successors vectorized, collision-checks the whole edge
batch with one raycast call, and commits improvements with scatter-min. The
expansion order differs from the strict heap, so parity tests compare path
cost/feasibility, not node order (SURVEY.md section 7 "hard parts").

Deliberate fixes vs the reference (kept out of fidelity scope):
  * `can_reach` bounds the collision raycast by the actual edge length — the
    reference passes the SQUARED distance as max_dist (`slam/hastar.cpp:135`),
    scanning far past the destination.
  * blocked iff P(free) < 0.5 on the provided mask — the reference's
    `uchar < 0.5` only blocks exact 0 (`slam/hastar.cpp:128`, SURVEY
    section 5 quirk 5).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from slam_tpu.core import struct

from slam_tpu.core.config import HybridAStarConfig, RaycastConfig
from slam_tpu.core.types import Pose
from slam_tpu.ops.rayfield import RayField, make_ray_field, raycast_field

# Host scalar: a module-level jnp array would initialize the device backend
# at import time.
INF = 1e30


@struct.dataclass
class HAState:
    g: jax.Array  # f32[S] best committed cost per cuboid cell
    parent: jax.Array  # i32[S] predecessor cuboid index (-1 = none)
    px: jax.Array  # f32[S] continuous pose of the best entrant
    py: jax.Array
    pth: jax.Array
    # f32[S] open-list priority: g + h for open cells, INF for closed /
    # never-reached. Maintained INCREMENTALLY at the batch-sized scatter
    # sites, so a round's only O(S) work is the grouped argmin over this
    # one array (the full-cuboid `f = g + h` rebuild was most of the round).
    open_f: jax.Array
    goal_idx: jax.Array  # i32 cuboid index of the first in-tolerance pop (-1)
    goal_cost: jax.Array  # f32
    n_expanded: jax.Array  # i32
    # i32: the seeded start cuboid index — recover_path's chain terminator.
    # Carried from the DEVICE query init so host arithmetic can never
    # disagree with the index that actually seeded the search.
    start_idx: jax.Array


def _pose_to_cuboid(shape, k, x, y, theta):
    """Cuboid flat index for pose(s) (`slam/hastar.cpp:234-241`)."""
    h, w = shape
    i = jnp.clip(jnp.floor(h - y - 1.0).astype(jnp.int32), 0, h - 1)
    j = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 1)
    ang = jnp.mod(theta + 2 * jnp.pi, 2 * jnp.pi)
    kk = jnp.clip((ang / (2 * jnp.pi / k)).astype(jnp.int32), 0, k - 1)
    return (i * w + j) * k + kk


def _steering_tables(cfg: HybridAStarConfig):
    """Steer angles and their costs (`slam/hastar.cpp:68-80`)."""
    b = cfg.branching_factor
    assert b > 2 and b % 2 == 1, "branching_factor must be odd >= 3"
    cost_slope = cfg.velocity / (b - 1)
    dtheta = cfg.max_steering * 2 / (b - 1)
    mid = b // 2
    thetas = [-cfg.max_steering + i * dtheta for i in range(b)]
    costs = [abs(i - mid) * cost_slope for i in range(b)]
    return np.asarray(thetas, np.float32), np.asarray(costs, np.float32)


def _ha_round(
    st: HAState,
    field: RayField,
    goal: jax.Array,
    target_bin: jax.Array,
    hfield: jax.Array,
    cfg: HybridAStarConfig,
    rc: RaycastConfig,
) -> HAState:
    """One batched expansion round (pure; cfg/rc static for jit caching
    across planner instances — per-instance jits would recompile the whole
    search for every query)."""
    h, w = field.blocked.shape
    shape = (h, w)
    kbins = cfg.theta_res
    kpop = cfg.batch
    bx, by = goal[0], goal[1]
    thetas, steer_costs = _steering_tables(cfg)

    # open_f already holds g + h for open cells (INF = closed / dead):
    # nothing to rebuild, straight to selection.
    f = st.open_f
    s = f.shape[0]
    if cfg.selection == "grouped":
        # Best open node per strided index group: one O(S) argmin pass
        # instead of an exact global top-k (~10x cheaper per round; the
        # strided classes interleave map columns and theta bins, so pops
        # stay spread across the frontier).
        pad = (-s) % kpop
        f2 = jnp.pad(f, (0, pad), constant_values=INF).reshape(-1, kpop)
        rel = jnp.argmin(f2, axis=0)  # [kpop]
        cols = jnp.arange(kpop, dtype=jnp.int32)
        pop = rel.astype(jnp.int32) * kpop + cols
        fpop = jnp.take_along_axis(f2, rel[None, :], axis=0)[0]
        pop_valid = (fpop < INF) & (pop < s)
        pop = jnp.where(pop_valid, pop, 0)
    elif cfg.selection == "topk":
        neg_f, pop = jax.lax.top_k(-f, kpop)
        fpop = -neg_f
        pop_valid = fpop < INF
    else:
        raise ValueError(f"unknown selection: {cfg.selection}")

    pop_clear = jnp.where(pop_valid, pop, s)  # drop invalid pops
    open_f = f.at[pop_clear].set(INF, mode="drop")

    gx = st.px[pop]
    gy = st.py[pop]
    gth = st.pth[pop]
    gg = st.g[pop]

    # Goal test on popped nodes (`slam/hastar.cpp:178-184`).
    tol2 = cfg.tol * cfg.tol
    d2goal = (gx - bx) ** 2 + (gy - by) ** 2
    bin_of = _pose_to_cuboid(shape, kbins, gx, gy, gth) % kbins
    bin_ok = cfg.diff_drive | (bin_of == target_bin)
    at_goal = (d2goal <= tol2) & bin_ok & pop_valid
    # Lowest-f in-tolerance pop wins.
    any_goal = jnp.any(at_goal)
    first = jnp.argmin(jnp.where(at_goal, fpop, INF))
    goal_better = any_goal & (st.goal_idx < 0)
    goal_idx = jnp.where(goal_better, pop[first], st.goal_idx)
    goal_cost = jnp.where(goal_better, gg[first], st.goal_cost)

    # Successor fan: [K, 2B] (`slam/hastar.cpp:88-112`).
    vels = jnp.asarray([cfg.velocity, -cfg.velocity], jnp.float32)
    cost_factor = jnp.asarray([1.0, cfg.reverse_factor], jnp.float32)
    nth = gth[:, None, None] + (
        vels[None, :, None] / cfg.length
    ) * jnp.tan(jnp.asarray(thetas))[None, None, :]
    nx = gx[:, None, None] + vels[None, :, None] * jnp.cos(nth)
    ny = gy[:, None, None] + vels[None, :, None] * jnp.sin(nth)
    ecost = (
        cfg.velocity
        + jnp.asarray(steer_costs)[None, None, :] * cost_factor[None, :, None]
    )
    shape2 = nx.shape

    # Feasibility: free in-bounds destination + clear straight line.
    dx = nx - gx[:, None, None]
    dy = ny - gy[:, None, None]
    edge_len = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)
    di = jnp.floor(h - ny - 1.0).astype(jnp.int32)
    dj = jnp.floor(nx).astype(jnp.int32)
    inb = (di >= 0) & (di < h) & (dj >= 0) & (dj < w)
    dic = jnp.clip(di, 0, h - 1)
    djc = jnp.clip(dj, 0, w - 1)
    dst_free = ~field.blocked[dic, djc] & inb

    hit_d, hit = raycast_field(
        field,
        jnp.broadcast_to(gx[:, None, None], shape2),
        jnp.broadcast_to(gy[:, None, None], shape2),
        ang,
        rc,
    )
    clear = ~hit | (hit_d >= edge_len)
    ok = dst_free & clear & pop_valid[:, None, None]

    tgt = _pose_to_cuboid(shape, kbins, nx, ny, nth)
    cand = jnp.where(ok, gg[:, None, None] + ecost, INF)

    # Improvements only (`slam/hastar.cpp:198` dedup against the cuboid).
    cand = jnp.where(cand < st.g[tgt], cand, INF)

    tgt_f = tgt.reshape(-1)
    cand_f = cand.reshape(-1)
    g = st.g.at[tgt_f].min(cand_f)

    won = (cand_f <= g[tgt_f]) & (cand_f < INF)
    tgt_w = jnp.where(won, tgt_f, 2 ** 30)  # scatter drop for losers
    parent_src = jnp.broadcast_to(
        pop[:, None, None], shape2
    ).reshape(-1)
    parent = st.parent.at[tgt_w].set(
        parent_src, mode="drop"
    )
    px = st.px.at[tgt_w].set(nx.reshape(-1), mode="drop")
    py = st.py.at[tgt_w].set(ny.reshape(-1), mode="drop")
    pth = st.pth.at[tgt_w].set(nth.reshape(-1), mode="drop")

    # Insert priority for winners; an INF heuristic (goal-unreachable
    # region under the geodesic field) keeps the cell dead, so the search
    # terminates on exhaustion instead of popping it forever.
    if cfg.heuristic == "geodesic":
        hnew = hfield[tgt_f]
    else:
        hnew = cfg.heuristic_weight * jnp.sqrt(
            (nx.reshape(-1) - bx) ** 2 + (ny.reshape(-1) - by) ** 2
        )
    fnew = jnp.where((cand_f < INF) & (hnew < INF), cand_f + hnew, INF)
    # min-combine: reopen closed cells, improve already-open ones (f moves
    # with g because h is fixed per cell).
    open_f = open_f.at[tgt_w].min(fnew, mode="drop")

    return HAState(
        g=g,
        parent=parent,
        px=px,
        py=py,
        pth=pth,
        open_f=open_f,
        goal_idx=goal_idx,
        goal_cost=goal_cost,
        n_expanded=st.n_expanded + jnp.sum(pop_valid),
        start_idx=st.start_idx,
    )


def _lattice_tables(cfg: HybridAStarConfig, shape):
    """Per-theta-bin successor offsets/costs for cell-center lattice states.

    From a bin-center pose (j+0.5, h-i-0.5, theta_k), the (vel, steer)
    successor lands at a FIXED integer cell/bin offset — so the steering
    adjacency (`slam/hastar.cpp:88-112`) collapses to static tables:
      flat_off [K, E]  cuboid-index delta
      di/dj    [K, E]  cell deltas (for bounds checks)
      cost     [K, E]  edge cost
      seg      [K, E, T, 2] integer cell shifts sampled along each edge
                         (feeds the shifted-AND feasibility maps)
      inv_off  [K, E]  flat_off of the edge-e predecessor of a node in bin
                       k (each edge shifts the theta bin by a constant, so
                       (target bin, edge) determines the source bin) — lets
                       the parent CHAIN be recovered from the 3-bit edge id
                       stored in the packed cost word, with no parent array.
    """
    h, w = shape
    k = cfg.theta_res
    thetas, steer_costs = _steering_tables(cfg)
    vels = np.asarray([cfg.velocity, -cfg.velocity], np.float32)
    cfac = np.asarray([1.0, cfg.reverse_factor], np.float32)
    n_samples = max(2, int(math.ceil(cfg.velocity)))

    e = 2 * len(thetas)
    flat_off = np.zeros((k, e), np.int32)
    di_t = np.zeros((k, e), np.int32)
    dj_t = np.zeros((k, e), np.int32)
    cost_t = np.zeros((k, e), np.float32)
    nk_t = np.zeros((k, e), np.int32)
    seg = np.zeros((k, e, n_samples, 2), np.int32)
    binw = 2.0 * math.pi / k
    for kk in range(k):
        thc = (kk + 0.5) * binw
        ei = 0
        for vi, v in enumerate(vels):
            for si, st_ang in enumerate(thetas):
                nth = thc + (v / cfg.length) * math.tan(st_ang)
                dx = float(v * math.cos(nth))
                dy = float(v * math.sin(nth))
                dj = math.floor(0.5 + dx)
                di = math.floor(0.5 - dy)
                nk = int((nth % (2 * math.pi)) / binw) % k
                flat_off[kk, ei] = (di * w + dj) * k + (nk - kk)
                di_t[kk, ei] = di
                dj_t[kk, ei] = dj
                cost_t[kk, ei] = cfg.velocity + steer_costs[si] * cfac[vi]
                nk_t[kk, ei] = nk
                for t in range(n_samples):
                    f = (t + 1) / n_samples
                    seg[kk, ei, t, 0] = math.floor(0.5 - f * dy)  # di
                    seg[kk, ei, t, 1] = math.floor(0.5 + f * dx)  # dj
                ei += 1
    # Inverse adjacency: edge ei maps source bin kk -> target bin
    # nk_t[kk, ei] bijectively (constant heading shift), so invert it.
    inv_off = np.zeros((k, e), np.int32)
    for ei in range(e):
        assert len(set(nk_t[:, ei])) == k, "edge bin shift must be a bijection"
        for kk in range(k):
            inv_off[nk_t[kk, ei], ei] = flat_off[kk, ei]
    # Lattice validity: snapping headings to bin centers means rotation
    # only accumulates in whole bins — max-steer edges must cross a bin
    # boundary, i.e. (v/L)*tan(max_steering) >= half the bin width, or the
    # search can never turn (the classic state-lattice resolution match).
    turn = cfg.velocity / cfg.length * math.tan(cfg.max_steering)
    if turn < binw / 2:
        need = int(math.ceil(math.pi / turn))
        raise ValueError(
            f"lattice mode: per-edge heading change {math.degrees(turn):.1f} "
            f"deg cannot cross a {math.degrees(binw):.1f}-deg theta bin; "
            f"raise theta_res to >= {need} (or use mode='continuous')"
        )
    return flat_off, di_t, dj_t, cost_t, seg, inv_off, nk_t


def _lane_seqs(cfg, e: int):
    """Expansion lanes as edge-id SEQUENCES. Always the E single edges;
    `lattice_reps`=R adds the same-edge repetitions e^r (r = 2..R) —
    constant-steer arcs and straight runs whose every prefix is also a
    lane, so reachable costs are exactly unchanged while the frontier
    advances up to R steps per pop; `lattice_depth`=2 adds all E^2
    two-edge pairs (prone to a duplicate-target flood; kept as a config
    option). The stored parent edge of any macro commit
    is the LAST constituent edge; its predecessor along that edge was
    committed in the same round via the one-shorter prefix lane, so
    parent-chain recovery walks single edges regardless of lane depth."""
    if cfg.lattice_depth not in (1, 2):
        raise ValueError(f"lattice_depth must be 1 or 2, got {cfg.lattice_depth}")
    if cfg.lattice_reps < 1:
        raise ValueError(f"lattice_reps must be >= 1, got {cfg.lattice_reps}")
    seqs = [(ei,) for ei in range(e)]
    for r in range(2, cfg.lattice_reps + 1):
        seqs += [(ei,) * r for ei in range(e)]
    if cfg.lattice_depth == 2:
        seqs += [(e1, e2) for e1 in range(e) for e2 in range(e)]
    # depth-2 + reps>=2 both generate (e, e): dedup, preserving order.
    return list(dict.fromkeys(seqs))


def _lattice_lane_tables(cfg, flat_off, di_t, dj_t, cost_t, nk_t):
    """Per-bin lane tables for the `_lane_seqs` lanes: each lane is the
    composition of its edge sequence (offset/cell-delta/cost accumulate
    through the evolving theta bin).

    Returns (off, di, dj, cost, edge) each [K, L] / [L]."""
    k, e = flat_off.shape
    seqs = _lane_seqs(cfg, e)
    ln = len(seqs)
    off = np.zeros((k, ln), np.int32)
    di = np.zeros((k, ln), np.int32)
    dj = np.zeros((k, ln), np.int32)
    # Accumulate in the caller's cost dtype: passing PRE-quantized i32
    # single-edge costs makes every macro lane cost exactly the sum of its
    # steps (round-after-compose would drift +-1 quantum vs stepping).
    cost = np.zeros((k, ln), cost_t.dtype)
    edge = np.asarray([seq[-1] for seq in seqs], np.int32)
    for p, seq in enumerate(seqs):
        for kk in range(k):
            kb = kk
            for ei in seq:
                off[kk, p] += flat_off[kb, ei]
                di[kk, p] += di_t[kb, ei]
                dj[kk, p] += dj_t[kb, ei]
                cost[kk, p] += cost_t[kb, ei]
                kb = nk_t[kb, ei]
    return off, di, dj, cost, edge


# Packed lattice cost word: i32 = (g quantized to 1/_G_SCALE) << _EDGE_BITS
# | parent edge id. One scatter-min commits cost AND parent together (the
# low bits only break exact-g ties, deterministically); one [S] i32 carry
# replaces the separate g f32 + parent i32 arrays. 2^(31-_EDGE_BITS) /
# _G_SCALE caps representable path cost at ~4.2e6 map units.
_EDGE_BITS = 3
_G_SCALE = 64.0
_INF_PACKED = np.int32(2**31 - 1)


def _lattice_chain_device_impl(gp, inv_off, goal_idx, start_idx, k, max_len):
    """Walk (a chunk of) the lattice parent chain on device: a scan of
    scalar gathers emitting visited flat state indices goal->start (-1
    once finished), plus the carry (next_idx, done) so the host can
    CONTINUE the walk from next_idx when a chain outruns one chunk — the
    host fetches only [max_len] buffers, never the full [S] packed-cost
    array (see HybridAStar._walk_lattice_chain)."""
    emask = jnp.int32((1 << _EDGE_BITS) - 1)
    inf = jnp.int32(_INF_PACKED)

    def body(carry, _):
        idx, done = carry
        safe = jnp.clip(idx, 0, gp.shape[0] - 1)
        word = gp[safe]
        stop = done | (idx < 0) | (idx == start_idx) | (word == inf)
        out = jnp.where(stop, jnp.int32(-1), idx)
        nxt = idx - inv_off[safe % k, word & emask]
        return (jnp.where(stop, idx, nxt), stop), out

    (next_idx, done), cells = jax.lax.scan(
        body,
        (jnp.int32(goal_idx), jnp.bool_(False)),
        None,
        length=max_len,
    )
    return cells, next_idx, done


_lattice_chain_device = jax.jit(
    _lattice_chain_device_impl, static_argnums=(4, 5)
)


# Compiled feasibility builders keyed by static signature (see
# _lattice_feas_words): bounded by the distinct (map shape, cfg) pairs a
# process uses — online replanning reuses one entry for every replan.
_FEAS_BUILD_CACHE: dict = {}


def _lattice_feas_words(
    free: jax.Array, seg: np.ndarray, di_t, dj_t, nk_t, cfg
):
    """u32[S, W] per-node lane-feasibility words (bit l%32 of word l//32 =
    expansion lane l is clear from node n). A single-edge lane (k, e) is
    clear iff every sampled segment cell is free and in bounds — an AND
    of integer-shifted copies of the free mask (no raycasts; the
    "precomputed edge feasibility rolls"). A macro lane (repetition or
    depth-2 pair) ANDs each constituent edge's map shifted by the
    cumulative cell offset of its prefix (out-of-bounds intermediates
    land False automatically).

    The whole build runs as ONE jitted program: the static-shift loops
    would otherwise dispatch thousands of tiny eager device ops. The COMPILED program is cached by
    its static signature (shape + steering tables + cfg): online
    replanning rebuilds feasibility on every fresh map (`reset`), and a
    per-call `jax.jit` re-traced and re-compiled this large unrolled
    program each time — the dominant replan cost in apps/slam_replan.py
    (with the cache only the first replan compiles)."""
    h, w = free.shape
    k, e, t, _ = seg.shape
    seqs = _lane_seqs(cfg, e)
    lanes_n = len(seqs)
    words = -(-lanes_n // 32)
    cache_key = (
        (h, w),
        cfg,
        seg.tobytes(),
        np.asarray(di_t).tobytes(),
        np.asarray(dj_t).tobytes(),
        np.asarray(nk_t).tobytes(),
    )
    cached = _FEAS_BUILD_CACHE.get(cache_key)
    if cached is not None:
        return cached(free)

    def build(free):
        free = jnp.asarray(free, bool)

        def shifted(arr, di, dj):
            # arr[i + di, j + dj] with out-of-bounds -> False.
            out = jnp.zeros((h, w), bool)
            src_i = slice(max(di, 0), h + min(di, 0))
            src_j = slice(max(dj, 0), w + min(dj, 0))
            dst_i = slice(max(-di, 0), h + min(-di, 0))
            dst_j = slice(max(-dj, 0), w + min(-dj, 0))
            return out.at[dst_i, dst_j].set(arr[src_i, src_j])

        # Dedup identical shifts across all (k, e, t) to one pass each.
        maps = {}
        F = [[None] * e for _ in range(k)]
        for kk in range(k):
            for ei in range(e):
                acc = None
                for ti in range(t):
                    key = (int(seg[kk, ei, ti, 0]), int(seg[kk, ei, ti, 1]))
                    if key not in maps:
                        maps[key] = shifted(free, *key)
                    acc = maps[key] if acc is None else (acc & maps[key])
                F[kk][ei] = acc

        # Shifted single-edge maps memoized across lanes/bins: prefix
        # lanes (e^2 inside e^3, pairs sharing a first edge) reuse them.
        shift_cache = {}

        def edge_map(kb, ei, ci, cj):
            key = (kb, ei, ci, cj)
            if key not in shift_cache:
                shift_cache[key] = (
                    F[kb][ei] if ci == 0 and cj == 0
                    else shifted(F[kb][ei], ci, cj)
                )
            return shift_cache[key]

        per_k_words = []
        for kk in range(k):
            lanes = []
            for seq in seqs:
                acc = None
                ci = cj = 0
                kb = kk
                for ei in seq:
                    m = edge_map(kb, ei, ci, cj)
                    acc = m if acc is None else (acc & m)
                    ci += int(di_t[kb, ei])
                    cj += int(dj_t[kb, ei])
                    kb = int(nk_t[kb, ei])
                lanes.append(acc)
            wk = []
            for wi in range(words):
                acc = jnp.zeros((h, w), jnp.uint32)
                for b in range(32):
                    ll = wi * 32 + b
                    if ll < lanes_n:
                        acc = acc | (lanes[ll].astype(jnp.uint32) << b)
                wk.append(acc)
            per_k_words.append(jnp.stack(wk))  # [W, H, W]
        allw = jnp.stack(per_k_words)  # [K, Wn, H, W]
        # Node-major [S, Wn], S = cell*K + k: one tiny row gather per pop.
        return (
            allw.reshape(k, words, h * w)
            .transpose(2, 0, 1)
            .reshape(h * w * k, words)
        )

    fn = jax.jit(build)
    _FEAS_BUILD_CACHE[cache_key] = fn
    return fn(free)


@struct.dataclass
class LatticeState:
    """Lattice-mode search state: one packed cost/parent-edge word per
    cuboid cell plus a COMPACT open list — a [capacity] ring of (cuboid
    idx, f) entries holding every not-yet-popped g-improvement. Selection
    scans the list, never the cuboid: per-round cost is
    O(capacity + batch*E), independent of map size (the full-cuboid f-pass
    was ~95% of the round at theta_res=36). The round is latency-, not
    compute-, bound, so the design minimizes the op dependency chain: one
    i32 scatter-min commits (g, parent edge) together, and feasibility is
    one u32 word-row gather per pop (bit per lane). Ring inserts ARE
    filtered through one post-scatter winner gather — measured worth its
    chain slot: without it, same-round corridor duplicates flood the ring
    with stale entries that waste future pop slots (remaining stale
    entries die by lazy deletion at pop time)."""

    gp: jax.Array  # i32[S] packed (g << _EDGE_BITS | edge); _INF_PACKED=unset
    o_idx: jax.Array  # i32[C] cuboid index per open entry
    o_f: jax.Array  # f32[C] f = g + h at insert time (INF = empty slot)
    wp: jax.Array  # i32 ring write pointer (total insertions)
    goal_idx: jax.Array
    goal_cost: jax.Array
    n_expanded: jax.Array
    # i32: not-yet-popped ring entries overwritten by wraparound
    # (conservative: stale duplicates count too). > 0 means the frontier
    # MAY have lost nodes — a subsequent "open list empty" exhaustion is
    # then not a proof of unreachability (solve logs a warning).
    n_lost: jax.Array
    # i32: the seeded start cuboid index (see HAState.start_idx).
    start_idx: jax.Array


def _lattice_round(
    st: LatticeState, feasw, off_t, di_t, dj_t, cost_q, edge_t, goal,
    target_bin, hfield, cfg, shape,
):
    """One batched expansion over the compact open list. Tables are
    [K, L]-laned over the `_lane_seqs` lanes (E single edges, plus
    same-edge repetitions at lattice_reps>=2 and/or the E^2 pairs at
    lattice_depth=2); `feasw` is the u32[S, W] lane-bit table."""
    h, w = shape
    kbins = cfg.theta_res
    kpop = cfg.batch
    s = st.gp.shape[0]
    c = st.o_f.shape[0]
    inv_scale = np.float32(1.0 / _G_SCALE)

    # Grouped best-of pops from the [C] list (not the [S] cuboid).
    f2 = st.o_f.reshape(-1, kpop)  # capacity is a multiple of batch
    rel = jnp.argmin(f2, axis=0)
    cols = jnp.arange(kpop, dtype=jnp.int32)
    pos = rel.astype(jnp.int32) * kpop + cols
    fpop = jnp.take_along_axis(f2, rel[None, :], axis=0)[0]
    pop_valid = fpop < INF
    pop = jnp.where(pop_valid, st.o_idx[pos], 0)
    o_f = st.o_f.at[jnp.where(pop_valid, pos, c)].set(INF, mode="drop")

    cell = pop // kbins
    gq = st.gp[pop] >> _EDGE_BITS  # i32 quantized g
    gg = gq.astype(jnp.float32) * inv_scale
    # Lazy deletion (`slam/hastar.cpp:172-176`): an entry whose node's g
    # improved after insertion is stale — skip its expansion entirely.
    # hfield is per-CELL [H*W] in lattice mode (theta-independent).
    fresh = fpop <= gg + hfield[cell] + 1e-3
    pop_valid = pop_valid & fresh
    kk = pop % kbins
    i = cell // w
    j = cell % w

    # Goal test on the cell-center pose.
    cx = j.astype(jnp.float32) + 0.5
    cy = (h - i).astype(jnp.float32) - 0.5
    d2goal = (cx - goal[0]) ** 2 + (cy - goal[1]) ** 2
    bin_ok = cfg.diff_drive | (kk == target_bin)
    at_goal = (d2goal <= cfg.tol * cfg.tol) & bin_ok & pop_valid
    any_goal = jnp.any(at_goal)
    first = jnp.argmin(jnp.where(at_goal, fpop, INF))
    goal_better = any_goal & (st.goal_idx < 0)
    goal_idx = jnp.where(goal_better, pop[first], st.goal_idx)
    goal_cost = jnp.where(goal_better, gg[first], st.goal_cost)

    # Successors: static per-bin tables, [batch, L].
    off = off_t[kk]  # [batch, L]
    ni = i[:, None] + di_t[kk]
    nj = j[:, None] + dj_t[kk]
    inb = (ni >= 0) & (ni < h) & (nj >= 0) & (nj < w)
    lanes_n = di_t.shape[1]
    # Feasibility: one tiny u32-row gather per pop (lane l of node n is
    # bit l%32 of feasw[n, l//32]). Scalar sub-word gathers at
    # (etype, cell) each pay a gather's fixed cost; one word row per pop
    # is the floor.
    fw = feasw[pop]  # [batch, W] u32
    lane_word = np.arange(lanes_n, dtype=np.int32) // 32
    lane_bit = jnp.asarray(
        np.arange(lanes_n, dtype=np.int32) % 32, jnp.uint32
    )
    clear = (fw[:, lane_word] >> lane_bit[None, :]) & jnp.uint32(1)
    ok = inb & (clear > 0) & pop_valid[:, None]

    tgt = jnp.clip(pop[:, None] + off, 0, s - 1)
    candq = gq[:, None] + cost_q[kk]  # i32 [batch, L]
    if cfg.lattice_skip_precheck:
        # EXPERIMENT KNOB — default stays False. Dropping the st.gp[tgt]
        # readback (one of ~6 scattered [batch, L] ops) saves nothing when
        # XLA fuses the gather into the scatter-min (tools/hastar_ab.py
        # --sweep precheck compares), and the equal-packed re-insert
        # duplicates it admits degrade path cost at small batches
        # (745 -> 755 at b1024) and explode the round count at w == 1.0
        # (116 -> 222 rounds) or with macro lanes (29 -> 119, equal-g
        # re-derivations by construction).
        imp = ok
    else:
        imp = ok & (candq < (st.gp[tgt] >> _EDGE_BITS))
    packed = jnp.where(
        imp, (candq << _EDGE_BITS) | edge_t[None, :], _INF_PACKED
    )

    tgt_f = tgt.reshape(-1)
    packed_f = packed.reshape(-1)
    gp = st.gp.at[tgt_f].min(packed_f)

    # Insert improvements: compact to consecutive ring slots. Dead (goal-
    # unreachable, h == INF) successors are not inserted, so the search
    # terminates on exhaustion. Only scatter-min WINNERS insert (one
    # post-scatter row gather): several same-round pops along a corridor
    # commit the same cell through different lanes, and inserting the
    # losers floods the ring with stale entries that waste future pop
    # slots — with macro lanes the duplicate rate scales with reps.
    imp_f = imp.reshape(-1)
    fnew = (
        (candq.reshape(-1).astype(jnp.float32)) * inv_scale
        + hfield[tgt_f // kbins]
    )
    insert = imp_f & (fnew < INF) & (packed.reshape(-1) == gp[tgt_f])
    rank = jnp.cumsum(insert.astype(jnp.int32)) - 1
    slot = jnp.where(insert, (st.wp + rank) % c, c)
    # Wraparound audit: a still-live entry in a recycled slot is a lost
    # frontier node (see LatticeState.n_lost). Read before overwriting;
    # if one round inserts more than the whole ring holds, the slots
    # that collide within the round destroy each other too (the scatter
    # keeps one arbitrary winner per slot) — count those explicitly.
    n_ins = jnp.sum(insert)
    lost = jnp.sum(
        jnp.where(insert, o_f[jnp.minimum(slot, c - 1)] < INF, False)
    ) + jnp.maximum(0, n_ins - c)
    o_idx = st.o_idx.at[slot].set(tgt_f, mode="drop")
    o_f = o_f.at[slot].set(fnew, mode="drop")

    return st.replace(
        gp=gp,
        o_idx=o_idx,
        o_f=o_f,
        wp=st.wp + jnp.sum(insert),
        goal_idx=goal_idx,
        goal_cost=goal_cost,
        n_expanded=st.n_expanded + jnp.sum(pop_valid),
        n_lost=st.n_lost + lost,
    )


def _weight_h(hfield, cfg):
    """Weighted-A* heuristic inflation (f = g + weight*h), preserving the
    INF = goal-unreachable sentinel exactly."""
    if cfg.heuristic_weight == 1.0:
        return hfield
    return jnp.where(hfield < INF, hfield * cfg.heuristic_weight, INF)


def _coarse_geodesic_cells(free, bx, by, cfg, shape):
    """Per-cell [H*W] goal-distance heuristic: the A* wavefront on a
    `coarse`-downsampled grid (max-pooled free space -> admissible
    underestimate), tiled back to full resolution. Pure/traceable."""
    from slam_tpu.planners import astar as astar_mod

    h, w = shape
    f4 = max(1, cfg.coarse)
    ph = (-h) % f4
    pw = (-w) % f4
    fpad = jnp.pad(free, ((0, ph), (0, pw)))
    free_c = fpad.reshape((h + ph) // f4, f4, (w + pw) // f4, f4).any((1, 3))
    gi = jnp.clip(jnp.floor(h - by - 1.0).astype(jnp.int32), 0, h - 1) // f4
    gj = jnp.clip(jnp.floor(bx).astype(jnp.int32), 0, w - 1) // f4
    dc = astar_mod.distance_field(free_c, jnp.stack([gi, gj]))
    h2d = jnp.repeat(jnp.repeat(dc * f4, f4, 0), f4, 1)[:h, :w]
    return jnp.minimum(h2d, INF).reshape(-1)


def _lattice_query_init(free, a_xyt, b_xyt, cfg, shape, cap):
    """Whole lattice reset_query as ONE device program: start/goal
    indexing, the geodesic heuristic build (its own while_loop), and the
    initial state fills. Eagerly this was ~10 dispatches per query."""
    h, w = shape
    k = cfg.theta_res
    s = h * w * k
    start_idx = _pose_to_cuboid(shape, k, a_xyt[0], a_xyt[1], a_xyt[2])
    target_bin = (
        _pose_to_cuboid(shape, k, b_xyt[0], b_xyt[1], b_xyt[2]) % k
    ).astype(jnp.int32)
    goal = b_xyt[:2]
    if cfg.heuristic == "geodesic":
        hfield = _coarse_geodesic_cells(free, b_xyt[0], b_xyt[1], cfg, shape)
    else:
        ii = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
        jj = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        d = jnp.sqrt(
            (jj + 0.5 - b_xyt[0]) ** 2 + ((h - ii) - 0.5 - b_xyt[1]) ** 2
        )
        hfield = d.reshape(-1)
    hfield = _weight_h(hfield, cfg)
    state = LatticeState(
        gp=jnp.full((s,), _INF_PACKED, jnp.int32).at[start_idx].set(0),
        o_idx=jnp.zeros((cap,), jnp.int32)
        .at[0]
        .set(start_idx.astype(jnp.int32)),
        o_f=jnp.full((cap,), INF).at[0].set(hfield[start_idx // k]),
        wp=jnp.int32(1),
        goal_idx=jnp.int32(-1),
        goal_cost=jnp.float32(INF),
        n_expanded=jnp.int32(0),
        n_lost=jnp.int32(0),
        start_idx=start_idx.astype(jnp.int32),
    )
    return goal, target_bin, hfield, state


_lattice_query_init_jit = jax.jit(
    _lattice_query_init, static_argnums=(3, 4, 5)
)


def _lattice_solve_query(
    free, a_xyt, b_xyt, feasw, off_t, di_t, dj_t, cost_q, edge_t,
    max_rounds, cfg, shape, cap,
):
    """Fresh query end-to-end (init + full search) as ONE device program:
    one dispatch instead of one per phase."""
    goal, target_bin, hfield, st = _lattice_query_init(
        free, a_xyt, b_xyt, cfg, shape, cap
    )
    st = _lattice_solve(
        st, feasw, off_t, di_t, dj_t, cost_q, edge_t, goal, target_bin,
        hfield, max_rounds, cfg, shape,
    )
    return goal, target_bin, hfield, st


_lattice_solve_query_jit = jax.jit(
    _lattice_solve_query, static_argnums=(10, 11, 12)
)


def _lattice_solve(
    st, feasw, off_t, di_t, dj_t, cost_q, edge_t, goal, target_bin, hfield,
    max_rounds, cfg, shape,
):
    def cond(carry):
        st, rounds = carry
        return (
            (st.goal_idx < 0)
            & jnp.any(st.o_f < INF)
            & (rounds < max_rounds)
        )

    def body(carry):
        st, rounds = carry
        # 2 rounds per loop iteration: halves the per-iteration carry
        # pass + cond scan (the loop is latency-, not compute-, bound).
        # An extra round past the goal is harmless — goal_idx latches.
        for _ in range(2):
            st = _lattice_round(
                st, feasw, off_t, di_t, dj_t, cost_q, edge_t, goal,
                target_bin, hfield, cfg, shape,
            )
        return st, rounds + 2

    st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
    return st


def _ha_query_init(free, a_xyt, b_xyt, cfg, shape):
    """Continuous-mode reset_query as ONE traced program (mirrors
    `_lattice_query_init`): start/goal indexing, heuristic build, state
    fills."""
    h, w = shape
    k = cfg.theta_res
    s = h * w * k
    start_idx = _pose_to_cuboid(shape, k, a_xyt[0], a_xyt[1], a_xyt[2])
    target_bin = (
        _pose_to_cuboid(shape, k, b_xyt[0], b_xyt[1], b_xyt[2]) % k
    ).astype(jnp.int32)
    goal = b_xyt[:2]
    if cfg.heuristic == "geodesic":
        cells = _weight_h(
            _coarse_geodesic_cells(free, b_xyt[0], b_xyt[1], cfg, shape), cfg
        )
        hfield = jnp.repeat(cells, k)
        h_start = hfield[start_idx]
    else:
        hfield = jnp.zeros((1,), jnp.float32)  # computed in-round
        h_start = cfg.heuristic_weight * jnp.sqrt(
            (a_xyt[0] - b_xyt[0]) ** 2 + (a_xyt[1] - b_xyt[1]) ** 2
        )
    state = HAState(
        g=jnp.full((s,), INF).at[start_idx].set(0.0),
        parent=jnp.full((s,), -1, jnp.int32),
        px=jnp.zeros((s,), jnp.float32).at[start_idx].set(a_xyt[0]),
        py=jnp.zeros((s,), jnp.float32).at[start_idx].set(a_xyt[1]),
        pth=jnp.zeros((s,), jnp.float32).at[start_idx].set(a_xyt[2]),
        open_f=jnp.full((s,), INF).at[start_idx].set(h_start),
        goal_idx=jnp.int32(-1),
        goal_cost=jnp.float32(INF),
        n_expanded=jnp.int32(0),
        start_idx=start_idx.astype(jnp.int32),
    )
    return goal, target_bin, hfield, state


def _ha_solve_query(free, a_xyt, b_xyt, field, max_rounds, cfg, shape, rc):
    """Fresh continuous-mode query end-to-end as ONE device program."""
    goal, target_bin, hfield, st = _ha_query_init(
        free, a_xyt, b_xyt, cfg, shape
    )
    st = _ha_solve(st, field, goal, target_bin, hfield, max_rounds, cfg, rc)
    return goal, target_bin, hfield, st


_ha_query_init_jit = jax.jit(_ha_query_init, static_argnums=(3, 4))
_ha_solve_query_jit = jax.jit(_ha_solve_query, static_argnums=(5, 6, 7))


def _ha_solve(st, field, goal, target_bin, hfield, max_rounds, cfg, rc):
    """Whole search as ONE device program: a while_loop over rounds, so a
    full pathfind costs a single host<->device round trip (the per-round
    incremental API stays for animation parity)."""

    def cond(carry):
        st, rounds = carry
        return (
            (st.goal_idx < 0)
            & jnp.any(st.open_f < INF)
            & (rounds < max_rounds)
        )

    def body(carry):
        st, rounds = carry
        return _ha_round(st, field, goal, target_bin, hfield, cfg, rc), rounds + 1

    st, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
    return st


_ha_round_jit = jax.jit(_ha_round, static_argnums=(5, 6))
_ha_solve_jit = jax.jit(_ha_solve, static_argnums=(6, 7))
_lattice_round_jit = jax.jit(_lattice_round, static_argnums=(10, 11))
_lattice_solve_jit = jax.jit(_lattice_solve, static_argnums=(11, 12))

# Fleet mode: Q independent queries solved in lockstep — per-round work is
# Q x batch x L lanes, so the ~1-2 ms/round device floor (scatter latency x
# ~path-depth rounds) amortizes over the whole query batch. The map tables
# (feasibility rolls, steering offsets) are shared; state/goal/heuristic are
# per-query.
_lattice_solve_many_jit = jax.jit(
    jax.vmap(
        _lattice_solve,
        in_axes=(
            0, None, None, None, None, None, None, 0, 0, 0, None, None, None,
        ),
    ),
    static_argnums=(11, 12),
)


class HybridAStar:
    """Facade mirroring `slam/hastar.h:14-119` (reset / pathfind /
    recover_path) with a jitted batched round."""

    def __init__(
        self,
        free: jax.Array,
        a: Pose,
        b: Pose,
        cfg: HybridAStarConfig = HybridAStarConfig(),
        rc: RaycastConfig = RaycastConfig(backend="sdf", step=1.0),
    ):
        self.cfg = cfg
        # Collision rays only need to cover one steering arc (length = v);
        # clamping max_dist makes every ray resolve in a handful of
        # sphere-trace iterations instead of marching the lidar range.
        import dataclasses

        self.rc = dataclasses.replace(
            rc, max_dist=min(rc.max_dist, cfg.velocity + 2.0)
        )
        self.reset(free, a, b)

    # -- cuboid indexing (`slam/hastar.cpp:234-241`) ----------------------

    def _pose_to_cuboid(self, x, y, theta):
        return _pose_to_cuboid(self.shape, self.cfg.theta_res, x, y, theta)

    def reset(self, free: jax.Array, a: Pose, b: Pose):
        """New map + new query (`slam/hastar.cpp:30-81`). For a new query on
        the SAME map use `reset_query` — it keeps the prebuilt ray field
        (the expensive part, especially for the lut edge backend)."""
        free = jnp.asarray(free, bool)
        self.shape = free.shape
        self._free = free
        if self.cfg.mode == "lattice":
            # No raycasts in lattice mode: feasibility is precomputed as
            # shifted-AND maps; the ray field build is skipped entirely.
            self.field = RayField(blocked=~free)
            flat_off, di_t, dj_t, cost_t, seg, inv_off, nk_t = (
                _lattice_tables(self.cfg, self.shape)
            )
            e_n = di_t.shape[1]
            if e_n > (1 << _EDGE_BITS):
                raise ValueError(
                    f"lattice mode packs the parent edge in {_EDGE_BITS} "
                    f"bits; branching_factor {self.cfg.branching_factor} "
                    f"needs {e_n} edge ids"
                )
            cost_q = np.round(cost_t * _G_SCALE).astype(np.int32)
            off_l, di_l, dj_l, cost_l, edge_l = _lattice_lane_tables(
                self.cfg, flat_off, di_t, dj_t, cost_q, nk_t
            )
            self._lat_feas = _lattice_feas_words(
                free, seg, di_t, dj_t, nk_t, self.cfg
            )
            self._lat_off = jnp.asarray(off_l)
            self._lat_di = jnp.asarray(di_l)
            self._lat_dj = jnp.asarray(dj_l)
            self._lat_cost = jnp.asarray(cost_l)
            self._lat_edge = jnp.asarray(edge_l)
            self._lat_inv_off = inv_off  # host copy (kept for debugging)
            self._lat_inv_off_dev = jnp.asarray(inv_off)
        else:
            self.field = make_ray_field(~free, self.rc)
        self.reset_query(a, b)

    def reset_query(self, a: Pose, b: Pose):
        """Re-target start/goal, reusing the map's ray field. Reset is
        LAZY in both modes: `solve` on a fresh query fuses init (heuristic
        wavefront included) + search into one device program (one
        dispatch); the incremental `pathfind` API materializes first."""
        self.a = a
        self.b = b
        self.success = False
        self.used_up = False
        self._pending = (
            jnp.asarray([a.x, a.y, a.theta], jnp.float32),
            jnp.asarray([b.x, b.y, b.theta], jnp.float32),
        )
        self.state = None
        self._fleet_state = None

    # -- driver -----------------------------------------------------------

    def _ring_capacity(self) -> int:
        # The DEFAULT capacity (open_capacity=None -> 1M) is clamped to
        # ~4x the cuboid (more slots than that rarely hold distinct useful
        # entries on small maps, and the per-round argmin scans the ring);
        # an EXPLICIT user capacity is honored as-is — the n_lost overflow
        # warning tells users to raise it, which must not be a silent
        # no-op.
        cap = self.cfg.open_capacity
        if cap is None:
            s = self.shape[0] * self.shape[1] * self.cfg.theta_res
            cap = min(1 << 20, 4 * s)
        cap = max(cap, self.cfg.batch)
        return -(-cap // self.cfg.batch) * self.cfg.batch

    def _ensure_query_state(self):
        """Materialize the lazy query state (incremental API / fleet
        stacking; `solve` on a fresh query skips this and fuses)."""
        if self.state is not None:
            return
        a_xyt, b_xyt = self._pending
        if self.cfg.mode == "lattice":
            (self._goal, self._target_bin, self._hfield, self.state) = (
                _lattice_query_init_jit(
                    self._free, a_xyt, b_xyt, self.cfg, self.shape,
                    self._ring_capacity(),
                )
            )
        else:
            (self._goal, self._target_bin, self._hfield, self.state) = (
                _ha_query_init_jit(
                    self._free, a_xyt, b_xyt, self.cfg, self.shape
                )
            )

    def pathfind(self) -> bool:
        """One batched round; True when finished (`slam/hastar.cpp:152-214`
        returns True on success/exhaustion)."""
        if self.success or self.used_up:
            return True
        self._ensure_query_state()
        if self.cfg.mode == "lattice":
            self.state = _lattice_round_jit(
                self.state, self._lat_feas, self._lat_off, self._lat_di,
                self._lat_dj, self._lat_cost, self._lat_edge, self._goal,
                self._target_bin, self._hfield, self.cfg, self.shape,
            )
        else:
            self.state = _ha_round_jit(
                self.state, self.field, self._goal, self._target_bin,
                self._hfield, self.cfg, self.rc,
            )
        if int(self.state.goal_idx) >= 0:
            self.success = True
            return True
        open_any = (
            jnp.any(self.state.o_f < INF)
            if self.cfg.mode == "lattice"
            else jnp.any(self.state.open_f < INF)
        )
        if not bool(open_any):
            self.used_up = True
            self._warn_if_overflowed(open_known_empty=True)
            return True
        return False

    def _warn_if_overflowed(self, open_known_empty: bool = False):
        """Exhaustion with ring-overwritten entries is not a proof of
        unreachability — surface it (lattice mode only). A run that
        merely hit max_rounds (open list non-empty) is not an exhaustion
        verdict and does not warrant the warning. `open_known_empty`
        skips the emptiness re-fetch when the caller just computed it
        (each eager op is a host round trip)."""
        if self.cfg.mode != "lattice" or self.success:
            return
        if not open_known_empty and bool(jnp.any(self.state.o_f < INF)):
            return
        lost = int(self.state.n_lost)
        if lost > 0:
            from slam_tpu.utils.logging import get_logger

            get_logger().warning(
                "hastar lattice: open ring overwrote %d not-yet-popped "
                "entries (capacity %d); exhaustion is inconclusive — "
                "raise HybridAStarConfig.open_capacity",
                lost,
                self._ring_capacity(),
            )

    def solve(self, max_rounds: Optional[int] = None) -> bool:
        max_rounds = max_rounds or self.cfg.max_rounds
        if self.cfg.mode == "lattice":
            if self.state is None:
                # Fresh query: init + search in one fused dispatch.
                a_xyt, b_xyt = self._pending
                (self._goal, self._target_bin, self._hfield, self.state) = (
                    _lattice_solve_query_jit(
                        self._free, a_xyt, b_xyt, self._lat_feas,
                        self._lat_off, self._lat_di, self._lat_dj,
                        self._lat_cost, self._lat_edge,
                        jnp.int32(max_rounds), self.cfg, self.shape,
                        self._ring_capacity(),
                    )
                )
            else:
                self.state = _lattice_solve_jit(
                    self.state, self._lat_feas, self._lat_off, self._lat_di,
                    self._lat_dj, self._lat_cost, self._lat_edge,
                    self._goal, self._target_bin, self._hfield,
                    jnp.int32(max_rounds), self.cfg, self.shape,
                )
        elif self.state is None:
            # Fresh query: init + search in one fused dispatch.
            a_xyt, b_xyt = self._pending
            (self._goal, self._target_bin, self._hfield, self.state) = (
                _ha_solve_query_jit(
                    self._free, a_xyt, b_xyt, self.field,
                    jnp.int32(max_rounds), self.cfg, self.shape, self.rc,
                )
            )
        else:
            self.state = _ha_solve_jit(
                self.state,
                self.field,
                self._goal,
                self._target_bin,
                self._hfield,
                jnp.int32(max_rounds),
                self.cfg,
                self.rc,
            )
        if int(self.state.goal_idx) >= 0:
            self.success = True
        else:
            self.used_up = True
            self._warn_if_overflowed()
        return self.success

    def solve_many(
        self,
        queries,
        max_rounds: Optional[int] = None,
        query_sharding=None,
    ):
        """Solve Q independent (start, goal) queries in one device program
        (lattice mode only): states advance in lockstep, so the per-round
        device floor amortizes across the fleet. Returns a list of
        (success, cost) per query; `recover_path_for(q)` then walks query
        q's parent chain.

        The reference replans one mouse query at a time
        (`apps/hastar_planner.cpp:50-117`); a robot fleet sharing one map is
        the workload where a batched planner earns its keep.

        `query_sharding` (optional `jax.sharding.Sharding`, e.g.
        `NamedSharding(mesh, P('p'))`) pins the stacked query axis to a
        device mesh: Q must divide by the axis size; the steering/feasibility
        tables stay replicated and the queries solve embarrassingly parallel
        (no cross-query collectives).
        """
        if self.cfg.mode != "lattice":
            raise ValueError("solve_many requires mode='lattice'")
        max_rounds = max_rounds or self.cfg.max_rounds
        states, goals, tbins, hfields = [], [], [], []
        for a, b in queries:
            self.reset_query(a, b)
            self._ensure_query_state()
            states.append(self.state)
            goals.append(self._goal)
            tbins.append(self._target_bin)
            hfields.append(self._hfield)
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
        goals_q = jnp.stack(goals)
        tbins_q = jnp.stack(tbins)
        hfields_q = jnp.stack(hfields)
        if query_sharding is not None:
            # The required divisor is the shard count ALONG THE QUERY AXIS,
            # not the sharding's total device count: on a multi-axis mesh
            # (e.g. ('p','b')) NamedSharding(mesh, P('p')) splits axis 0 by
            # mesh.shape['p'] only, so gating on num_devices would reject
            # valid Q values.
            spec = getattr(query_sharding, "spec", None)
            smesh = getattr(query_sharding, "mesh", None)
            if spec is not None and smesh is not None:
                axes = spec[0] if len(spec) else None
                if axes is None:
                    axes = ()
                elif isinstance(axes, str):
                    axes = (axes,)
                n_shards = 1
                for ax in axes:
                    n_shards *= smesh.shape[ax]
            else:
                n_shards = getattr(query_sharding, "num_devices", None) or len(
                    query_sharding.device_set
                )
            if len(queries) % n_shards:
                # device_put would otherwise fail deep inside GSPMD with an
                # opaque un-divisible-dimension error naming neither the
                # queries nor the documented constraint.
                raise ValueError(
                    f"solve_many got {len(queries)} queries over a "
                    f"{n_shards}-device query sharding — Q must divide by "
                    "the sharded axis size (pad with repeated queries)"
                )
            stacked, goals_q, tbins_q, hfields_q = jax.device_put(
                (stacked, goals_q, tbins_q, hfields_q), query_sharding
            )
        out = _lattice_solve_many_jit(
            stacked,
            self._lat_feas,
            self._lat_off,
            self._lat_di,
            self._lat_dj,
            self._lat_cost,
            self._lat_edge,
            goals_q,
            tbins_q,
            hfields_q,
            jnp.int32(max_rounds),
            self.cfg,
            self.shape,
        )
        results = []
        goal_idx = np.asarray(out.goal_idx)
        goal_cost = np.asarray(out.goal_cost)
        for q in range(len(queries)):
            results.append((int(goal_idx[q]) >= 0, float(goal_cost[q])))
        self._fleet_state = out
        return results

    def recover_path_for(self, q: int) -> List[Tuple[int, int]]:
        """Parent-chain walk (image coords) for query q of the last
        `solve_many` batch — the fleet analogue of `recover_path`. Only
        valid until the next `reset_query`/`solve_many`."""
        if self._fleet_state is None:
            raise ValueError(
                "recover_path_for: no solve_many results are live "
                "(call solve_many first; reset_query invalidates them)"
            )
        out = self._fleet_state
        idx = int(out.goal_idx[q])
        if idx < 0:
            return []
        return self._walk_lattice_chain(out.gp[q], idx, int(out.start_idx[q]))

    def _walk_lattice_chain(self, gp, idx, start_idx):
        """Parent-chain walk ON DEVICE (round 5): the naive host walk
        fetched the full [S] packed-cost array per recovery — 75 MB at
        maze scale, the dominant cost of online replanning
        (apps/slam_replan.py). A fixed-length
        lax.scan of scalar gathers walks the chain on device and the host
        fetches only the [max_len] visited-index buffer (<= 128 KB)."""
        k = self.cfg.theta_res
        w = self.shape[1]
        s_total = int(np.prod(self.shape)) * k
        # Chunk size of the device walk; overridable (tests shrink it to
        # exercise the multi-chunk continuation on short paths).
        max_len = int(min(s_total, getattr(self, "_chain_chunk", 1 << 15)))
        gp = gp if hasattr(gp, "dtype") else jnp.asarray(gp)
        cur = jnp.int32(idx)
        chunks = []
        total = 0
        while True:
            cells, cur, done = _lattice_chain_device(
                gp,
                self._lat_inv_off_dev,
                cur,
                jnp.int32(start_idx),
                k,
                max_len,
            )
            cells = np.asarray(cells)
            chunks.append(cells[cells >= 0])
            total += max_len
            if bool(done) or total >= s_total:
                # total >= s_total means the chain revisited a state (a
                # cycle cannot occur in a consistent gp; bail rather than
                # loop forever on corrupted state).
                break
        cells = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        path = [(int(c) // k // w, int(c) // k % w) for c in cells]
        path.reverse()
        return path

    def recover_path(self) -> List[Tuple[int, int]]:
        """Parent-chain walk returning image coords
        (`slam/hastar.cpp:216-232`). Lattice mode stores no parent array:
        the chain follows the per-node parent EDGE id (low bits of the
        packed cost word) back through the inverse steering table."""
        if not self.success:
            return []
        k = self.cfg.theta_res
        w = self.shape[1]
        path = []
        idx = int(self.state.goal_idx)
        # The index that actually seeded the search, carried from the
        # device query init (host f32 replays can disagree by 1 ulp at
        # bin/cell boundaries).
        start_idx = int(self.state.start_idx)
        seen = 0
        if self.cfg.mode == "lattice":
            return self._walk_lattice_chain(self.state.gp, idx, start_idx)
        parent = np.asarray(self.state.parent)
        while idx >= 0 and idx != start_idx and seen <= len(parent):
            cell = idx // k
            path.append((cell // w, cell % w))
            idx = int(parent[idx])
            seen += 1
        path.reverse()
        return path

    def path_cost(self) -> float:
        return float(self.state.goal_cost)
