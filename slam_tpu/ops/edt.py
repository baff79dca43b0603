"""Euclidean distance transforms over occupancy grids.

The reference raycasts by scalar fixed-step DDA marching (`slam/raycast.cpp:
8-141`) — up to max_dist/step (1000) sequential cell probes per ray. That is
hostile to an accelerator (a long chain of dependent scalar gathers). The
vectorized design precomputes a distance field over the map and lets rays take
obstacle-aware adaptive steps (sphere tracing, see ops/raycast.py:raycast_sdf),
turning ~1000 probes into ~tens.

Three implementations:

  * `edt_exact` — exact Euclidean distance via the separable decomposition:
    a vertical run-length pass (cummax/cummin index tricks, no gathers)
    followed by a blocked (min,+) row pass over squared column distances.
    O(H * W^2 / block) work, fully vectorized; the oracle.
  * `edt_jfa` — jump-flooding (JFA+1): O(H * W * log) shifted-min passes,
    no gathers at all. Distances are exact except for rare small
    overestimates; consumers compensate with a safety margin. The UNCAPPED
    workhorse (static-map sdf fields).
  * `edt_capped` — range-capped exact separable transform, O(H * W * cap):
    the per-step SLAM rebuild (the likelihood-field model only resolves
    ~5 sigma of distance). Fewer ALU ops than the JFA at the SLAM cap and
    exact within it; `edt_refresh` updates it incrementally after
    localized map edits (bitwise-equal to a full rebuild).

Distances are measured between CELL CENTERS in pixels; blocked cells have
distance 0.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def _vertical_sq_dist(blocked: jax.Array, big: float) -> jax.Array:
    """f32[H, W]: squared distance to the nearest blocked cell in the same
    column (big^2 where the column has none)."""
    h = blocked.shape[0]
    ii = jax.lax.broadcasted_iota(jnp.int32, blocked.shape, 0)
    up = ii - jax.lax.cummax(jnp.where(blocked, ii, -(1 << 30)), axis=0)
    down = jax.lax.cummin(jnp.where(blocked, ii, 1 << 30), axis=0, reverse=True) - ii
    g = jnp.minimum(jnp.minimum(up, down), int(big)).astype(jnp.float32)
    return g * g


def edt_exact(blocked: jax.Array, block: int = 64) -> jax.Array:
    """Exact Euclidean distance transform, f32[H, W] pixels."""
    h, w = blocked.shape
    big = float(h + w)
    g2 = _vertical_sq_dist(blocked, big)

    kk = jnp.arange(w, dtype=jnp.float32)[None, None, :]
    n_blocks = -(-w // block)

    def one_block(j0):
        j = j0.astype(jnp.float32) + jnp.arange(block, dtype=jnp.float32)
        d2 = g2[:, None, :] + (j[None, :, None] - kk) ** 2  # [H, block, W]
        return jnp.min(d2, axis=-1)

    outs = jax.lax.map(one_block, jnp.arange(n_blocks, dtype=jnp.int32) * block)
    e2 = jnp.moveaxis(outs, 0, 1).reshape(h, n_blocks * block)[:, :w]
    return jnp.sqrt(jnp.minimum(e2, big * big))


def _jfa_steps(max_dim: int, max_dist: float | None) -> list:
    """The JFA+1 pass step sizes (shared by the full and windowed runs —
    both must use the IDENTICAL list for the bitwise-equality argument in
    `edt_jfa_refresh` to hold)."""
    if max_dist is None:
        s = 1 << max(0, math.ceil(math.log2(max_dim)) - 1)
    else:
        rng = max(1, min(max_dim, int(math.ceil(max_dist))))
        s = 1 << math.ceil(math.log2(rng))
    steps = []
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)  # the "+1" refinement pass
    return steps


def jfa_reach(max_dist: float) -> int:
    """L-infinity propagation reach of the capped JFA: the sum of all pass
    step sizes. A cell's final (distance, seed) value depends ONLY on the
    initial seed mask within this Chebyshev radius — every JFA chain from a
    cell visits offsets that are partial sums of the per-pass steps, so no
    seed farther than the total sum can ever be adopted. This is the key
    locality bound behind the incremental rebuild (`edt_jfa_refresh`):
    flipping cells in a set C can change the transform only within
    C dilated by `reach`, and a windowed re-run with a `reach`-wide margin
    reproduces the full-map result BITWISE inside the window's interior."""
    # max_dim large enough not to clamp (the refresh path asserts cap <=
    # window <= map dims).
    return sum(_jfa_steps(1 << 30, max_dist))


def edt_jfa(
    blocked: jax.Array,
    max_dist: float | None = None,
    sentinel: float | None = None,
) -> jax.Array:
    """Jump-flooding EDT (JFA+1), f32[H, W] pixels.

    Gather-free: every pass is 8 rolls + elementwise mins, so a full
    transform on a ~600x1300 map is a handful of bandwidth-bound passes —
    cheap enough to rebuild every SLAM map update. The nearest-seed
    coordinate pair is PACKED into one i32 flat index (seed row/col are
    recomputed by a constant div/mod), so each pass rolls one array instead
    of two — the passes are bandwidth-bound, not ALU-bound.

    `max_dist` caps the propagation radius: step sizes start at
    2^ceil(log2(max_dist)) instead of half the map dimension, dropping
    pass count ~2x on big maps. Distances <= max_dist stay exact (same
    JFA+1 approximation); farther cells saturate to the h+w sentinel. The
    likelihood-field measurement only resolves ~5 sigma of distance, so
    its per-step rebuild uses a ~30 px cap (models/mcl.py update).

    `sentinel` overrides the no-seed saturation value (default h + w); the
    windowed refresh passes the FULL map's sentinel so composited windows
    saturate identically to a full-map run.
    """
    h, w = blocked.shape
    if h >= (1 << 15) or w >= (1 << 16):
        # The seed pack below carries (row << 16 | col) in an i32.
        raise ValueError(f"map {h}x{w} exceeds the 32768x65536 JFA limit")
    big = jnp.float32(h + w if sentinel is None else sentinel)
    ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    iif = ii.astype(jnp.float32)
    jjf = jj.astype(jnp.float32)

    inf = jnp.float32(1e9)
    # Seed coords pack as (row << 16) | col, NOT row * w + col: the pass
    # unpacks every rolled candidate (8 per cell per pass) and an i32
    # divide/modulo is many vector ops where shift/mask are single ones —
    # the pass is ALU-bound (tools/jfa_pack_ab.py compares the variants;
    # a two-plane unpacked carry doubles the roll traffic). -1 stays the
    # no-seed sentinel.
    idx = jnp.where(blocked, (ii << 16) | jj, -1)

    def d2_of(idx_):
        si = (idx_ >> 16).astype(jnp.float32)
        sj = (idx_ & 0xFFFF).astype(jnp.float32)
        return jnp.where(idx_ < 0, inf, (iif - si) ** 2 + (jjf - sj) ** 2)

    d2 = d2_of(idx)

    steps = _jfa_steps(max(h, w), max_dist)

    # Each pass reads ONLY the previous pass's field (classic ping-pong
    # JFA): the 8 rolled candidates are independent reads of `idx`, so a
    # seed moves at most `s` (Chebyshev) per pass and the total
    # propagation reach is exactly sum(steps) — the locality bound
    # `jfa_reach` that the incremental refresh's bitwise-exactness proof
    # rests on. (An earlier in-place variant chained updates through the
    # direction loop, which let a seed hop up to 3s per pass — quality
    # was no better and the reach bound tripled, tripling the refresh
    # margin.) Independent reads also hand XLA a 9-way tree min to fuse
    # instead of 8 serially-dependent select chains.
    for s in steps:
        src_idx = idx
        for di in (-s, 0, s):
            for dj in (-s, 0, s):
                if di == 0 and dj == 0:
                    continue
                idx_r = jnp.roll(src_idx, (di, dj), (0, 1))
                # Invalidate wrapped-around entries.
                valid = jnp.ones((h, w), bool)
                if di > 0:
                    valid = valid & (ii >= di)
                elif di < 0:
                    valid = valid & (ii < h + di)
                if dj > 0:
                    valid = valid & (jj >= dj)
                elif dj < 0:
                    valid = valid & (jj < w + dj)
                cand = jnp.where(valid, d2_of(idx_r), inf)
                better = cand < d2
                idx = jnp.where(better, idx_r, idx)
                d2 = jnp.where(better, cand, d2)

    return jnp.sqrt(jnp.minimum(d2, big * big))


def edt_capped_reach(max_dist: float) -> int:
    """L-infinity influence radius of `edt_capped`: ceil(cap) + 1 per
    axis (the vertical clamp C+1 bounds how far a column seed can
    matter; the horizontal pass adds at most C columns). Much tighter
    than the JFA's 2*s0 (28 vs 64 at the default cap 27), so the
    incremental refresh's margins — and its minimum legal window —
    shrink accordingly."""
    return int(math.ceil(max_dist)) + 1


def edt_capped(
    blocked: jax.Array,
    max_dist: float,
    sentinel: float | None = None,
) -> jax.Array:
    """Range-capped EXACT Euclidean distance transform, f32[H, W].

    The fast path for the per-step SLAM rebuild (the likelihood-field
    cap ~30 px). Separable: a vertical clamped column distance
    (cummax/cummin index tricks, no gathers) then a (2C+1)-candidate
    shifted-min horizontal pass with precomputed k^2 constants — ~2 ALU
    ops per candidate where the capped JFA pays ~13 (seed unpack,
    converts, selects) across 7 passes x 8 rolls (tools/jfa_pack_ab.py
    compares them), and EXACT within the cap rather than
    JFA+1-approximate.

    Semantics: distances <= max_dist are exact; farther cells saturate
    to at least C+1 (cells with no seed in the (C+1)-clamped window read
    ~C+1..sqrt(2)*(C+1), NOT the h+w sentinel — every capped consumer
    only tests `> cap`, where both forms are equivalent). Blocked cells
    are exactly 0. `sentinel` caps the maximum as in `edt_jfa`.

    Use `edt_jfa` for UNCAPPED transforms (static-map sdf fields): this
    form's horizontal pass is O(C) per cell and a map-sized C would be
    quadratic.
    """
    h, w = blocked.shape
    big = jnp.float32(h + w if sentinel is None else sentinel)
    C = int(math.ceil(max_dist))
    ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    up = ii - jax.lax.cummax(jnp.where(blocked, ii, -(1 << 30)), axis=0)
    down = (
        jax.lax.cummin(jnp.where(blocked, ii, 1 << 30), axis=0, reverse=True)
        - ii
    )
    g = jnp.minimum(jnp.minimum(up, down), C + 1).astype(jnp.float32)
    g2 = g * g
    pad = jnp.full((h, C), jnp.float32(1e9))
    lpad = jnp.concatenate([pad, g2, pad], axis=1)
    d2 = g2
    for k in range(-C, C + 1):
        if k == 0:
            continue
        d2 = jnp.minimum(d2, lpad[:, C + k : C + k + w] + jnp.float32(k * k))
    return jnp.sqrt(jnp.minimum(d2, big * big))


def _refresh_plan(blocked_old, blocked_new, *, reach: int, box: int):
    """(any_diff, fits, si, sj) for `edt_jfa_refresh`: the flipped-cell
    bbox, the window placement (clipped to the map), and whether the bbox
    dilated by `reach` fits the window's composite interior — the interior
    margin is `reach` except along window edges flush with MAP edges
    (chains clip identically there, so no margin is needed)."""
    h, w = blocked_new.shape
    diff = blocked_old ^ blocked_new
    rows = jnp.any(diff, axis=1)
    cols = jnp.any(diff, axis=0)
    any_diff = jnp.any(rows)
    r0 = jnp.argmax(rows).astype(jnp.int32)
    r1 = (h - 1 - jnp.argmax(rows[::-1])).astype(jnp.int32)
    c0 = jnp.argmax(cols).astype(jnp.int32)
    c1 = (w - 1 - jnp.argmax(cols[::-1])).astype(jnp.int32)

    def window_start(lo, hi, dim):
        center = (lo + hi + 1) // 2
        return jnp.clip(center - box // 2, 0, dim - box)

    si = window_start(r0, r1, h)
    sj = window_start(c0, c1, w)

    def covers(lo, hi, start, dim):
        cov_lo = jnp.where(start == 0, 0, start + reach)
        cov_hi = jnp.where(start == dim - box, dim, start + box - reach)
        need_lo = jnp.maximum(lo - reach, 0)
        need_hi = jnp.minimum(hi + reach + 1, dim)
        return (need_lo >= cov_lo) & (need_hi <= cov_hi)

    fits = covers(r0, r1, si, h) & covers(c0, c1, sj, w)
    return any_diff, fits, si, sj


def edt_refresh(
    edt_prev: jax.Array,
    blocked_old: jax.Array,
    blocked_new: jax.Array,
    *,
    max_dist: float,
    box: int,
) -> jax.Array:
    """Incrementally refresh a capped EDT after a LOCALIZED map edit.

    SLAM rebuilds the likelihood-field EDT every map update, but each scan
    only flips the blocked status of cells near the robot (newly observed
    walls, re-carved cells) while the transform's influence is strictly
    local: by `edt_capped_reach`, a flipped-cell set C can change
    (bitwise) only cells within Chebyshev distance R = ceil(cap)+1 of C
    — the vertical pass's C+1 clamp bounds how far a column seed can
    matter and the horizontal pass adds at most C columns — and a
    windowed re-run whose margin to the window border is >= R reproduces
    the full-map run bitwise in its interior (identical candidate values
    accumulated through the identical shifted-min sequence). The refresh
    therefore:

      1. computes the flipped-cell bbox (one elementwise pass + row/col
         reductions over the map — trivial next to the full-map passes);
      2. if bbox dilated by R fits the interior of a `box`-sized window
         (window edges flush with MAP edges need no margin: the inf pad
         and the vertical clamp coincide on both), re-runs `edt_capped`
         on the window alone and composites the interior back —
         O(box^2 cap) instead of O(H W cap);
      3. otherwise (wide-area edits: entering a large unexplored room)
         falls back to the full rebuild;
      4. with no flips at all, returns `edt_prev` untouched.

    All three outcomes are BITWISE equal to `edt_capped(blocked_new,
    max_dist)` given `edt_prev == edt_capped(blocked_old, max_dist)` —
    the exactness is proved by the reach argument, not sampled; unit
    tests assert it over randomized edits (tests/test_edt.py). (Round-5
    history: the refresh originally ran over the capped JFA, whose
    ping-pong reach is 2*s0 = 64 at the default cap; `edt_capped`'s
    reach of 28 more than halves the margins and its minimum window.)

    The reference pays per-beam marching against the updated map instead
    (`slam/raycast.cpp:143-223`) — locality it exploits ray by ray; this
    is the field-level analog. `box` must satisfy
    4 * reach < box <= min(H, W) (validated) — diffs wider than
    box - 2*reach fall back.
    """
    h, w = blocked_new.shape
    if blocked_old.shape != (h, w) or edt_prev.shape != (h, w):
        raise ValueError("edt/mask shape mismatch")
    reach = edt_capped_reach(max_dist)
    if box > min(h, w):
        raise ValueError(
            f"edt refresh box {box} exceeds map dims {(h, w)} — use a "
            "smaller box or the full rebuild"
        )
    if box <= 4 * reach:
        raise ValueError(
            f"edt refresh box {box} must exceed 4*reach = {4 * reach} "
            f"(reach = ceil(max_dist)+1 for max_dist={max_dist}); "
            "smaller boxes would always fall back to the full rebuild"
        )

    any_diff, fits, si, sj = _refresh_plan(
        blocked_old, blocked_new, reach=reach, box=box
    )

    def local_fn(_):
        win_mask = jax.lax.dynamic_slice(blocked_new, (si, sj), (box, box))
        win_edt = edt_capped(win_mask, max_dist, sentinel=h + w)
        li = jax.lax.broadcasted_iota(jnp.int32, (box, box), 0)
        lj = jax.lax.broadcasted_iota(jnp.int32, (box, box), 1)
        in_i = ((li >= reach) | (si == 0)) & (
            (li < box - reach) | (si == h - box)
        )
        in_j = ((lj >= reach) | (sj == 0)) & (
            (lj < box - reach) | (sj == w - box)
        )
        prev_win = jax.lax.dynamic_slice(edt_prev, (si, sj), (box, box))
        merged = jnp.where(in_i & in_j, win_edt, prev_win)
        return jax.lax.dynamic_update_slice(edt_prev, merged, (si, sj))

    def full_fn(_):
        return edt_capped(blocked_new, max_dist)

    return jax.lax.cond(
        any_diff,
        lambda _: jax.lax.cond(fits, local_fn, full_fn, None),
        lambda _: edt_prev,
        None,
    )


# Back-compat alias (the refresh originally ran over the capped JFA).
edt_jfa_refresh = edt_refresh
