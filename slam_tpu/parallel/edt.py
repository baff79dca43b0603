"""Distributed (row-block-sharded) capped JFA EDT + likelihood-field pieces.

Completes SURVEY section 7 item 8 for DYNAMIC maps: the map-block-sharded
SLAM engine previously spoke only the march beam model (each block marches
every ray; `parallel/mapshard.py`), because the likelihood-field tiers — the
11-24x faster measurement at scale — need a distance transform of the WHOLE
map, which was only built replicated (`models/slam.py`). Here the capped JFA
(`slam_tpu.ops.edt.edt_jfa`) runs directly on the row-block-sharded mask:
each pass exchanges `s`-row halos with the two neighbor blocks (ppermute
over the map axis) and applies the same shifted-min pass block-locally, so
no device ever materializes a full-map array. The result is BITWISE equal
to the replicated transform (tests/test_mapshard.py):

  * the ping-pong pass reads only the previous pass's field, so a pass at
    step `s` needs exactly `s` rows of halo — the exchanged slab;
  * halo cells beyond the map edge carry the no-seed sentinel, exactly the
    replicated pass's out-of-bounds roll invalidation;
  * the (distance, seed) invariant d2 == d2_of(idx) lets blocks exchange
    only the packed seed indices and recompute distances locally, halving
    halo traffic.

Traffic per step: 2 * sum(steps) rows of i32 per block pair — for the
maze-scale cap (32) that is ~64 rows x W x 4 B ~= 0.6 MB per neighbor link,
next to a multi-MB map block.

Reference anchor: the reference rebuilds nothing — it re-marches every beam
against each particle's own map (`slam/raycast.cpp:143-223`); the sharded
JFA is the field-level equivalent for the shared-map design.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from slam_tpu.ops.edt import _jfa_steps


def edt_jfa_sharded(
    mesh: Mesh,
    blocked: jax.Array,
    *,
    max_dist: float,
    map_axis: str = "b",
    sentinel: float | None = None,
) -> jax.Array:
    """Capped JFA over a row-block-sharded bool[H, W] mask.

    Input sharded P(map_axis, None); output f32[H, W] with the same
    sharding. Bitwise-equal to `edt_jfa(blocked, max_dist, sentinel)`.
    """
    h, w = blocked.shape
    if h >= (1 << 15) or w >= (1 << 16):
        raise ValueError(f"map {h}x{w} exceeds the 32768x65536 JFA limit")
    d = mesh.shape[map_axis]
    if h % d != 0:
        raise ValueError(f"map rows {h} not divisible by '{map_axis}'={d}")
    lh = h // d
    steps = _jfa_steps(max(h, w), max_dist)
    if steps[0] > lh:
        raise ValueError(
            f"JFA step {steps[0]} exceeds block height {lh} ({h} rows / "
            f"{d} blocks): halos would span beyond the immediate neighbor. "
            "Use fewer blocks or a smaller max_dist cap."
        )
    big = jnp.float32(h + w if sentinel is None else sentinel)
    inf = jnp.float32(1e9)
    up = [(i, i + 1) for i in range(d - 1)]  # src -> dst: my rows to below
    down = [(i + 1, i) for i in range(d - 1)]

    def local(blk):
        bi = jax.lax.axis_index(map_axis)
        off = bi * lh
        jj = jax.lax.broadcasted_iota(jnp.int32, (lh, w), 1)
        ii = off + jax.lax.broadcasted_iota(jnp.int32, (lh, w), 0)
        # Same (global_row << 16) | col seed pack as the replicated
        # transform (shift/mask unpack; see ops/edt.py) — global rows so
        # halo-exchanged seeds stay valid across blocks.
        idx = jnp.where(blk, (ii << 16) | jj, -1)

        def d2_of(idx_, rows):
            si_ = (idx_ >> 16).astype(jnp.float32)
            sj_ = (idx_ & 0xFFFF).astype(jnp.float32)
            jjf = jax.lax.broadcasted_iota(
                jnp.float32, idx_.shape, 1
            )
            return jnp.where(
                idx_ < 0,
                inf,
                (rows.astype(jnp.float32)[:, None] - si_) ** 2
                + (jjf - sj_) ** 2,
            )

        for s in steps:
            # Halo exchange: my LAST s rows go to the block below (their
            # top halo); my FIRST s rows to the block above (their bottom
            # halo). Edge blocks receive zeros from ppermute — masked to
            # the no-seed sentinel, which reproduces the replicated pass's
            # out-of-map roll invalidation.
            ht = jax.lax.ppermute(idx[-s:], map_axis, up)
            hb = jax.lax.ppermute(idx[:s], map_axis, down)
            ht = jnp.where(bi == 0, -1, ht)
            hb = jnp.where(bi == d - 1, -1, hb)
            ext = jnp.concatenate([ht, idx, hb], axis=0)  # [lh + 2s, w]
            eh = lh + 2 * s
            rows = (off - s) + jnp.arange(eh, dtype=jnp.int32)
            ii_e = jax.lax.broadcasted_iota(jnp.int32, (eh, w), 0)
            jj_e = jax.lax.broadcasted_iota(jnp.int32, (eh, w), 1)
            d2 = d2_of(ext, rows)
            src = ext
            new_idx, new_d2 = ext, d2
            for di in (-s, 0, s):
                for dj in (-s, 0, s):
                    if di == 0 and dj == 0:
                        continue
                    idx_r = jnp.roll(src, (di, dj), (0, 1))
                    valid = jnp.ones((eh, w), bool)
                    if di > 0:
                        valid = valid & (ii_e >= di)
                    elif di < 0:
                        valid = valid & (ii_e < eh + di)
                    if dj > 0:
                        valid = valid & (jj_e >= dj)
                    elif dj < 0:
                        valid = valid & (jj_e < w + dj)
                    cand = jnp.where(valid, d2_of(idx_r, rows), inf)
                    better = cand < new_d2
                    new_idx = jnp.where(better, idx_r, new_idx)
                    new_d2 = jnp.where(better, cand, new_d2)
            idx = new_idx[s : s + lh]

        d2 = d2_of(idx, off + jnp.arange(lh, dtype=jnp.int32))
        return jnp.sqrt(jnp.minimum(d2, big * big))

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(map_axis, None),),
        out_specs=P(map_axis, None),
        check_vma=False,
    )(blocked)


def edt_capped_sharded(
    mesh: Mesh,
    blocked: jax.Array,
    *,
    max_dist: float,
    map_axis: str = "b",
    sentinel: float | None = None,
) -> jax.Array:
    """Range-capped separable EXACT EDT over a row-block-sharded mask —
    the sharded form of `ops.edt.edt_capped` (the capped-path fast
    transform; see its docstring for how it compares with the JFA).

    Far simpler to distribute than the JFA: the vertical clamped column
    distance only looks C+1 rows up/down, so ONE exchange of (C+1)-row
    blocked-mask halos (ppermute both ways) makes the whole transform
    block-local — the horizontal pass never crosses blocks at all.
    Bitwise-equal to the replicated `edt_capped` (the C+1 clamp makes
    beyond-halo seeds irrelevant on both sides; edge blocks mask their
    missing halo to no-seed exactly like the map edge).
    """
    import math as _math

    h, w = blocked.shape
    d = mesh.shape[map_axis]
    if h % d != 0:
        raise ValueError(f"map rows {h} not divisible by '{map_axis}'={d}")
    lh = h // d
    C = int(_math.ceil(max_dist))
    halo = C + 1
    if halo > lh:
        raise ValueError(
            f"edt_capped_sharded: halo {halo} exceeds block height {lh} "
            f"({h} rows / {d} blocks) — use fewer blocks or a smaller cap"
        )
    big = jnp.float32(h + w if sentinel is None else sentinel)
    up_perm = [(i, i + 1) for i in range(d - 1)]
    down_perm = [(i + 1, i) for i in range(d - 1)]

    def local(blk):
        bi = jax.lax.axis_index(map_axis)
        ht = jax.lax.ppermute(blk[-halo:], map_axis, up_perm)
        hb = jax.lax.ppermute(blk[:halo], map_axis, down_perm)
        ht = jnp.where(bi == 0, False, ht)
        hb = jnp.where(bi == d - 1, False, hb)
        ext = jnp.concatenate([ht, blk, hb], axis=0)  # [lh + 2*halo, w]
        eh = lh + 2 * halo
        ii = jax.lax.broadcasted_iota(jnp.int32, (eh, w), 0)
        up = ii - jax.lax.cummax(jnp.where(ext, ii, -(1 << 30)), axis=0)
        down = (
            jax.lax.cummin(jnp.where(ext, ii, 1 << 30), axis=0, reverse=True)
            - ii
        )
        g = jnp.minimum(jnp.minimum(up, down), C + 1).astype(jnp.float32)
        g2 = (g * g)[halo : halo + lh]
        pad = jnp.full((lh, C), jnp.float32(1e9))
        lpad = jnp.concatenate([pad, g2, pad], axis=1)
        d2 = g2
        for k in range(-C, C + 1):
            if k == 0:
                continue
            d2 = jnp.minimum(
                d2, lpad[:, C + k : C + k + w] + jnp.float32(k * k)
            )
        return jnp.sqrt(jnp.minimum(d2, big * big))

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(map_axis, None),),
        out_specs=P(map_axis, None),
        check_vma=False,
    )(blocked)


def lf_window_sharded(
    mesh: Mesh,
    edt: jax.Array,
    i0,
    j0,
    *,
    out_shape,
    stddev: float,
    z_hit: float,
    z_rand: float,
    max_dist: float,
    map_axis: str = "b",
) -> jax.Array:
    """Replicated (la_i, la_j) window of the padded per-cell score field,
    assembled from a row-block-sharded EDT: each block contributes the
    window rows it owns (one psum over the map axis); rows/cols outside
    the map read the z_rand floor, exactly the replicated box build
    (`ops.measurement.lf_score_table`'s origin branch). `i0`/`j0` are the
    window's global start (may be negative: box origin minus pad)."""
    from slam_tpu.ops.measurement import lf_log_score_field

    h, w = edt.shape
    d = mesh.shape[map_axis]
    lh = h // d
    la_i, la_j = out_shape
    floor_val = jnp.float32(math.log(max(z_rand / max_dist, 1e-30)))

    def local(blk, i0_, j0_):
        bi = jax.lax.axis_index(map_axis)
        off = bi * lh
        lfield = lf_log_score_field(
            blk, stddev=stddev, z_hit=z_hit, z_rand=z_rand,
            max_dist=max_dist,
        )
        rows = i0_ + jnp.arange(la_i, dtype=jnp.int32)
        cols = j0_ + jnp.arange(la_j, dtype=jnp.int32)
        rl = rows - off
        in_blk = (rl >= 0) & (rl < lh)
        core = lfield[jnp.clip(rl, 0, lh - 1)][:, jnp.clip(cols, 0, w - 1)]
        win = jax.lax.psum(
            jnp.where(in_blk[:, None], core, 0.0), map_axis
        )
        in_map = ((rows >= 0) & (rows < h))[:, None] & (
            (cols >= 0) & (cols < w)
        )[None, :]
        return jnp.where(in_map, win, floor_val)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(map_axis, None), P(), P()),
        out_specs=P(),
        check_vma=False,
    )(edt, jnp.asarray(i0, jnp.int32), jnp.asarray(j0, jnp.int32))


def lf_log_weights_sharded(
    mesh: Mesh,
    edt: jax.Array,
    poses,
    scan,
    *,
    rc,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    map_axis: str = "b",
    particle_axis: str = "p",
):
    """Direct likelihood-field weights against a row-block-sharded EDT.

    Each block gathers the endpoint cells it owns and a psum over the map
    axis assembles the per-beam distances (every clamped endpoint cell
    lives in exactly one block, so the sum IS the gather); the pdf mixture
    and the beam reduction then match
    `ops.measurement.particle_log_weights_likelihood_field` bitwise.
    Particles stay sharded over `particle_axis`.
    """
    from slam_tpu.core import grid as gridlib
    from slam_tpu.core.stats import pdf_normal
    from slam_tpu.ops.measurement import sensor_pose

    h, w = edt.shape
    d = mesh.shape[map_axis]
    lh = h // d

    def local(blk, px, py, pth, dists, angles_rel):
        bi = jax.lax.axis_index(map_axis)
        off = bi * lh
        sp = sensor_pose(
            type(poses)(x=px, y=py, theta=pth), scanner_offset
        )
        angles = sp.theta[:, None] + angles_rel[None, :]
        z = dists[None, :]
        ex = sp.x[:, None] + z * jnp.cos(angles)
        ey = sp.y[:, None] + z * jnp.sin(angles)
        i, j = gridlib.world_to_cell((h, w), ex, ey)
        inb = gridlib.in_bounds((h, w), i, j)
        ic, jc = gridlib.clamp_cell((h, w), i, j)
        il = ic - off
        mine = (il >= 0) & (il < lh)
        dloc = blk.reshape(-1)[jnp.clip(il, 0, lh - 1) * w + jc]
        dval = jax.lax.psum(jnp.where(mine, dloc, 0.0), map_axis)
        p_hit = jnp.where(inb, pdf_normal(stddev, dval), 0.0)
        p = z_hit * p_hit + z_rand / rc.max_dist
        lw = jnp.log(jnp.maximum(p, 1e-30))
        lw = jnp.where(z >= rc.max_dist, 0.0, lw)
        return jnp.sum(lw, axis=-1)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(map_axis, None),
            P(particle_axis),
            P(particle_axis),
            P(particle_axis),
            P(),
            P(),
        ),
        out_specs=P(particle_axis),
        check_vma=False,
    )(edt, poses.x, poses.y, poses.theta, scan.dists, scan.angles)
