"""Occupancy mapping: additive log-odds scatter updates along scan beams.

The reference fuses mapping into weighting, marching each beam through the
particle's own uint8 map and applying multiplicative clamped updates cell by
cell (`slam/raycast.cpp:143-223`: p *= Lfree/L0 = 1.2 for cells before the
measured endpoint, p *= Locc/L0 = 0.8 at the endpoint, floor 1/255). The
shared-map design replaces this with the textbook additive log-odds update
(`slam/util.h:72-73` semantics; SURVEY.md section 5 quirk 4's deliberate fix)
applied as ONE scatter-add per scan:

  * cells strictly before the measured range: += l_free (negative);
  * the first new cell at/after the measured range: += l_occ, skipped for
    max-range misses (`slam/raycast.cpp:205` z == z_max guard);
  * per-beam cell dedup reproduces the reference's changed-cell stepping
    (`slam/raycast.cpp:166-170`), so each visited cell updates once per beam;
  * the march stops at the first out-of-bounds step, like the `break` at
    `slam/raycast.cpp:176`.

The fidelity mode (exact uint8 multiplicative quantization, per-particle
maps) lives in `fidelity_measurement_and_mapping` below for A/B testing at
small particle counts.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from slam_tpu.core import grid as gridlib
from slam_tpu.core.types import Pose, Scan
from slam_tpu.ops.measurement import beam_log_weights, sensor_pose


def _beam_cells(shape, sp: Pose, angles, *, step, max_dist):
    """Shared geometry for one pose's scan: cells visited by every beam.

    Returns (i, j, d, processed, cell_ids) with shape [B, K]:
      processed = new-cell AND all-steps-in-bounds-so-far (march semantics).
    """
    h, w = shape
    k_total = int(math.ceil(max_dist / step))
    ks = jnp.arange(1, k_total + 1, dtype=jnp.float32)  # [K]
    d = ks * step

    px = sp.x + ks[None, :] * (jnp.cos(angles) * step)[:, None]
    py = sp.y + ks[None, :] * (jnp.sin(angles) * step)[:, None]
    i, j = gridlib.world_to_cell((h, w), px, py)
    cell = i * w + j

    i0, j0 = gridlib.world_to_cell((h, w), sp.x, sp.y)
    cell0 = (i0 * w + j0).reshape(-1, 1) if jnp.ndim(i0) else i0 * w + j0
    prev = jnp.concatenate(
        [jnp.broadcast_to(cell0, cell[:, :1].shape), cell[:, :-1]], axis=1
    )
    new_cell = cell != prev

    inb = gridlib.in_bounds((h, w), i, j)
    all_inb = jnp.cumprod(inb.astype(jnp.int32), axis=1).astype(bool)
    processed = new_cell & all_inb
    return i, j, d, processed, cell


def scan_logodds_update(
    grid_l: jax.Array,
    pose: Pose,
    scan: Scan,
    *,
    scanner_offset=(0.0, 0.0, 0.0),
    step: float = 0.5,
    max_dist: float = 500.0,
    l_occ: float = 0.85,
    l_free: float = -0.4,
    l_min: float = -6.0,
    l_max: float = 6.0,
    row_offset=None,
    full_h: int | None = None,
) -> jax.Array:
    """Update the shared log-odds grid from one scan taken at `pose`.

    One scatter-add over all beams' visited cells; in shared-map SLAM this
    runs once per scan from the estimated pose, not once per particle.
    `grid_l` may be a row-block of a larger map (row_offset/full_h): beam
    geometry runs in global coordinates and updates outside the block are
    dropped, so block updates compose exactly to the full-map update.
    """
    lh, w = grid_l.shape
    h = lh if full_h is None else full_h
    ro = jnp.int32(0 if row_offset is None else row_offset)
    sp = sensor_pose(pose, scanner_offset)
    angles = sp.theta + scan.angles  # [B]
    i, j, d, processed, _ = _beam_cells(
        (h, w), Pose(x=sp.x, y=sp.y, theta=sp.theta), angles, step=step, max_dist=max_dist
    )

    z = scan.dists[:, None]  # [B, 1]
    free = processed & (d[None, :] < z)

    # First processed cell at/after the measured endpoint; skipped for
    # max-range misses (z encoded as exactly max_dist by the scan builder).
    at_or_past = processed & (d[None, :] >= z)
    first_idx = jnp.argmax(at_or_past, axis=1)  # [B]
    has_occ = jnp.any(at_or_past, axis=1) & (scan.dists < max_dist)
    k_iota = jnp.arange(d.shape[0])[None, :]
    occ = (k_iota == first_idx[:, None]) & has_occ[:, None] & at_or_past

    delta = free * l_free + occ * l_occ
    il = i - ro  # block-local row; out-of-block updates dropped
    inblk = (il >= 0) & (il < lh) & (j >= 0) & (j < w)
    flat_idx = jnp.where(
        inblk, jnp.clip(il, 0, lh - 1) * w + jnp.clip(j, 0, w - 1), lh * w
    ).reshape(-1)
    new_grid = (
        grid_l.reshape(-1)
        .at[flat_idx]
        .add(delta.reshape(-1), mode="drop")
        .reshape(lh, w)
    )
    return jnp.clip(new_grid, l_min, l_max)


# --------------------------------------------------------------------------
# Fidelity mode: per-particle uint8 maps with the reference's multiplicative
# quantized updates, for small-N A/B validation against the C++.
# --------------------------------------------------------------------------

_L0 = 0.5
_LOCC = 0.40
_LFREE = 0.60


def _u8_update(values_u8, factor):
    """One multiplicative quantized update: p = clamp(p * factor) with
    ceiling 1.0 and floor 1/255 (`slam/raycast.cpp:193-213`)."""
    p = values_u8.astype(jnp.float32) / 255.0 * factor
    p = jnp.minimum(p, 1.0)
    return jnp.maximum(jnp.floor(p * 255.0), 1.0).astype(jnp.uint8)


def fidelity_measurement_and_mapping(
    maps_u8: jax.Array,
    poses: Pose,
    scan: Scan,
    *,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    eps: float = 0.1,
    max_dist: float = 500.0,
    step: float = 0.5,
):
    """Reference-style fused weighting + mapping on per-particle maps.

    For each particle n and beam b, marches through `maps_u8[n]`: the first
    already-occupied (<128) new cell is the predicted hit
    (`slam/raycast.cpp:183-189`), cells before the measured endpoint get the
    free update and the endpoint cell the occupied update. Deviations from
    the C++ (documented, validated by ATE tests): hits are computed against
    the pre-scan map and all updates applied afterwards, so beams are
    order-independent (the reference mutates beam-by-beam, SURVEY.md
    section 5 quirk 4).

    Returns:
      (log_weights f32[N], new_maps u8[N, H, W])
    """
    n, h, w = maps_u8.shape
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]

    k_total = int(math.ceil(max_dist / step))
    ks = jnp.arange(1, k_total + 1, dtype=jnp.float32)
    d = ks * step  # [K]

    px = sp.x[:, None, None] + ks[None, None, :] * (jnp.cos(angles) * step)[..., None]
    py = sp.y[:, None, None] + ks[None, None, :] * (jnp.sin(angles) * step)[..., None]
    i, j = gridlib.world_to_cell((h, w), px, py)  # [N, B, K]
    cell = i * w + j

    i0, j0 = gridlib.world_to_cell((h, w), sp.x, sp.y)
    cell0 = (i0 * w + j0)[:, None, None]
    prev = jnp.concatenate(
        [jnp.broadcast_to(cell0, cell[..., :1].shape), cell[..., :-1]], axis=-1
    )
    new_cell = cell != prev
    inb = gridlib.in_bounds((h, w), i, j)
    all_inb = jnp.cumprod(inb.astype(jnp.int32), axis=-1).astype(bool)
    processed = new_cell & all_inb

    ic, jc = gridlib.clamp_cell((h, w), i, j)
    flat = (ic * w + jc) + (jnp.arange(n) * h * w)[:, None, None]
    vals = maps_u8.reshape(-1)[flat.reshape(-1)].reshape(cell.shape)

    # Predicted hit: first processed cell with value < 128 (pre-scan map).
    occupied = processed & (vals < 128) & (cell != cell0)
    hit_any = jnp.any(occupied, axis=-1)
    hit_idx = jnp.argmax(occupied, axis=-1)
    hit_dist = (hit_idx.astype(jnp.float32) + 1.0) * step

    z = scan.dists[None, :, None]  # [1, B, 1]
    free = processed & (d[None, None, :] * d[None, None, :] < z * z)
    at_or_past = processed & (d[None, None, :] >= z[..., 0][..., None])
    first_idx = jnp.argmax(at_or_past, axis=-1)
    has_occ = jnp.any(at_or_past, axis=-1) & (scan.dists[None, :] < max_dist)
    k_iota = jnp.arange(k_total)[None, None, :]
    occ_mask = (k_iota == first_idx[..., None]) & has_occ[..., None] & at_or_past

    # Multiplicative quantized updates, scattered back per particle.
    new_free_vals = _u8_update(vals, _LFREE / _L0)
    new_occ_vals = _u8_update(vals, _LOCC / _L0)
    updated = jnp.where(occ_mask, new_occ_vals, jnp.where(free, new_free_vals, vals))
    do_write = (free | occ_mask).reshape(-1)
    write_idx = jnp.where(do_write, flat.reshape(-1), maps_u8.size)  # OOB drop
    new_maps = (
        maps_u8.reshape(-1)
        .at[write_idx]
        .set(updated.reshape(-1), mode="drop")
        .reshape(n, h, w)
    )

    lw = beam_log_weights(
        hit_dist,
        hit_any,
        scan.dists[None, :],
        stddev=stddev,
        max_dist=max_dist,
        eps=eps,
    )
    return jnp.sum(lw, axis=-1), new_maps
