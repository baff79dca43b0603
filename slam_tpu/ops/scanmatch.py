"""Correlative scan matching: local pose refinement on the likelihood field.

A beyond-parity component — the reference's pose estimate is simply the
highest-weight particle (`slam/mcl.cpp:236-238`, rendered by
`apps/grid_slam.cpp:112`). Here that particle seeds a local correlative
search (the single-level form of Olson, "Real-time correlative scan
matching", ICRA 2009): a [theta_bins, D, D] grid of integer-cell
translations x heading candidates around the sensor pose is scored by
summing each beam endpoint's likelihood-field log score (the same per-cell
field the correlative table measurement builds on,
`measurement.lf_log_score_field`), then a quadratic fit to the peak
recovers sub-cell / sub-bin resolution.

Three properties make this vectorized and sub-cell accurate:

  * Endpoints are scored by BILINEAR interpolation of the log-score field
    at their continuous positions (nearest-cell snapping would quantize
    the score surface: a theta step that moves endpoints < 1 px — any
    sub-0.03 rad step at lidar ranges — would be invisible, and the
    quadratic peak fit would have no gradient to use).
  * Integer-cell translations keep the interpolation weights SHARED
    across the whole candidate grid: frac(x + dx) == frac(x) for integer
    dx, so the 4 corner weights are computed once per (heading, beam) and
    only the corner cell indices shift — the search is 4 fused gathers of
    T * D^2 * B elements (~5*10^5 at the defaults) plus reductions.
  * The cost is independent of the particle count, so the refinement is
    latency-free next to the filter update it refines.

Out-of-map corners score the z_rand floor and max-range beams are
excluded, exactly as in the table measurement. A tiny center-preferring
bias breaks ties on flat score surfaces (e.g. every beam at max range), so
degenerate inputs refine to the seed pose instead of a window corner.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from slam_tpu.core import grid as gridlib
from slam_tpu.core.config import RaycastConfig, ScanMatchConfig
from slam_tpu.core.types import Pose, Scan
from slam_tpu.ops import measurement


def _coarse_shift(
    lfield2d, pose: Pose, scan: Scan, *, rc, cfg, scanner_offset, floor_val
):
    """Coarse level of the multi-resolution search (Olson ICRA-2009 section
    IV.B): translations at stride `coarse_stride` over a wide window, scored
    against a stride-MAX-POOLED score field. Pooling makes each strided
    candidate an upper bound over its whole (stride x stride) block of
    translations, so the coarse argmax cannot skip the block containing the
    true peak; the fine level then resolves within the winning block.

    Returns the coarsely-shifted ROBOT pose (same sensor->robot inverse
    composition as the fine level)."""
    import jax

    h, w = lfield2d.shape
    s = int(cfg.coarse_stride)
    cw = int(cfg.coarse_window)
    tc = int(cfg.coarse_theta_bins)
    chalf = float(cfg.coarse_theta_halfwidth)
    # pooled[i, j] = max lfield[i-s+1 .. i, j .. j+s-1]: the (dy, dx) block
    # [dyc, dyc+s) x [dxc, dxc+s) maps cell (ib, jb) onto exactly that
    # rectangle at (ib - dyc, jb + dxc) (+dx -> +j, +dy -> -i).
    pooled = jax.lax.reduce_window(
        lfield2d,
        -jnp.inf,
        jax.lax.max,
        (s, s),
        (1, 1),
        ((s - 1, 0), (0, s - 1)),
    ).reshape(-1)

    tstep = 2.0 * chalf / max(tc - 1, 1)
    sp = measurement.sensor_pose(pose, scanner_offset)
    ts = sp.theta + (jnp.arange(tc, dtype=jnp.float32) - (tc - 1) / 2.0) * tstep
    ang = ts[:, None] + scan.angles[None, :]  # [Tc, B]
    ex = sp.x + scan.dists[None, :] * jnp.cos(ang)
    ey = sp.y + scan.dists[None, :] * jnp.sin(ang)
    ib, jb = gridlib.world_to_cell((h, w), ex, ey)  # [Tc, B]
    valid = (scan.dists < rc.max_dist)[None, None, None, :]

    off = jnp.arange(-cw, cw + 1, s, dtype=jnp.int32)
    d = off.shape[0]
    i_c = ib[:, None, None, :] - off[None, :, None, None]  # [Tc, dy, dx, B]
    j_c = jb[:, None, None, :] + off[None, None, :, None]
    inb = (i_c >= 0) & (i_c < h) & (j_c >= 0) & (j_c < w)
    vals = jnp.where(
        inb,
        pooled[jnp.clip(i_c, 0, h - 1) * w + jnp.clip(j_c, 0, w - 1)],
        floor_val,
    )
    score = jnp.sum(jnp.where(valid, vals, 0.0), axis=-1)  # [Tc, Dy, Dx]

    ctr_t = (jnp.arange(tc, dtype=jnp.float32) - (tc - 1) / 2.0) ** 2
    ctr_w = (off.astype(jnp.float32) / s) ** 2
    biased = score - 1e-6 * (
        ctr_t[:, None, None] + ctr_w[None, :, None] + ctr_w[None, None, :]
    )
    t0, y0, x0 = jnp.unravel_index(jnp.argmax(biased), score.shape)

    dtheta = (t0.astype(jnp.float32) - (tc - 1) / 2.0) * tstep
    # Block CENTER: the winning block covers offsets [o, o+s); hand the fine
    # level its middle so the residual |true - center| <= s/2 < fine window.
    dy_w = (y0 * s - cw).astype(jnp.float32) + (s - 1) / 2.0
    dx_w = (x0 * s - cw).astype(jnp.float32) + (s - 1) / 2.0

    dist, th, rot = measurement.scanner_displacement(scanner_offset)
    theta_s = sp.theta + dtheta
    theta_r = theta_s - rot
    x_r = sp.x + dx_w - jnp.cos(theta_r + th) * dist
    y_r = sp.y + dy_w - jnp.sin(theta_r + th) * dist
    return Pose(x=x_r, y=y_r, theta=theta_r)


def _peak_delta(s_minus, s_0, s_plus):
    """Sub-sample offset of a quadratic through three samples, in [-.5, .5].
    Zero when the triple is not concave (flat/degenerate surfaces)."""
    den = s_minus - 2.0 * s_0 + s_plus
    delta = jnp.where(den < -1e-12, 0.5 * (s_minus - s_plus) / den, 0.0)
    return jnp.clip(delta, -0.5, 0.5)


def refine_pose(
    field,
    pose: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig,
    cfg: ScanMatchConfig = ScanMatchConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
):
    """Refine a (scalar) pose estimate against one scan.

    Args:
      field: a `RayField` with `edt` set (the capped JFA transform the
        likelihood-field measurement uses is fine — the search only reads
        the field within ~stddev of obstacles).
      pose: seed robot pose (scalars; typically `MCLState.best_pose`).
      scan: the current scan.

    Returns:
      (refined robot `Pose`, peak log score at the integer grid argmax).
    """
    edt = field.edt
    if edt is None:
        raise ValueError("scan matching needs field.edt")
    h, w = edt.shape
    # Score |edt - edt_offset|: endpoints belong on wall faces, not wall
    # cell centers (see ScanMatchConfig.edt_offset).
    lfield2d = measurement.lf_log_score_field(
        jnp.abs(edt - cfg.edt_offset),
        stddev=stddev,
        z_hit=z_hit,
        z_rand=z_rand,
        max_dist=rc.max_dist,
    )
    lfield = lfield2d.reshape(-1)
    floor_val = float(math.log(max(z_rand / rc.max_dist, 1e-30)))

    if cfg.coarse_window > 0:
        pose = _coarse_shift(
            lfield2d,
            pose,
            scan,
            rc=rc,
            cfg=cfg,
            scanner_offset=scanner_offset,
            floor_val=floor_val,
        )

    t = int(cfg.theta_bins)
    half = float(cfg.theta_halfwidth)
    win = int(cfg.window)
    d = 2 * win + 1
    tstep = 2.0 * half / max(t - 1, 1)

    sp = measurement.sensor_pose(pose, scanner_offset)
    ts = sp.theta + (jnp.arange(t, dtype=jnp.float32) - (t - 1) / 2.0) * tstep
    ang = ts[:, None] + scan.angles[None, :]  # [T, B]
    ex = sp.x + scan.dists[None, :] * jnp.cos(ang)
    ey = sp.y + scan.dists[None, :] * jnp.sin(ang)
    # Continuous CELL-CENTER coordinates of each endpoint. From
    # `world_to_cell` (i = floor(h - y - 1), j = floor(x)): cell i covers
    # y in (h-i-2, h-i-1] (center y = h-i-1.5) and cell j covers x in
    # [j, j+1) (center x = j+0.5), so ci/cj evaluate to exactly (i, j) at
    # cell centers — the bilinear sample then reproduces L[i, j] there.
    # (Off-by-half/one versions of these were measured as a systematic
    # ~1.2-1.9 px +y refinement bias against the TRUE map; the seed=truth
    # bias probe in tests/test_scanmatch.py pins this down.)
    ci = h - ey - 1.5
    cj = ex - 0.5
    i0 = jnp.floor(ci).astype(jnp.int32)  # [T, B]
    j0 = jnp.floor(cj).astype(jnp.int32)
    fi = ci - i0  # fractional weights, SHARED by every integer shift
    fj = cj - j0
    valid = (scan.dists < rc.max_dist)[None, None, None, :]

    off = jnp.arange(-win, win + 1, dtype=jnp.int32)

    def corner(di, dj):
        # World shifts map to cells as (+dx -> +j, +dy -> -i); axes are
        # [T, dy, dx, B].
        i_c = (i0 + di)[:, None, None, :] - off[None, :, None, None]
        j_c = (j0 + dj)[:, None, None, :] + off[None, None, :, None]
        inb = (i_c >= 0) & (i_c < h) & (j_c >= 0) & (j_c < w)
        return jnp.where(
            inb,
            lfield[jnp.clip(i_c, 0, h - 1) * w + jnp.clip(j_c, 0, w - 1)],
            floor_val,
        )

    wi = fi[:, None, None, :]
    wj = fj[:, None, None, :]
    vals = (
        (1.0 - wi) * (1.0 - wj) * corner(0, 0)
        + (1.0 - wi) * wj * corner(0, 1)
        + wi * (1.0 - wj) * corner(1, 0)
        + wi * wj * corner(1, 1)
    )
    score = jnp.sum(jnp.where(valid, vals, 0.0), axis=-1)  # [T, Dy, Dx]

    # Center-preferring tiebreak (far below any real score difference).
    ctr_t = (jnp.arange(t, dtype=jnp.float32) - (t - 1) / 2.0) ** 2
    ctr_w = off.astype(jnp.float32) ** 2
    biased = score - 1e-6 * (
        ctr_t[:, None, None] + ctr_w[None, :, None] + ctr_w[None, None, :]
    )
    flat = jnp.argmax(biased)
    t0, y0, x0 = jnp.unravel_index(flat, score.shape)
    peak = score[t0, y0, x0]

    if cfg.subcell:
        # Quadratic peak fit per axis; disabled at window borders (the
        # shifted triple would not bracket the max).
        tc = jnp.clip(t0, 1, max(t - 2, 1))
        yc = jnp.clip(y0, 1, d - 2)
        xc = jnp.clip(x0, 1, d - 2)
        dt = jnp.where(
            (t0 == tc) & (t > 2),
            _peak_delta(
                score[tc - 1, y0, x0], score[tc, y0, x0], score[tc + 1, y0, x0]
            ),
            0.0,
        )
        dy = jnp.where(
            y0 == yc,
            _peak_delta(
                score[t0, yc - 1, x0], score[t0, yc, x0], score[t0, yc + 1, x0]
            ),
            0.0,
        )
        dx = jnp.where(
            x0 == xc,
            _peak_delta(
                score[t0, y0, xc - 1], score[t0, y0, xc], score[t0, y0, xc + 1]
            ),
            0.0,
        )
    else:
        dt = dy = dx = jnp.float32(0.0)

    dtheta = (t0.astype(jnp.float32) - (t - 1) / 2.0 + dt) * tstep
    dx_w = x0.astype(jnp.float32) - win + dx
    # Score axis 1 indexes +dy (i_c = ib - dy), so the fit offset is +dy.
    dy_w = y0.astype(jnp.float32) - win + dy

    # Back from the refined SENSOR pose to the robot pose
    # (inverse of `measurement.sensor_pose`).
    dist, th, rot = measurement.scanner_displacement(scanner_offset)
    theta_s = sp.theta + dtheta
    theta_r = theta_s - rot
    x_r = sp.x + dx_w - jnp.cos(theta_r + th) * dist
    y_r = sp.y + dy_w - jnp.sin(theta_r + th) * dist
    return Pose(x=x_r, y=y_r, theta=theta_r), peak
