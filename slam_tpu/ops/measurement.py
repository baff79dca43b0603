"""Beam-endpoint measurement model.

Vectorized re-expression of `measurement_model_beam` + the weighting loop of
`MCL::update_inner` (`slam/raycast.cpp:225-242`, `slam/mcl.cpp:49-77`):
instead of N_particles x N_beams scalar ray marches across a pthread fan-out,
one batched raycast over the [N, B] ray grid followed by fused elementwise
log-pdf accumulation.

Architectural note: the reference *mutates each particle's map while
weighting* (mapping fused into the measurement model, SURVEY.md section 5
quirk 4). The shared-map design evaluates all particles against the same
frozen grid and applies the map update separately (slam_tpu.ops.mapping) —
the well-defined parallel semantics SURVEY section 7 calls for.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from slam_tpu.core.config import RaycastConfig
from slam_tpu.core.stats import log_pdf_normal_clamp_eps
from slam_tpu.core.types import Pose, Scan
from slam_tpu.ops import lut as lutlib
from slam_tpu.ops.rayfield import as_ray_field, raycast_field


def scanner_displacement(scanner_offset):
    """Decompose a mounting offset pose into (d, theta, rot)
    (`slam/mcl.cpp:80-86`)."""
    ox, oy, orot = scanner_offset
    return math.hypot(ox, oy), math.atan2(oy, ox), orot


def sensor_pose(pose: Pose, scanner_offset) -> Pose:
    """Sensor pose in the world frame given the robot pose and the lidar
    mounting offset (`slam/mcl.cpp:88-100`)."""
    d, th, rot = scanner_displacement(scanner_offset)
    return Pose(
        x=pose.x + jnp.cos(pose.theta + th) * d,
        y=pose.y + jnp.sin(pose.theta + th) * d,
        theta=pose.theta + rot,
    )


def beam_log_weights(pred_dist, hit, meas_dist, *, stddev, max_dist, eps=0.1):
    """Per-beam log weight.

    Hit: log(pdf_clamp(sigma, predicted - measured) + eps); no-hit:
    log(pdf_clamp(sigma, measured - max_dist) + eps)
    (`slam/raycast.cpp:225-242`).
    """
    err = jnp.where(hit, pred_dist - meas_dist, meas_dist - max_dist)
    return log_pdf_normal_clamp_eps(stddev, err, eps)


def beam_weights_probabilistic(
    prob_occ: jax.Array,
    poses: Pose,
    scan: Scan,
    *,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    max_dist: float = 500.0,
    step: float = 0.5,
):
    """'Most probable along ray' beam model over an UNCERTAIN occupancy map
    (the reference notebook's cell-10 `measurement_model_beam_probabilistic`,
    which the C++ dropped — SURVEY.md section 2 item 23).

    Marching along each beam, a cell at distance d scores
    q = p * P(occ) * pdf_clamp(z - d) where p is the survival probability
    (prob no earlier cell produced the return, p <- p * (1 - q)); the beam
    weight is the max q, floored by pdf(1.5 sigma) and the max-range term.
    The survival recurrence is sequential along the ray, so this runs as a
    lax.scan over ray steps vectorized across [N, B] beams (K elementwise
    passes + K gathers) — a mapping-mode scoring tool, not the fast
    localization path.

    Returns f32[N, B] beam weights (probabilities, not logs).
    """
    from slam_tpu.core import grid as gridlib
    from slam_tpu.core.stats import pdf_normal, pdf_normal_clamp

    h, w = prob_occ.shape
    prob_flat = prob_occ.reshape(-1)
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]
    dx = jnp.cos(angles) * step
    dy = jnp.sin(angles) * step
    z = scan.dists[None, :]

    i0, j0 = gridlib.world_to_cell((h, w), sp.x, sp.y)
    cell0 = (i0 * w + j0)[:, None]

    k_total = int(math.ceil(max_dist / step))
    floor = pdf_normal(stddev, 1.5 * stddev)

    def body(carry, k):
        p, best, prev_cell, alive = carry
        d = (k + 1.0) * step
        px = sp.x[:, None] + (k + 1.0) * dx
        py = sp.y[:, None] + (k + 1.0) * dy
        i, j = gridlib.world_to_cell((h, w), px, py)
        inb = gridlib.in_bounds((h, w), i, j)
        ic, jc = gridlib.clamp_cell((h, w), i, j)
        cell = i * w + j
        # The notebook breaks at the first out-of-bounds position and stops
        # scoring before d >= z_max; `alive` carries the not-yet-broken flag.
        score = (cell != prev_cell) & inb & alive & (d < max_dist)
        occ = prob_flat[ic * w + jc]
        q = jnp.where(score, p * occ * pdf_normal_clamp(stddev, z - d), 0.0)
        best = jnp.maximum(best, q)
        p = jnp.where(score, p * (1.0 - q), p)
        prev_cell = jnp.where(score, cell, prev_cell)
        alive = alive & inb
        return (p, best, prev_cell, alive), None

    init = (
        jnp.ones_like(angles),
        jnp.full_like(angles, floor),
        jnp.broadcast_to(cell0, angles.shape),
        jnp.ones(angles.shape, bool),
    )
    (p, best, _, alive), _ = jax.lax.scan(
        body, init, jnp.arange(k_total, dtype=jnp.float32)
    )
    # Max-range term — only for rays that reached z_max inside the map.
    best = jnp.maximum(
        best, jnp.where(alive, p * pdf_normal_clamp(stddev, z - max_dist), 0.0)
    )
    return best


def particle_log_weights_likelihood_field(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    ray_sharding=None,
):
    """Likelihood-field measurement model (Thrun et al. table 6.3).

    Each beam's endpoint in the world frame is scored by its Euclidean
    distance to the nearest obstacle (one gather from the EDT) under a
    z_hit * N(0, sigma) + z_rand / z_max mixture; max-range beams are
    skipped, out-of-map endpoints get the random-mixture floor. No
    raycasting — the fast model for both static and per-step-updated
    maps (the EDT rebuilds gather-free via JFA).
    """
    from slam_tpu.core.stats import pdf_normal
    from slam_tpu.ops.rayfield import as_ray_field
    from slam_tpu.core import grid as gridlib

    field = as_ray_field(field, rc)
    if field.edt is None:
        raise ValueError(
            "likelihood_field needs field.edt (use the 'sdf' backend)"
        )
    h, w = field.edt.shape
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]
    z = scan.dists[None, :]
    ex = sp.x[:, None] + z * jnp.cos(angles)
    ey = sp.y[:, None] + z * jnp.sin(angles)
    if ray_sharding is not None:
        ex, ey = (
            jax.lax.with_sharding_constraint(a, ray_sharding) for a in (ex, ey)
        )
    i, j = gridlib.world_to_cell((h, w), ex, ey)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    d = field.edt.reshape(-1)[ic * w + jc]

    p_hit = jnp.where(inb, pdf_normal(stddev, d), 0.0)
    p = z_hit * p_hit + z_rand / rc.max_dist
    lw = jnp.log(jnp.maximum(p, 1e-30))
    # Max-range misses carry no endpoint information (model skip).
    lw = jnp.where(z >= rc.max_dist, 0.0, lw)
    return jnp.sum(lw, axis=-1)


def lf_log_score_field(edt, *, stddev, z_hit, z_rand, max_dist):
    """Per-cell beam-endpoint log score over the EDT:
    log(z_hit * N(edt; sigma) + z_rand / z_max) — the field both the
    correlative table build (`lf_score_table`) and the scan-matching
    refinement (slam_tpu.ops.scanmatch) slide windows over."""
    from slam_tpu.core.stats import pdf_normal

    return jnp.log(
        jnp.maximum(z_hit * pdf_normal(stddev, edt) + z_rand / max_dist, 1e-30)
    )


def lf_score_table(
    edt,
    scan: Scan,
    headings,
    *,
    rc,
    stddev,
    z_hit,
    z_rand,
    dtype="f32",
    bin_sharding=None,
    origin=None,
    out_shape=None,
    lpad=None,
):
    """Correlative likelihood-field score table over explicit heading bins.

    For each heading-bin center ``headings[t]`` build the dense map
    ``S[t, i, j] = sum_b L(endpoint of beam b fired from cell (i, j) at
    heading t)`` where ``L`` is the per-cell log mixture score
    ``log(z_hit * N(edt; sigma) + z_rand / z_max)`` of
    `particle_log_weights_likelihood_field`. Correlative scan matching
    (Olson, ICRA 2009) turned into a dense build: each (bin, beam) term is one
    ``dynamic_slice`` window of the padded L field — B dense map-shaped adds
    per bin instead of per-particle scattered gathers. Max-range beams carry
    no endpoint information and are excluded (the direct model's skip at
    `slam/raycast.cpp:234-237` analog); out-of-map endpoints read the padded
    ``log(z_rand / z_max)`` floor, exactly the direct model's out-of-bounds
    value.

    Offsets use the snapped-sensor arithmetic ``floor(0.5 + dx)`` /
    ``floor(0.5 - dy)``: for a sensor exactly at a cell center and a heading
    exactly on a bin center the table entry selects exactly the direct
    model's endpoint cells (`world_to_cell` is floor, `core/grid.py:26-32`),
    so the score matches up to float summation-order rounding (the beam
    reduction here is an einsum, the direct path a jnp.sum); for arbitrary
    poses the endpoint cell is off by at most one cell.

    Returns f32[T, H, W]. Memory/traffic scale with T * H * W — the build is
    particle-count-independent, which is the whole point (see
    `particle_log_weights_lf_table`).

    ``origin``/``out_shape`` restrict the build to a sub-box of the map:
    ``origin`` is a traced ``(i0, j0)`` int pair, ``out_shape`` a STATIC
    ``(si, sj)``; the returned table is ``[T, si, sj]`` and row ``(a, b)``
    of it is the full table's row ``(i0 + a, j0 + b)``. Traffic then scales
    with T * si * sj instead of map area — the spatial analog of the
    adaptive heading window (see `particle_log_weights_lf_table`'s
    ``box_size``). The caller must guarantee ``0 <= i0 <= H - si`` (clip).

    ``lpad`` supplies the padded per-cell score window directly (shape
    ``(si + 2pad, sj + 2pad)``, row 0 = the full padded field's row
    ``i0 - pad``) and skips computing it here — the map-block-sharded
    engine assembles this window from the DISTRIBUTED EDT (each block
    contributes its rows, one psum) so no device ever materializes the
    full-map score field (slam_tpu.parallel.edt.lf_window_sharded).
    Requires ``out_shape``; ``edt`` is ignored except for its shape.
    """
    h, w = edt.shape
    si, sj = (h, w) if out_shape is None else out_shape
    if origin is None:
        i0 = j0 = jnp.int32(0)
    else:
        i0 = jnp.asarray(origin[0], jnp.int32)
        j0 = jnp.asarray(origin[1], jnp.int32)
    pad = int(math.ceil(rc.max_dist)) + 1
    floor_val = float(math.log(max(z_rand / rc.max_dist, 1e-30)))
    # The build reads T x B windows of the score field; dtype="bf16" halves
    # that traffic. Accumulation stays f32 (the einsum below upcasts), so
    # only the per-cell score quantizes (~0.4% rel).
    store = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    if lpad is not None:
        if out_shape is None:
            raise ValueError("lf_score_table(lpad=...) requires out_shape")
        if lpad.shape != (si + 2 * pad, sj + 2 * pad):
            raise ValueError(
                f"lpad shape {lpad.shape} != expected "
                f"{(si + 2 * pad, sj + 2 * pad)}"
            )
        lpad = lpad.astype(store)
        i0 = j0 = jnp.int32(0)
    else:
        L = lf_log_score_field(
            edt, stddev=stddev, z_hit=z_hit, z_rand=z_rand,
            max_dist=rc.max_dist,
        ).astype(store)
    if lpad is not None:
        pass  # supplied by the caller (see docstring)
    elif origin is None:
        lpad = jnp.pad(L, pad, constant_values=jnp.asarray(floor_val, store))
    else:
        # Box build: the windows only ever read the (si + 2pad, sj + 2pad)
        # span around the box, so materialize exactly that window of the
        # padded field instead of padding the whole map (on a 2354x2464 map
        # with pad 501 the full pad would be an 11.6M-cell array per step).
        # Row/col gathers with clipped indices + a floor mask reproduce the
        # padded field's values bit-for-bit; window slice starts then drop
        # the i0/j0 offset (the window's origin IS the box - pad corner).
        la_i, la_j = si + 2 * pad, sj + 2 * pad
        rows = i0 - pad + jnp.arange(la_i)
        cols = j0 - pad + jnp.arange(la_j)
        in_i = (rows >= 0) & (rows < h)
        in_j = (cols >= 0) & (cols < w)
        core = L[jnp.clip(rows, 0, h - 1)][:, jnp.clip(cols, 0, w - 1)]
        lpad = jnp.where(
            in_i[:, None] & in_j[None, :],
            core,
            jnp.asarray(floor_val, store),
        )
        i0 = j0 = jnp.int32(0)

    valid = (scan.dists < rc.max_dist).astype(jnp.float32)  # [B]
    ang = headings[:, None] + scan.angles[None, :]  # [T, B]
    dx = scan.dists[None, :] * jnp.cos(ang)
    dy = scan.dists[None, :] * jnp.sin(ang)
    # Cell offsets (i grows downward = -y, `core/grid.py:26-32`).
    oi = jnp.floor(0.5 - dy).astype(jnp.int32) + pad
    oj = jnp.floor(0.5 + dx).astype(jnp.int32) + pad

    # Beams accumulate in chunks so peak memory per bin is O(chunk * H * W)
    # instead of O(B * H * W) — a 90-beam x 2048^2 f32 window stack would be
    # ~1.5 GB if XLA declined to fuse the slice into the reduction. Padded
    # chunk entries carry valid=0 and contribute nothing.
    chunk = 8
    b = oi.shape[1]
    bpad = (-b) % chunk
    n_chunks = (b + bpad) // chunk
    oi_c = jnp.pad(oi, ((0, 0), (0, bpad))).reshape(-1, n_chunks, chunk)
    oj_c = jnp.pad(oj, ((0, 0), (0, bpad))).reshape(-1, n_chunks, chunk)
    valid_c = jnp.pad(valid, (0, bpad)).reshape(n_chunks, chunk)

    def one_bin(ofs):
        oi_t, oj_t = ofs  # [n_chunks, chunk]

        def body(acc, xs):
            a, bcol, v = xs
            win = jax.vmap(
                lambda p, q: jax.lax.dynamic_slice(
                    lpad, (p + i0, q + j0), (si, sj)
                )
            )(a, bcol)  # [chunk, si, sj]
            # HIGHEST: at DEFAULT an f32 contraction may run in TF32 on a
            # GPU (~3 decimal digits of each log-score).
            return acc + jnp.einsum(
                "bij,b->ij", win, v, precision=jax.lax.Precision.HIGHEST
            ), None

        acc, _ = jax.lax.scan(
            body, jnp.zeros((si, sj), jnp.float32), (oi_t, oj_t, valid_c)
        )
        return acc

    if bin_sharding is not None:
        # Multi-device: bins in parallel (vmap) with the bin axis pinned to
        # the mesh — each device builds T / |axis| bins; the downstream
        # per-particle gather re-replicates the table (one ~T*H*W*4 B
        # all-gather). The sequential lax.map below stays the
        # single-device default (vmap's [T, chunk, H, W] slice stack is
        # T/8-sharded here, but would be resident in full on one device).
        table = jax.lax.with_sharding_constraint(
            jax.vmap(one_bin)((oi_c, oj_c)), bin_sharding
        )
        return table
    return jax.lax.map(one_bin, (oi_c, oj_c))  # [T, h, w]


def particle_log_weights_lf_table(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    table_bins: int = 32,
    spread_mult: float = 4.0,
    min_halfwidth: float = 0.02,
    table_dtype: str = "f32",
    box_size=None,
    ray_sharding=None,
):
    """Likelihood-field weights via a windowed correlative score table.

    The direct likelihood field issues N x B scattered scalar EDT gathers —
    the dominant cost of the large-N SLAM step (90M gathers at 1M particles
    x 90 beams; scattered scalar gathers are latency-bound). This path
    builds `lf_score_table` over ``table_bins`` heading bins spanning the
    particle cloud's ACTUAL circular heading spread (mean +- spread_mult *
    circular std, clamped to [min_halfwidth, pi]), then scores each
    particle with ONE contiguous 2-element gather at its sensor cell (the
    bins-last table puts the (t0, t0+1) lerp pair side by side).
    Build cost is particle-count-independent; per-particle cost drops B-fold.

    Accuracy: endpoint positions are quantized by the sensor-cell rounding
    (<= 1 px, the same order as the dense LUT's accepted +-1.2 px) plus the
    heading bin width times beam range. In tracking mode the window follows
    the converged cloud (circular std ~1 deg -> bin width ~0.1 deg -> sub-px
    endpoint error at max range). With a dispersed cloud (global
    localization) the window widens to 2*pi and bins coarsen — use the
    direct model or the beam LUT there; this path is the large-N tracking /
    SLAM fast path. Particles heading outside the window (more than half a
    bin beyond the edge bins) score the z_rand floor
    ``n_valid_beams * log(z_rand / z_max)`` — the lowest score the mixture
    model can emit — rather than clamping to a (possibly high) edge-bin
    score, so far-outlier headings cannot inherit inflated weights.

    ``box_size`` localizes the BUILD the same way the heading window
    localizes the bin axis: the table is built only over a static
    ``box_size x box_size`` cell box centered on the cloud's mean sensor
    cell, so build traffic scales with T * box^2 instead of T * H * W,
    which removes the "table build scales with MAP AREA" term that made
    the dense table lose on big maps.
    Particles whose sensor cell falls outside the box score the z_rand
    floor, exactly like out-of-window headings — a converged tracking
    cloud spans a few cells, so a 128-256 box is orders of magnitude of
    slack; for dispersed clouds (global localization) use the direct
    model, as already documented for the heading window.

    Interaction with adaptive injection (`MCLConfig.adaptive`): injected
    random particles carry uniform headings, which inflate the UNWEIGHTED
    circular std used here and coarsen the bins for everyone. That is the
    conservative failure mode (wider window, lower resolution), and the
    injected particles themselves land in the floor/edge region by design;
    if injection is routinely active, prefer the direct likelihood-field
    model for that phase.

    Under the sharded engines `ray_sharding` (the [N, B] P('p', 'b') spec)
    repurposes its beam axis: when the mesh has a non-trivial 'b' axis the
    TABLE BUILD shards its heading-bin axis over it (each device builds
    T / |b| bins; the per-particle lookup gather re-replicates the table —
    one ~T*H*W*4 B all-gather). All per-particle arrays are [N] and
    keep the particle sharding as usual.
    """
    field = as_ray_field(field, rc)
    prep = lf_table_prepare(
        field,
        poses,
        scan,
        rc=rc,
        scanner_offset=scanner_offset,
        stddev=stddev,
        z_hit=z_hit,
        z_rand=z_rand,
        table_bins=table_bins,
        spread_mult=spread_mult,
        min_halfwidth=min_halfwidth,
        table_dtype=table_dtype,
        box_size=box_size,
        ray_sharding=ray_sharding,
    )
    return lf_table_lookup(
        prep,
        poses,
        scan,
        rc=rc,
        scanner_offset=scanner_offset,
        z_rand=z_rand,
        grid_shape=field.edt.shape,
    )


def lf_auto_converged(poses: Pose, cfg, grid_shape, scanner_offset=(0.0, 0.0, 0.0)):
    """The auto-tier predicate (``measurement="likelihood_field_auto"``):
    True iff the cloud is table-eligible — the 4-sigma heading window is
    tighter than ``cfg.lf_auto_max_halfwidth`` AND the
    ``cfg.lf_auto_sigma``-sigma spatial extent fits the half-box.
    Reductions only (psum-clean on a sharded particle axis). ONE shared
    definition used by both the in-program `lax.cond` form
    (`slam_tpu.models.mcl.update`) and the host-lagged dispatcher
    (`slam_tpu.models.slam.AutoTierDispatcher`) so the two auto forms
    cannot silently pick different tiers for the same state."""
    sp = sensor_pose(poses, scanner_offset)
    c = jnp.mean(jnp.cos(sp.theta))
    s = jnp.mean(jnp.sin(sp.theta))
    rbar = jnp.clip(jnp.sqrt(c * c + s * s), 1e-7, 1.0 - 1e-7)
    cstd = jnp.sqrt(-2.0 * jnp.log(rbar))
    halfwidth = cfg.lf_table_spread * cstd + cfg.lf_table_min_halfwidth
    box_eff = (
        float(cfg.lf_table_box)
        if cfg.lf_table_box is not None
        else float(min(grid_shape))
    )
    return (
        (halfwidth <= cfg.lf_auto_max_halfwidth)
        & (cfg.lf_auto_sigma * jnp.std(sp.x) <= box_eff / 2.0)
        & (cfg.lf_auto_sigma * jnp.std(sp.y) <= box_eff / 2.0)
    )


def lf_table_window(
    poses: Pose,
    *,
    grid_shape,
    scanner_offset=(0.0, 0.0, 0.0),
    table_bins: int = 32,
    spread_mult: float = 4.0,
    min_halfwidth: float = 0.02,
    box_size=None,
):
    """Particle-count-independent window statistics of the correlative
    table: the heading-bin window from the cloud's circular spread and
    the box origin from its mean sensor cell. Reductions only — psums
    cleanly over a sharded particle axis, which is why the map-sharded
    engine reuses this helper verbatim (`parallel/mapshard.py`) instead
    of duplicating the formulas. Returns
    ``(mu, binw, halfwidth, headings[t], i0, j0, si, sj)``; ``si, sj``
    are static box dims (full map when ``box_size`` is None)."""
    from slam_tpu.core import grid as gridlib

    t = int(table_bins)
    if t < 2:
        raise ValueError(f"table_bins must be >= 2, got {t}")
    h, w = grid_shape
    sp = sensor_pose(poses, scanner_offset)
    c = jnp.mean(jnp.cos(sp.theta))
    s = jnp.mean(jnp.sin(sp.theta))
    mu = jnp.arctan2(s, c)
    rbar = jnp.clip(jnp.sqrt(c * c + s * s), 1e-7, 1.0 - 1e-7)
    cstd = jnp.sqrt(-2.0 * jnp.log(rbar))
    halfwidth = jnp.clip(
        spread_mult * cstd + min_halfwidth, min_halfwidth, jnp.pi
    )
    binw = 2.0 * halfwidth / (t - 1)
    headings = mu + (jnp.arange(t, dtype=jnp.float32) - (t - 1) / 2.0) * binw

    if box_size is None:
        si, sj = h, w
        i0 = j0 = jnp.int32(0)
    else:
        si = min(int(box_size), h)
        sj = min(int(box_size), w)
        mi, mj = gridlib.world_to_cell((h, w), jnp.mean(sp.x), jnp.mean(sp.y))
        i0 = jnp.clip(mi - si // 2, 0, h - si).astype(jnp.int32)
        j0 = jnp.clip(mj - sj // 2, 0, w - sj).astype(jnp.int32)
    return mu, binw, halfwidth, headings, i0, j0, si, sj


def lf_table_prepare(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    z_hit: float = 0.95,
    z_rand: float = 0.05,
    table_bins: int = 32,
    spread_mult: float = 4.0,
    min_halfwidth: float = 0.02,
    table_dtype: str = "f32",
    box_size=None,
    ray_sharding=None,
):
    """Particle-count-independent half of `particle_log_weights_lf_table`:
    heading window + box origin + score-table build. Returns the ``prep``
    tuple `lf_table_lookup` consumes: ``(tbl[si, sj, T] bins-last, mu,
    binw, halfwidth, i0, j0)``. Split out so the auto measurement tier can
    gate the build in a `lax.cond` while the N-particle lookup stays in
    the main computation (see `lf_table_lookup`)."""
    bin_sharding = None
    if ray_sharding is not None:
        try:
            from jax.sharding import NamedSharding, PartitionSpec

            mesh_ = ray_sharding.mesh
            if mesh_.shape.get("b", 1) > 1:
                bin_sharding = NamedSharding(
                    mesh_, PartitionSpec("b", None, None)
                )
        except AttributeError:
            pass  # not a NamedSharding — no bin axis to use
    field = as_ray_field(field, rc)
    if field.edt is None:
        raise ValueError(
            "likelihood_field_table needs field.edt (use the 'sdf' backend)"
        )
    h, w = field.edt.shape
    # Heading window from the cloud's circular statistics + spatial box
    # around its mean sensor cell (reduction-only -> psums cleanly on a
    # sharded particle axis).
    mu, binw, halfwidth, headings, i0, j0, si, sj = lf_table_window(
        poses,
        grid_shape=(h, w),
        scanner_offset=scanner_offset,
        table_bins=table_bins,
        spread_mult=spread_mult,
        min_halfwidth=min_halfwidth,
        box_size=box_size,
    )
    if box_size is None:
        origin = None
        out_shape = None
    else:
        origin = (i0, j0)
        out_shape = (si, sj)

    table = lf_score_table(
        field.edt, scan, headings, rc=rc, stddev=stddev, z_hit=z_hit,
        z_rand=z_rand, dtype=table_dtype, bin_sharding=bin_sharding,
        origin=origin, out_shape=out_shape,
    )

    tbl = jnp.moveaxis(table, 0, -1)  # [si, sj, T], one transpose per scan
    return (tbl, mu, binw, halfwidth, i0, j0)


def lf_table_lookup(
    prep,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig,
    scanner_offset=(0.0, 0.0, 0.0),
    z_rand: float = 0.05,
    grid_shape=None,
):
    """Per-particle lookup half of `particle_log_weights_lf_table`.

    ``prep`` is ``(tbl[si, sj, T] bins-last, mu, binw, halfwidth, i0, j0)``
    — everything particle-count-independent. Split out so the auto tier's
    `lax.cond` can gate the BUILD alone: lowering the N-particle pair
    gather inside a cond branch de-optimizes it (measured 30 -> 231 ms at
    1M, round 4); hoisted into the main computation it stays at the gather
    floor. One-gather lookup: sensor cell, lerp between adjacent heading
    bins. The bins-LAST table puts the (t0, t0+1) lerp pair side by side
    so both values ride ONE 2-element dynamic-slice gather per particle
    (at 1M the lookup gathers are most of the table phase — the same
    scattered-gather floor as the roofline's panorama rows). Indexing is
    multi-dim (no flat t*H*W + i*w + j word, which would overflow int32 at
    table_bins * H * W >= 2^31 — 32 bins on a ~8192^2 map, exactly the
    big-map regime this path targets).
    """
    from slam_tpu.core import grid as gridlib

    tbl, mu, binw, halfwidth, i0, j0 = prep
    si, sj, t = tbl.shape
    h, w = grid_shape
    sp = sensor_pose(poses, scanner_offset)
    # Guard against an all-zeros prep (the auto tier's untaken-branch
    # placeholder): binw = 0 would make d / binw NaN at d = 0 and poison
    # the int cast; the where() below discards these lanes either way.
    binw = jnp.where(binw > 0, binw, 1.0)
    i, j = gridlib.world_to_cell((h, w), sp.x, sp.y)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    # Box-local row/col; out-of-box particles take the floor (below).
    il = ic - i0
    jl = jc - j0
    in_box = (il >= 0) & (il < si) & (jl >= 0) & (jl < sj)
    ilc = jnp.clip(il, 0, si - 1)
    jlc = jnp.clip(jl, 0, sj - 1)
    d = jnp.arctan2(jnp.sin(sp.theta - mu), jnp.cos(sp.theta - mu))
    u = jnp.clip(d / binw + (t - 1) / 2.0, 0.0, float(t - 1))
    t0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, t - 2)
    frac = u - t0.astype(u.dtype)
    pair = jax.vmap(
        lambda a, b, k: jax.lax.dynamic_slice(tbl, (a, b, k), (1, 1, 2))[0, 0]
    )(ilc, jlc, t0)  # [N, 2]
    score = (1.0 - frac) * pair[:, 0] + frac * pair[:, 1]
    # Out-of-window headings (beyond half a bin past the edge) and
    # out-of-box positions: z_rand floor instead of an edge score (see
    # docstring).
    n_valid = jnp.sum(scan.dists < rc.max_dist).astype(jnp.float32)
    floor_lw = n_valid * float(math.log(max(z_rand / rc.max_dist, 1e-30)))
    out = (jnp.abs(d) > halfwidth + 0.5 * binw) | ~in_box
    return jnp.where(out, floor_lw, score)


def particle_log_weights_lut_fused(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig,
    beam_stride: int,
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    eps: float = 0.1,
    ray_sharding=None,
):
    """Fused beam-model weights via LUT panorama rows — the MCL hot path.

    Replaces the N_particles x N_beams scalar-gather query of the beam LUT
    with:

      1. ONE contiguous row gather per particle — all bins of the sensor
         cell (`slam_tpu.ops.lut.panorama_rows`); valid because every beam
         of a particle shares its origin cell (`slam/mcl.cpp:60-75`).
      2. A dense bin->beam alignment. `beam_stride` g is the STATIC promise
         that beam angles are evenly spaced by exactly g bins; then beam k's
         bin is (s_n + g*k) mod n_bins with s_n = round((theta_n + a_0)/w) —
         EXACTLY the per-beam rounding of `raycast_lut` (g*k is an integer,
         so it commutes through round). Writing s_n = g*q_n + r_n, beam k
         lands at position (q_n + k) mod M of the stride-g comb r_n
         (M = n_bins/g): selecting r_n is a one-hot multiply-and-sum over
         g, and aligning the measured ranges to positions is a gather from
         the M-entry scan table. Both are exact: no f32 contraction that a
         GPU could run in TF32.
      3. The same clamped-Gaussian beam log-pdf + reduce as the general
         path (`slam/raycast.cpp:225-242` semantics).
    """
    lut = field.lut
    if lut is None:
        raise ValueError("lut-fused measurement needs field.lut")
    h, w, _stride = lut.shape
    n_bins = field.lut_bins or _stride
    g = int(beam_stride)
    if g < 1 or n_bins % g != 0:
        raise ValueError(f"beam_stride {g} must divide lut bins {n_bins}")
    m = n_bins // g
    b_beams = scan.angles.shape[0]
    if b_beams > m:
        raise ValueError(
            f"{b_beams} beams at stride {g} exceed {m} distinct positions"
        )
    binw = 2.0 * jnp.pi / n_bins

    sp = sensor_pose(poses, scanner_offset)
    s = jnp.round((sp.theta + scan.angles[0]) / binw).astype(jnp.int32) % n_bins
    q = s // g
    r = s % g

    pano, inb = lutlib.panorama_rows(lut, sp.x, sp.y, n_bins)  # [N, n_bins]
    if ray_sharding is not None:
        pano = jax.lax.with_sharding_constraint(pano, ray_sharding)

    # Comb select: position p of comb r_n is bin g*p + r_n. A one-hot
    # multiply-and-sum (one nonzero term: exact in any dtype, and no
    # contraction that could run in TF32). Quantized (u8) tables compute in
    # bf16 (integers <= 255 are exact) then dequantize.
    cdt = jnp.bfloat16 if jnp.issubdtype(lut.dtype, jnp.integer) else lut.dtype
    oh_r = jax.nn.one_hot(r, g, dtype=cdt)  # [N, g]
    raw = jnp.sum(
        pano.reshape(-1, m, g).astype(cdt) * oh_r[:, None, :], axis=-1
    )  # [N, M]
    pred = lutlib.dequantize(raw, lut.dtype, rc.max_dist)

    # Align measured ranges/validity to positions: beam k sits at position
    # (q_n + k) mod M, so position p holds beam (p - q_n) mod M — a gather
    # from the tiny (padded) scan table, exact where a one-hot matmul could
    # round the ranges in TF32.
    ztab = jnp.pad(jnp.asarray(scan.dists, jnp.float32), (0, m - b_beams))
    mm = jnp.arange(m)
    beam = (mm[None, :] - q[:, None]) % m  # [N, M] beam at position p
    z_at = ztab[beam]
    valid = (beam < b_beams).astype(jnp.float32)

    hit = (pred < rc.max_dist) & inb[:, None]
    err = jnp.where(hit, pred - z_at, z_at - rc.max_dist)
    lw = log_pdf_normal_clamp_eps(stddev, err, eps) * valid
    return jnp.sum(lw, axis=-1)


def particle_log_weights(
    field,
    poses: Pose,
    scan: Scan,
    *,
    rc: RaycastConfig = RaycastConfig(),
    scanner_offset=(0.0, 0.0, 0.0),
    stddev: float = 5.0,
    eps: float = 0.1,
    ray_sharding=None,
    lut_beam_stride=None,
):
    """Log measurement likelihood of every particle given one scan.

    Args:
      field: a `RayField` (prebuilt backend structure) or a raw bool[H, W]
        blocked mask (wrapped on the fly; see slam_tpu.ops.rayfield).
      poses: particle poses, batch shape [N].
      scan: B beams (angles relative to heading, measured ranges).
      rc: raycast backend config.
      ray_sharding: optional `jax.sharding.Sharding` for the [N, B] ray batch.
        Under a 2D (particle, beam) device mesh this pins the hot raycast to
        both axes; GSPMD then inserts the psum for the beam-axis reduction.

    Returns:
      f32[N] sum of per-beam log weights (the log of `slam/mcl.cpp:69-75`'s
      exp-sum weight).
    """
    field = as_ray_field(field, rc)
    if (
        lut_beam_stride is not None
        and rc.backend == "lut"
        and field.lut is not None
    ):
        return particle_log_weights_lut_fused(
            field,
            poses,
            scan,
            rc=rc,
            beam_stride=lut_beam_stride,
            scanner_offset=scanner_offset,
            stddev=stddev,
            eps=eps,
            ray_sharding=ray_sharding,
        )
    sp = sensor_pose(poses, scanner_offset)
    angles = sp.theta[:, None] + scan.angles[None, :]  # [N, B]
    px = jnp.broadcast_to(sp.x[:, None], angles.shape)
    py = jnp.broadcast_to(sp.y[:, None], angles.shape)
    if ray_sharding is not None:
        px, py, angles = (
            jax.lax.with_sharding_constraint(a, ray_sharding)
            for a in (px, py, angles)
        )
    pred, hit = raycast_field(field, px, py, angles, rc)
    lw = beam_log_weights(
        pred,
        hit,
        scan.dists[None, :],
        stddev=stddev,
        max_dist=rc.max_dist,
        eps=eps,
    )
    return jnp.sum(lw, axis=-1)
