"""Directional ray-distance lookup tables for static maps.

The measurement update of MCL localization raycasts N_particles x N_beams
rays against the SAME static map every step (`slam/mcl.cpp:49-77`). On an
accelerator the per-ray march is gather-latency-bound, so for static maps we precompute
the answer: ``lut[b, i, j]`` = distance from the center of cell (i, j) to the
first blocked cell along angular bin b. A ray query is then ONE gather
(+ elementwise angle binning) instead of a ~1000-probe march. This is the
(uncompressed) directional distance transform of the CDDT family (Walsh &
Karaman, "CDDT: Fast Approximate 2D Ray Casting for Accelerated
Localization", arXiv:1705.01167) — the dense form trades device memory for
O(1) queries.

Build: for each bin, the map is resampled into a rotated canvas where the bin
direction becomes "+column"; the run length to the next blocked cell along a
row is an exact reverse cummin index trick (no sequential marching), and the
result is sampled back at the original cell centers. Resampling is
conservative (a rotated cell is blocked if ANY of its 4 bilinear neighbors
is), so thin walls never develop leaks; distances are thereby shortened by at
most ~1px.

Four-fold symmetry (when n_bins % 4 == 0, the default): one rotated canvas
serves bins theta, theta+90, theta+180, theta+270 — their ray directions are
the +col, -row, -col, +row axes of the SAME canvas, so the four distance
fields are the four forward/reverse cummin/cummax scans, and (because the
back-sample coordinates of the four bins are the point-symmetric images of
each other around the canvas center) all four sample back at IDENTICAL
[ui, vi] indices. The build is gather-bound; this cuts the rotation gathers
4x and fuses the four back-samples into one 4-value row gather (~3-4x
end-to-end on big maps).

Errors vs the exact march: angular binning (<= pi/n_bins), rotation resampling
(<= ~1px), origin-to-cell-center snap (<= ~0.7px). With the reference's
sigma=5px beam noise (`apps/grid_slam.cpp:88`) these are well inside the
measurement model's tolerance; tests/test_rayfield.py quantifies them and the
localization ATE test validates end-to-end quality.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from slam_tpu.core import grid as gridlib


def dilate2x2(blocked: jax.Array) -> jax.Array:
    """Conservative sampling support: "any of the 4 cells around a float
    point is blocked" becomes a nearest-floor sample of this one-pass 2x2
    dilation — ONE gather per rotated cell instead of four (the builds are
    gather-bound; this is 4x)."""
    dil = blocked | jnp.pad(blocked[1:, :], ((0, 1), (0, 0)))
    return dil | jnp.pad(dil[:, 1:], ((0, 0), (0, 1)))


def rotated_blocked_canvas(
    blocked: jax.Array, theta, d: int, dil: jax.Array | None = None
) -> jax.Array:
    """Conservative rotated canvas shared by the dense and compressed
    (`slam_tpu.ops.cddt`) directional builds: canvas cell (u, v) samples
    the 2x2-dilated map at the rotated point, with +v the ray direction of
    `theta`. Both builds MUST use this one definition — the cddt-equals-
    dense invariant (tested) rides on it. Pass a precomputed `dilate2x2`
    result when calling per-bin inside a loop (XLA does not reliably hoist
    the dilation out of lax.map bodies)."""
    from slam_tpu.core import grid as gridlib

    h, w = blocked.shape
    ci, cj, cd = (h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0
    uu = jax.lax.broadcasted_iota(jnp.float32, (d, d), 0) - cd
    vv = jax.lax.broadcasted_iota(jnp.float32, (d, d), 1) - cd
    if dil is None:
        dil = dilate2x2(blocked)
    di = -jnp.sin(theta)
    dj = jnp.cos(theta)
    fi = ci + uu * dj + vv * di
    fj = cj + uu * (-di) + vv * dj
    i = jnp.floor(fi).astype(jnp.int32)
    j = jnp.floor(fj).astype(jnp.int32)
    inb = gridlib.in_bounds((h, w), i, j)
    ic = jnp.clip(i, 0, h - 1)
    jc = jnp.clip(j, 0, w - 1)
    return dil.reshape(-1)[ic * w + jc] & inb


def build_beam_lut(
    blocked: jax.Array,
    n_bins: int = 360,
    max_dist: float = 500.0,
    dtype=jnp.bfloat16,
    *,
    _force_per_bin: bool = False,
) -> jax.Array:
    """[H, W, n_bins] distance-to-obstacle table (values capped just above
    max_dist so queries >= max_dist read as misses).

    Bins-LAST layout: all bins of one cell are contiguous, so a particle
    whose beams all originate at the same cell reads ONE contiguous row
    (see `panorama_rows` / the fused measurement path) instead of n_beams
    scattered elements."""
    h, w = blocked.shape
    d = int(math.ceil(math.hypot(h, w))) + 2
    cap = jnp.float32(max_dist * 1.25)

    ci = (h - 1) / 2.0
    cj = (w - 1) / 2.0
    cd = (d - 1) / 2.0

    ucol = jax.lax.broadcasted_iota(jnp.float32, (d, d), 0)
    vcol = jax.lax.broadcasted_iota(jnp.float32, (d, d), 1)

    ii_img = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) - ci
    jj_img = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) - cj

    dil = dilate2x2(blocked)

    def canvas_and_back_idx(theta):
        # Ray direction in image coords (world y-up -> image row-down);
        # rotated-frame axes: +v == ray direction, +u its perpendicular.
        di = -jnp.sin(theta)
        dj = jnp.cos(theta)
        rot_blocked = rotated_blocked_canvas(blocked, theta, d, dil)
        # Back-sample at original cell centers: rotated coords of (i, j).
        u_q = ii_img * dj + jj_img * (-di) + cd
        v_q = ii_img * di + jj_img * dj + cd
        ui = jnp.clip(jnp.round(u_q).astype(jnp.int32), 0, d - 1)
        vi = jnp.clip(jnp.round(v_q).astype(jnp.int32), 0, d - 1)
        return rot_blocked, ui, vi

    def encode(run):
        out = jnp.minimum(run, cap)
        if dtype == jnp.uint8:
            # Fixed-point: v = floor(d / q), q = cap/255 (dequant adds q/2,
            # so the error is +-q/2 ~ +-1.2px at max_dist 500). Halves the
            # table vs bf16 — the dense-table answer to CDDT compression,
            # for maps where [H, W, bins] at 2 bytes outgrows device memory.
            q = cap / 255.0
            return jnp.clip(jnp.floor(out / q), 0.0, 255.0).astype(jnp.uint8)
        return out.astype(dtype)

    big = jnp.float32(1 << 20)

    # `_force_per_bin` exists so tests can check the symmetric quad build
    # against the direct one-canvas-per-bin construction.
    if n_bins % 4 == 0 and not _force_per_bin:
        n4 = n_bins // 4

        def one_quad(b):
            theta = b.astype(jnp.float32) * (2.0 * jnp.pi / n_bins)
            rot_blocked, ui, vi = canvas_and_back_idx(theta)
            vb = jnp.where(rot_blocked, vcol, big)
            vbn = jnp.where(rot_blocked, vcol, -big)
            ub = jnp.where(rot_blocked, ucol, big)
            ubn = jnp.where(rot_blocked, ucol, -big)
            runs = [
                # theta: distance along +v.
                jax.lax.cummin(vb, axis=1, reverse=True) - vcol,
                # theta + 90: ray dir == -u of this canvas.
                ucol - jax.lax.cummax(ubn, axis=0),
                # theta + 180: -v.
                vcol - jax.lax.cummax(vbn, axis=1),
                # theta + 270: +u.
                jax.lax.cummin(ub, axis=0, reverse=True) - ucol,
            ]
            # Encode BEFORE the back-sample (elementwise commutes with the
            # gather) so the fused row gather moves 4 encoded values/cell.
            packed = jnp.stack([encode(r) for r in runs], axis=-1)
            return packed.reshape(d * d, 4)[ui * d + vi]  # [h, w, 4]

        per = jax.lax.map(one_quad, jnp.arange(n4, dtype=jnp.int32))
        # per[b, i, j, q] -> bin index q * n4 + b.
        return jnp.moveaxis(per, 0, -1).reshape(h, w, n_bins)

    def one_bin(b):
        theta = b.astype(jnp.float32) * (2.0 * jnp.pi / n_bins)
        rot_blocked, ui, vi = canvas_and_back_idx(theta)
        nb = jax.lax.cummin(
            jnp.where(rot_blocked, vcol, big), axis=1, reverse=True
        )
        return encode((nb - vcol)[ui, vi])

    per_bin = jax.lax.map(one_bin, jnp.arange(n_bins, dtype=jnp.int32))
    return jnp.moveaxis(per_bin, 0, -1)  # [n_bins, H, W] -> [H, W, n_bins]


def lut_quant_step(lut_dtype, max_dist: float):
    """Dequantization step q for a quantized table (None for float tables);
    a stored value v decodes as (v + 0.5) * q."""
    if lut_dtype == jnp.uint8:
        return float(max_dist) * 1.25 / 255.0
    return None


def dequantize(vals, lut_dtype, max_dist: float):
    """Decode raw table values to f32 distances."""
    q = lut_quant_step(lut_dtype, max_dist)
    vals = vals.astype(jnp.float32)
    return vals if q is None else (vals + 0.5) * q


def angle_bin(theta, n_bins: int):
    """Angular bin of a ray direction (round-to-nearest, wrapped)."""
    two_pi = 2.0 * jnp.pi
    return jnp.round(theta / (two_pi / n_bins)).astype(jnp.int32) % n_bins


def padded_bins(n_bins: int, dtype) -> int:
    """Aligned STORAGE row width for the row gather (512 for bf16, 384 for
    u8). NOT applied by default: converged MCL particles cluster on few
    cells, where aligned rows can make the hot set collide and the odd
    unpadded stride spreads hot rows better. Kept for workloads with
    genuinely scattered queries. Not measured on the H100."""
    mult = 384 if dtype == jnp.uint8 else 512
    return -(-n_bins // mult) * mult


def pad_lut_rows(lut: jax.Array) -> jax.Array:
    """Pad the bins (last) axis of [H, W, n_bins] to `padded_bins` width
    (see the caveat there — helps uniform-random queries, hurts clustered
    ones)."""
    n = lut.shape[-1]
    p = padded_bins(n, lut.dtype)
    if p == n:
        return lut
    return jnp.pad(lut, ((0, 0),) * (lut.ndim - 1) + ((0, p - n),))


def raycast_lut(
    lut: jax.Array,
    x: jax.Array,
    y: jax.Array,
    theta: jax.Array,
    *,
    max_dist: float = 500.0,
    n_bins: int | None = None,
):
    """Query the table: one gather per ray. Returns (dist, hit) with the
    march/march-sdf conventions (miss -> dist == max_dist, hit == False).

    `n_bins` is the SEMANTIC bin count when the storage rows are padded
    (`pad_lut_rows`); defaults to the storage width for unpadded tables."""
    h, w, stride = lut.shape
    n_bins = n_bins or stride
    x, y, theta = jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(theta, jnp.float32),
    )
    b = angle_bin(theta, n_bins)
    i, j = gridlib.world_to_cell((h, w), x, y)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    # Flat 1D indexing: XLA lowers it ~20% faster than the 3D gather form.
    d = dequantize(
        lut.reshape(-1)[(ic * w + jc) * stride + b], lut.dtype, max_dist
    )
    hit = (d < max_dist) & inb
    dist = jnp.where(hit, d, max_dist)
    return dist, hit


def panorama_rows(
    lut: jax.Array, x: jax.Array, y: jax.Array, n_bins: int | None = None
):
    """All-bins distance row for each query position: ONE row-slice gather
    per query instead of one scalar gather per (query, beam).

    This is the hot-kernel restructuring for MCL: every beam of a particle
    originates at the same sensor cell (`slam/mcl.cpp:60-75` shifts the pose
    once, then loops beams), so the [N, B] scalar-gather wall becomes [N]
    contiguous row reads of the bins-last table. The gather reads the full
    (padded) storage row — row alignment, not width, sets its cost — and
    the returned view drops the pad bins (the slice fuses into consumers).

    Returns (pano f32-convertible [..., n_bins], inb bool[...]).
    """
    h, w, stride = lut.shape
    n_bins = n_bins or stride
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    i, j = gridlib.world_to_cell((h, w), x, y)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)
    pano = lut.reshape(h * w, stride)[ic * w + jc]
    return pano[..., :n_bins], inb
