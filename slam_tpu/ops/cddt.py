"""Compressed directional distance transform (CDDT) for huge static maps.

The dense beam LUT (`slam_tpu.ops.lut`) answers a ray query with one gather
but stores [H, W, n_bins] — ~2 GiB for the reference maze at u8 and beyond
device memory for much larger maps. This module is the COMPRESSED form from the CDDT
paper the dense table cites (Walsh & Karaman, arXiv:1705.01167): instead of
a distance per (cell, bin), store per (bin, canvas-row) the sorted obstacle
RUN intervals along the ray direction. Queries read the ray's whole
interval row (one contiguous 2K-i16 gather + a vectorized masked min —
K is small: 17 on the reference maze) or, for K > 64, fall back to a
fixed-trip binary search (ceil(log2(K)) dependent gathers).

Two structural savings vs dense:

  * memory ~ n_bins/2 x d x K x 2 entries (K = max obstacle runs crossing
    any rotated row) — for wall-like maps K << map extent, typically a
    5-20x reduction;
  * bins theta and theta+180 share one table: the reverse ray searches the
    same intervals backward (the paper's half-table trick), so only
    n_bins/2 projections are stored.

Geometry is IDENTICAL to the dense build (same rotated canvas, same
conservative 2x2-dilated sampling, same cell-center snap — see
`lut.build_beam_lut`), so a CDDT query equals the dense-LUT query except
for ulp-level angle ties: the dense quad build derives bins [n/4, n/2)
from the [0, n/4) canvases while this table evaluates their own angles.

This is the static-map fallback tier for maps whose dense table outgrows
device memory; for maps that fit, the dense bins-last table's panorama row gather
stays the fast path (`ops/measurement.py`). Reference semantics:
`slam/raycast.cpp:8-141` (march the query replaces).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from slam_tpu.core import struct

from slam_tpu.core import grid as gridlib
from slam_tpu.ops import lut as lutlib

_PAD = 32767  # i16 sentinel: beyond any canvas coordinate


@struct.dataclass
class CDDTTable:
    """starts/ends: i16[n_bins//2, d, K] sorted obstacle-run intervals per
    (half-bin, canvas row), padded with _PAD. n_overflow > 0 means some row
    had more than K runs (the tail was dropped — rebuild with a larger K)."""

    starts: jax.Array
    ends: jax.Array
    n_bins: int = struct.field(pytree_node=False, default=360)
    n_overflow: int = struct.field(pytree_node=False, default=0)

    @property
    def d(self) -> int:
        return self.starts.shape[1]

    @property
    def k(self) -> int:
        return self.starts.shape[2]

    @property
    def nbytes(self) -> int:
        return self.starts.size * 2 + self.ends.size * 2


def _row_intervals(rot: jax.Array, k: int):
    """Per-row obstacle runs of a bool[d, d] canvas -> (starts, ends,
    max runs in any row, total runs dropped by the k cap). Scatter by
    per-row run rank; rank >= k drops."""
    d = rot.shape[0]
    vcol = jax.lax.broadcasted_iota(jnp.int32, (d, d), 1)
    prev = jnp.pad(rot[:, :-1], ((0, 0), (1, 0)))
    nxt = jnp.pad(rot[:, 1:], ((0, 0), (0, 1)))
    rs = rot & ~prev  # run starts
    re = rot & ~nxt  # run ends
    rank_s = jnp.cumsum(rs, axis=1) - 1
    rank_e = jnp.cumsum(re, axis=1) - 1
    rows = jax.lax.broadcasted_iota(jnp.int32, (d, d), 0)

    def scatter(mask, rank):
        flat_idx = jnp.where(mask & (rank < k), rows * k + rank, d * k)
        out = jnp.full((d * k + 1,), _PAD, jnp.int32)
        out = out.at[flat_idx.reshape(-1)].min(
            jnp.where(mask, vcol, _PAD).reshape(-1), mode="drop"
        )
        return out[:-1].reshape(d, k)

    starts = scatter(rs, rank_s)
    ends = scatter(re, rank_e)
    runs_per_row = jnp.sum(rs, axis=1)
    n_max = jnp.max(runs_per_row)
    n_dropped = jnp.sum(jnp.maximum(runs_per_row - k, 0))
    return starts, ends, n_max, n_dropped


def _bin_intervals(blocked, dil, theta, d: int, k: int):
    # `dil` precomputed once by the caller (one dilation per build, not
    # per bin).
    rot = lutlib.rotated_blocked_canvas(blocked, theta, d, dil)
    return _row_intervals(rot, k)


_bin_intervals_jit = jax.jit(_bin_intervals, static_argnums=(3, 4))


def build_cddt(
    blocked: jax.Array, n_bins: int = 360, k: int | None = None
) -> CDDTTable:
    """Host-side offline build: n_bins//2 rotated canvases -> interval
    tables. `k` (max runs per row) defaults to adaptive: one pass with a
    generous guess, trimmed to the measured maximum (rebuilt with the true
    k in the rare case the guess was low)."""
    if n_bins % 2 != 0:
        raise ValueError("cddt needs an even n_bins (half-table sharing)")
    blocked = jnp.asarray(blocked, bool)
    h, w = blocked.shape
    d = int(math.ceil(math.hypot(h, w))) + 2
    if d >= _PAD:
        raise ValueError(
            f"map diagonal {d} overflows the i16 interval coordinates "
            f"(max {_PAD - 1}); cddt tables currently support maps up to "
            "~23k px on a side"
        )
    half = n_bins // 2
    binw = 2.0 * math.pi / n_bins
    dil = lutlib.dilate2x2(blocked)

    adaptive = k is None

    def one_pass(k_try: int):
        starts_np = np.empty((half, d, k_try), np.int16)
        ends_np = np.empty((half, d, k_try), np.int16)
        kmax = 0
        dropped = 0
        for b in range(half):
            s, e, n, nd = _bin_intervals_jit(
                blocked, dil, jnp.float32(b * binw), d, k_try
            )
            kmax = max(kmax, int(n))
            dropped += int(nd)
            starts_np[b] = np.asarray(jax.device_get(s), np.int16)
            ends_np[b] = np.asarray(jax.device_get(e), np.int16)
        return starts_np, ends_np, kmax, dropped

    k_try = 64 if adaptive else k
    starts_np, ends_np, kmax, dropped = one_pass(k_try)
    if adaptive and kmax > k_try:
        # Guess was low: one rebuild at the measured maximum.
        starts_np, ends_np, kmax, dropped = one_pass(kmax)
    if adaptive:
        kfit = max(kmax, 1)
        starts_np = starts_np[:, :, :kfit]
        ends_np = ends_np[:, :, :kfit]
        dropped = 0
    return CDDTTable(
        starts=jnp.asarray(np.ascontiguousarray(starts_np)),
        ends=jnp.asarray(np.ascontiguousarray(ends_np)),
        n_bins=n_bins,
        n_overflow=dropped,
    )


def raycast_cddt(
    table: CDDTTable, x, y, theta, *, max_dist: float = 500.0, shape=None
):
    """(dist, hit) with the march/lut conventions. `shape` is the (H, W)
    of the source map (needed for the cell snap; defaults to deriving
    nothing — pass it, MCL paths always know it)."""
    if shape is None:
        raise ValueError("raycast_cddt needs the source map shape")
    h, w = shape
    d = table.d
    k = table.k
    n_bins = table.n_bins
    half = n_bins // 2
    if max_dist * 1.25 >= _PAD - d:
        # PAD-as-miss relies on PAD - v > cap for every canvas coordinate.
        raise ValueError(
            f"max_dist {max_dist} too large for this table's i16 headroom "
            f"(needs max_dist * 1.25 < {_PAD - d})"
        )
    cap = jnp.float32(max_dist * 1.25)
    ci, cj, cd = (h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0

    x, y, theta = jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(theta, jnp.float32),
    )
    b = lutlib.angle_bin(theta, n_bins)
    fwd = b < half
    bh = jnp.where(fwd, b, b - half)

    i, j = gridlib.world_to_cell((h, w), x, y)
    inb = gridlib.in_bounds((h, w), i, j)
    ic, jc = gridlib.clamp_cell((h, w), i, j)

    th = bh.astype(jnp.float32) * (2.0 * jnp.pi / n_bins)
    di = -jnp.sin(th)
    dj = jnp.cos(th)
    ii = ic.astype(jnp.float32) - ci
    jj = jc.astype(jnp.float32) - cj
    u_q = ii * dj + jj * (-di) + cd
    v_q = ii * di + jj * dj + cd
    ui = jnp.clip(jnp.round(u_q).astype(jnp.int32), 0, d - 1)
    vi = jnp.clip(jnp.round(v_q).astype(jnp.int32), 0, d - 1)

    row = bh * d + ui  # [..., ] row into the [half*d, K] tables
    starts = table.starts.reshape(-1, k)
    ends = table.ends.reshape(-1, k)
    v = vi.astype(jnp.int32)

    # Forward (+v): first run with end >= v -> dist = max(start - v, 0).
    # Backward (-v): last run with start <= v -> dist = max(v - end, 0).
    if k <= 64:
        # K-wide scan: ONE contiguous row gather per direction per ray
        # (2K i16 = tens of bytes from a table ~50x smaller than dense)
        # plus a vectorized masked min — no dependent-gather chain. Runs
        # are disjoint and sorted, so the min over eligible runs IS the
        # first eligible run's distance.
        s_rows = starts[row].astype(jnp.int32)  # [..., K]
        e_rows = ends[row].astype(jnp.int32)
        vk = v[..., None]
        df = jnp.where(
            e_rows >= vk, jnp.maximum(s_rows - vk, 0), jnp.int32(_PAD)
        )
        db = jnp.where(
            s_rows <= vk, jnp.maximum(vk - e_rows, 0), jnp.int32(_PAD)
        )
        dist = jnp.minimum(
            jnp.where(fwd, jnp.min(df, axis=-1), jnp.min(db, axis=-1)).astype(
                jnp.float32
            ),
            cap,
        )
    else:
        # Large-K fallback: fixed-trip fused binary search —
        # lower_bound(ends, v) forward, upper_bound(starts, v) backward.
        lo = jnp.zeros_like(v)
        hi = jnp.full_like(v, k)

        def body(_, lohi):
            lo, hi = lohi
            live = lo < hi
            mid = (lo + hi) // 2
            flat = row * k + jnp.clip(mid, 0, k - 1)
            ke = ends.reshape(-1)[flat].astype(jnp.int32)
            ks = starts.reshape(-1)[flat].astype(jnp.int32)
            kv = jnp.where(fwd, ke, ks)
            go_right = jnp.where(fwd, kv < v, kv <= v)
            lo = jnp.where(live & go_right, mid + 1, lo)
            hi = jnp.where(live & ~go_right, mid, hi)
            return lo, hi

        steps = max(1, int(math.ceil(math.log2(k + 1))))
        lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))

        idx_f = jnp.clip(lo, 0, k - 1)
        idx_b = jnp.clip(lo - 1, 0, k - 1)
        s_f = starts.reshape(-1)[row * k + idx_f].astype(jnp.float32)
        e_b = ends.reshape(-1)[row * k + idx_b].astype(jnp.float32)
        # lo == k forward (every real run's end < v): no run ahead. PAD
        # starts (short rows) also read as misses via the cap.
        dist_f = jnp.where(lo >= k, cap, jnp.maximum(s_f - v, 0.0))
        dist_b = jnp.where(lo >= 1, jnp.maximum(v - e_b, 0.0), cap)
        dist = jnp.minimum(jnp.where(fwd, dist_f, dist_b), cap)

    hit = (dist < max_dist) & inb
    return jnp.where(hit, dist, max_dist), hit
