"""Map-block sharding: the occupancy grid distributed over a mesh axis.

SURVEY section 7 item 8: for maps that outgrow per-device replication
(maze-scale grids x their derived tables), the log-odds grid is sharded in
ROW BLOCKS over the mesh's 'b' axis while particles stay sharded over 'p'.

The decomposition needs NO halo exchange: a ray's true first hit is the
minimum over blocks of its per-block first hit (cells outside a block read
as free — `slam_tpu.ops.raycast.raycast_march`'s row-window mode), so the
block-sharded raycast is one local march + a `pmin` over 'b'. Mapping
scatters compose the same way: each block applies the updates that land in
its rows (`scan_logodds_update` row-window mode) and the blocks never
communicate. Exactness is tested against the replicated path in
tests/test_mapshard.py.

Trade-off vs replication: each device marches every ray to completion
against its own block (no cross-block early exit), so total compute rises
while per-device MAP MEMORY falls by the block factor — the right trade
precisely when the map doesn't fit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_tpu.core import grid as gridlib
from slam_tpu.core.config import SLAMConfig
from slam_tpu.core.types import Odometry, Pose, Scan
from slam_tpu.models import mcl as mcl_mod
from slam_tpu.models import slam as slam_mod
from slam_tpu.ops import mapping
from slam_tpu.ops.measurement import beam_log_weights, sensor_pose
from slam_tpu.ops.raycast import raycast_march
from slam_tpu.parallel import sharded as sharded_mod


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """[H, W] grids sharded in row blocks over the 'b' axis."""
    return NamedSharding(mesh, P("b", None))


def raycast_march_sharded(
    mesh: Mesh,
    blocked: jax.Array,
    x,
    y,
    theta,
    *,
    step: float,
    max_dist: float,
    chunk: int = 64,
    map_axis: str = "b",
):
    """Exact march against a row-block-sharded map: local block march +
    min-combine over the map axis. Ray batches are sharded over 'p' and
    replicated over 'b' (every block sees every ray)."""
    h, w = blocked.shape
    d = mesh.shape[map_axis]
    if h % d != 0:
        raise ValueError(f"map rows {h} not divisible by '{map_axis}'={d}")
    lh = h // d

    def local(blk, x, y, th):
        s = jax.lax.axis_index(map_axis)
        dist, hit = raycast_march(
            blk,
            x,
            y,
            th,
            step=step,
            max_dist=max_dist,
            chunk=chunk,
            row_offset=s * lh,
            full_h=h,
        )
        cand = jnp.where(hit, dist, jnp.float32(max_dist))
        dmin = jax.lax.pmin(cand, map_axis)
        return dmin, dmin < max_dist

    ray_spec = P("p", *([None] * (jnp.ndim(x) - 1)))
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(map_axis, None), ray_spec, ray_spec, ray_spec),
        out_specs=(ray_spec, ray_spec),
        check_vma=False,
    )(blocked, x, y, theta)


def scan_logodds_update_sharded(
    mesh: Mesh,
    grid_l: jax.Array,
    pose: Pose,
    scan: Scan,
    *,
    cfg: SLAMConfig,
    map_axis: str = "b",
):
    """Mapping scatter on the sharded grid: every block applies its own
    rows' updates; no communication."""
    h, w = grid_l.shape
    d = mesh.shape[map_axis]
    lh = h // d

    def local(blk, px, py, pth, dists, angles):
        s = jax.lax.axis_index(map_axis)
        return mapping.scan_logodds_update(
            blk,
            Pose(x=px, y=py, theta=pth),
            Scan(angles=angles, dists=dists),
            scanner_offset=cfg.mcl.scanner_offset,
            step=cfg.raycast.step,
            max_dist=cfg.raycast.max_dist,
            l_occ=cfg.map.l_occ,
            l_free=cfg.map.l_free,
            l_min=cfg.map.l_min,
            l_max=cfg.map.l_max,
            row_offset=s * lh,
            full_h=h,
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(map_axis, None), P(), P(), P(), P(), P()),
        out_specs=P(map_axis, None),
        check_vma=False,
    )(grid_l, pose.x, pose.y, pose.theta, scan.dists, scan.angles)


class MapShardedGridSLAM:
    """Full grid SLAM with the log-odds grid row-block-sharded over 'b' and
    particles sharded over 'p'. Same pure step functions as the replicated
    engines; block-sharded measurement models replace the replicated ones
    and the block-local scatter replaces the map update.

    Measurement tiers (round 5 — SURVEY section 7.8 completed for dynamic
    maps): ``beam`` marches rays per block (halo-free min-combine);
    ``likelihood_field`` and ``likelihood_field_table`` (with the
    mandatory ``lf_table_box``) run against a DISTRIBUTED capped-JFA EDT
    (`slam_tpu.parallel.edt`): each block iterates the shifted-min passes
    with per-pass row halos from its neighbors (ppermute), so maps beyond
    one device's memory get the fast measurement tiers without any device materializing
    a full-map array. Numerics match the replicated engine bitwise up to
    psum single-contribution sums (equivalence-tested in
    tests/test_mapshard.py)."""

    def __init__(self, mesh: Mesh, cfg: SLAMConfig):
        if cfg.scanmatch is not None:
            # The correlative refinement needs a replicated likelihood-field
            # EDT of the WHOLE map — exactly the per-device map footprint
            # this engine exists to avoid. Reject loudly instead of silently
            # pinning est_pose to the best particle (the particle-sharded
            # engine honors cfg.scanmatch; same config must not silently
            # behave differently per engine).
            raise ValueError(
                "MapShardedGridSLAM does not support SLAMConfig.scanmatch: "
                "the refinement requires a replicated full-map EDT, which "
                "defeats map-block sharding. Use ShardedGridSLAM (particle "
                "sharding) for scan-matched estimates, or unset scanmatch."
            )
        meas = cfg.mcl.measurement
        if meas == "likelihood_field_auto":
            raise ValueError(
                "MapShardedGridSLAM does not support "
                "measurement='likelihood_field_auto': pick "
                "'likelihood_field' (dispersed clouds) or "
                "'likelihood_field_table' (tracking) explicitly."
            )
        if meas == "likelihood_field_table" and cfg.mcl.lf_table_box is None:
            raise ValueError(
                "MapShardedGridSLAM's table tier requires "
                "MCLConfig.lf_table_box: the dense full-map table would "
                "materialize a [T, H, W] array per device — exactly the "
                "footprint map-block sharding exists to avoid."
            )
        if cfg.edt_box is not None:
            # Silently ignoring the knob would (a) let init() build a
            # full-map REPLICATED EDT cache on one device — the exact
            # footprint this engine avoids — only to discard it, and (b)
            # leave the user without the speedup they configured. The
            # sharded step rebuilds its distributed capped EDT per frame;
            # an incremental sharded refresh is future work.
            raise ValueError(
                "MapShardedGridSLAM does not support SLAMConfig.edt_box "
                "(the incremental EDT cache is replicated state). Unset "
                "edt_box, or use ShardedGridSLAM (particle sharding) for "
                "the incremental refresh."
            )
        self.mesh = mesh
        self.cfg = cfg
        rfn = sharded_mod._resample_fn(mesh, cfg.mcl)
        lf_meas = meas in ("likelihood_field", "likelihood_field_table")

        def measurement_march(grid_l, poses, scan):
            blocked = gridlib.blocked_from_logodds(grid_l)
            sp = sensor_pose(poses, cfg.mcl.scanner_offset)
            angles = sp.theta[:, None] + scan.angles[None, :]
            px = jnp.broadcast_to(sp.x[:, None], angles.shape)
            py = jnp.broadcast_to(sp.y[:, None], angles.shape)
            dist, hit = raycast_march_sharded(
                mesh,
                blocked,
                px,
                py,
                angles,
                step=cfg.raycast.step,
                max_dist=cfg.raycast.max_dist,
                chunk=cfg.raycast.chunk,
            )
            lw = beam_log_weights(
                dist,
                hit,
                scan.dists[None, :],
                stddev=cfg.mcl.meas_stddev,
                max_dist=cfg.raycast.max_dist,
                eps=cfg.mcl.meas_epsilon,
            )
            return jnp.sum(lw, axis=-1)

        def measurement_lf(grid_l, poses, scan):
            import math as _math

            from slam_tpu.ops import measurement as meas_ops
            from slam_tpu.parallel import edt as dist_edt

            h, w = grid_l.shape
            blocked = gridlib.blocked_from_logodds(grid_l)
            cap = 5.0 * cfg.mcl.meas_stddev + 2.0
            edt = dist_edt.edt_capped_sharded(mesh, blocked, max_dist=cap)
            if meas == "likelihood_field":
                return dist_edt.lf_log_weights_sharded(
                    mesh,
                    edt,
                    poses,
                    scan,
                    rc=cfg.raycast,
                    scanner_offset=cfg.mcl.scanner_offset,
                    stddev=cfg.mcl.meas_stddev,
                    z_hit=cfg.mcl.lf_z_hit,
                    z_rand=cfg.mcl.lf_z_rand,
                )
            # Boxed-table tier: the heading window / box center are the
            # SHARED reduction-only helper (GSPMD psums them over 'p'
            # like the replicated engine — one source of truth for the
            # window formulas); the padded score WINDOW — (box + 2 pad)^2,
            # a few MB regardless of map size — is assembled from the
            # sharded EDT by one psum over 'b'; the table build and the
            # per-particle lookup then reuse the replicated code paths
            # verbatim.
            m = cfg.mcl
            mu, binw, halfwidth, headings, i0, j0, si, sj = (
                meas_ops.lf_table_window(
                    poses,
                    grid_shape=(h, w),
                    scanner_offset=m.scanner_offset,
                    table_bins=m.lf_table_bins,
                    spread_mult=m.lf_table_spread,
                    min_halfwidth=m.lf_table_min_halfwidth,
                    box_size=m.lf_table_box,
                )
            )
            pad = int(_math.ceil(cfg.raycast.max_dist)) + 1
            window = dist_edt.lf_window_sharded(
                mesh,
                edt,
                i0 - pad,
                j0 - pad,
                out_shape=(si + 2 * pad, sj + 2 * pad),
                stddev=m.meas_stddev,
                z_hit=m.lf_z_hit,
                z_rand=m.lf_z_rand,
                max_dist=cfg.raycast.max_dist,
            )
            table = meas_ops.lf_score_table(
                edt,
                scan,
                headings,
                rc=cfg.raycast,
                stddev=m.meas_stddev,
                z_hit=m.lf_z_hit,
                z_rand=m.lf_z_rand,
                dtype=m.lf_table_dtype,
                out_shape=(si, sj),
                lpad=window,
            )
            tbl = jnp.moveaxis(table, 0, -1)
            prep = (tbl, mu, binw, halfwidth, i0, j0)
            return meas_ops.lf_table_lookup(
                prep,
                poses,
                scan,
                rc=cfg.raycast,
                scanner_offset=m.scanner_offset,
                z_rand=m.lf_z_rand,
                grid_shape=(h, w),
            )

        measurement = measurement_lf if lf_meas else measurement_march

        def step(state, odom, scan):
            st = mcl_mod.predict(state.mcl, odom, cfg.motion.alphas)
            st = mcl_mod.update(
                st,
                scan,
                None,
                cfg.mcl,
                cfg.raycast,
                resample_fn=rfn,
                measurement_fn=functools.partial(measurement, state.grid),
            )
            mp = slam_mod.resolve_map_pose(cfg)
            if mp == "mean":
                map_pose = mcl_mod.mean_pose(st)
            elif mp == "mode":
                map_pose = st.mode_pose
            else:
                map_pose = st.best_pose
            new_grid = scan_logodds_update_sharded(
                mesh, state.grid, map_pose, scan, cfg=cfg
            )
            # Same pre-increment phase as models/slam.py: st.updates is
            # post-increment, the first update must map.
            do_map = ((st.updates - 1) % cfg.map_every) == 0
            new_grid = jnp.where(do_map, new_grid, state.grid)
            return slam_mod.SLAMState(
                mcl=st, grid=new_grid, est_pose=st.best_pose
            )

        self._step = jax.jit(step)
        self._predict = jax.jit(
            lambda s, o: slam_mod.predict_only(s, o, cfg)
        )

    def init(self, pose: Pose | None = None, seed: int = 0) -> slam_mod.SLAMState:
        state = slam_mod.init(jax.random.key(seed), self.cfg, pose)
        # No incremental-EDT cache in this engine (edt_box is rejected in
        # __init__; the LF tiers rebuild the DISTRIBUTED capped EDT per
        # step) — keep the state pytree structure consistent from init.
        state = state.replace(edt=None)
        state = sharded_mod.shard_state(
            state, self.mesh, self.cfg.mcl.n_particles
        )
        return state.replace(
            grid=jax.device_put(state.grid, grid_sharding(self.mesh))
        )

    def step(self, state, odom: Odometry, scan: Scan):
        return self._step(state, odom, scan)

    def predict(self, state, odom: Odometry):
        return self._predict(state, odom)
