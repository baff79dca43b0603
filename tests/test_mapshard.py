"""Map-block sharding tests (SURVEY section 7 item 8): the row-block-sharded
grid raycast/mapping must match the replicated path exactly, and the
map-sharded SLAM engine must match the single-device engine numerically."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.core.config import (
    LidarConfig,
    MapConfig,
    MCLConfig,
    MotionConfig,
    RaycastConfig,
    SLAMConfig,
)
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar, slam as slam_mod
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.ops.raycast import raycast_march
from slam_tpu.parallel import make_mesh
from slam_tpu.parallel.mapshard import (
    MapShardedGridSLAM,
    grid_sharding,
    raycast_march_sharded,
    scan_logodds_update_sharded,
)

H = W = 64
N = 64


def test_block_sharded_march_matches_replicated(rng):
    blocked = jnp.asarray(synthetic_room(H, W))
    mesh = make_mesh(8, beam_axis=4)  # 'b' axis = 4 row blocks
    n = 256
    xs = jnp.asarray(rng.uniform(-4, W + 4, n), jnp.float32)
    ys = jnp.asarray(rng.uniform(-4, H + 4, n), jnp.float32)
    ths = jnp.asarray(rng.uniform(-7, 7, n), jnp.float32)

    d0, h0 = raycast_march(blocked, xs, ys, ths, step=0.7, max_dist=90.0)
    blocked_sh = jax.device_put(blocked, grid_sharding(mesh))
    d1, h1 = raycast_march_sharded(
        mesh, blocked_sh, xs, ys, ths, step=0.7, max_dist=90.0
    )
    np.testing.assert_array_equal(np.asarray(h0), np.asarray(h1))
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), rtol=1e-6)


def test_row_window_march_composes():
    """The op-level contract: min over row-block marches == full march."""
    blocked = jnp.asarray(synthetic_room(H, W))
    xs = jnp.asarray([10.0, 30.0, 50.0], jnp.float32)
    ys = jnp.asarray([10.0, 30.0, 50.0], jnp.float32)
    ths = jnp.asarray([0.3, 2.0, -1.7], jnp.float32)
    d0, h0 = raycast_march(blocked, xs, ys, ths, step=0.5, max_dist=80.0)
    lh = H // 4
    dmin = jnp.full_like(d0, 80.0)
    for b in range(4):
        d, hh = raycast_march(
            blocked[b * lh : (b + 1) * lh],
            xs,
            ys,
            ths,
            step=0.5,
            max_dist=80.0,
            row_offset=b * lh,
            full_h=H,
        )
        dmin = jnp.minimum(dmin, jnp.where(hh, d, 80.0))
    np.testing.assert_allclose(
        np.asarray(jnp.where(h0, d0, 80.0)), np.asarray(dmin), rtol=1e-6
    )


def _cfg():
    return SLAMConfig(
        mcl=MCLConfig(n_particles=N, meas_stddev=3.0),
        map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=60.0),
        motion=MotionConfig(alphas=(1e-3, 1e-3, 1e-3, 1e-3)),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, chunk=16),
    )


def test_sharded_mapping_scatter_matches():
    from slam_tpu.ops import mapping

    cfg = _cfg()
    mesh = make_mesh(8, beam_axis=4)
    blocked = jnp.asarray(synthetic_room(H, W))
    pose = Pose.create(30.0, 30.0, 0.8)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    grid = jnp.zeros((H, W), jnp.float32)

    ref = mapping.scan_logodds_update(
        grid,
        pose,
        scan,
        scanner_offset=cfg.mcl.scanner_offset,
        step=cfg.raycast.step,
        max_dist=cfg.raycast.max_dist,
        l_occ=cfg.map.l_occ,
        l_free=cfg.map.l_free,
        l_min=cfg.map.l_min,
        l_max=cfg.map.l_max,
    )
    grid_sh = jax.device_put(grid, grid_sharding(mesh))
    got = scan_logodds_update_sharded(mesh, grid_sh, pose, scan, cfg=cfg)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got), atol=1e-6)


def test_map_sharded_slam_matches_single_device():
    cfg = _cfg()
    blocked = jnp.asarray(synthetic_room(H, W))
    pose = Pose.create(W / 2.0, H / 2.0, np.pi / 2)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    odom = Odometry.create(0.05, 1.5, 0.05)

    # Single-device reference (march backend = what the sharded path uses).
    engine0 = slam_mod.GridSLAM(cfg, seed=0)
    st0 = engine0.init(pose)
    for _ in range(2):
        st0 = engine0.step(st0, odom, scan)

    mesh = make_mesh(8, beam_axis=4)
    engine = MapShardedGridSLAM(mesh, cfg)
    st = engine.init(pose, seed=0)
    for _ in range(2):
        st = engine.step(st, odom, scan)
    jax.block_until_ready(st)

    np.testing.assert_allclose(
        np.asarray(st.grid), np.asarray(st0.grid), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.mcl.particles.pose.x),
        np.asarray(st0.mcl.particles.pose.x),
        rtol=1e-4,
    )
    # The grid really is sharded in row blocks.
    assert st.grid.sharding.shard_shape((H, W))[0] == H // 4


def test_map_sharded_rejects_scanmatch():
    """MapShardedGridSLAM must reject SLAMConfig.scanmatch loudly (the
    refinement needs a replicated full-map EDT — exactly what map-block
    sharding avoids), not silently pin est_pose to the best particle
    while the particle-sharded engine honors the same config."""
    import pytest as _pytest

    from slam_tpu.core.config import ScanMatchConfig
    from slam_tpu.parallel import make_mesh
    from slam_tpu.parallel.mapshard import MapShardedGridSLAM

    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=16),
        map=MapConfig(height=64, width=64),
        scanmatch=ScanMatchConfig(),
    )
    mesh = make_mesh(8, beam_axis=2)
    with _pytest.raises(ValueError, match="scanmatch"):
        MapShardedGridSLAM(mesh, cfg)


def test_sharded_jfa_matches_replicated(rng):
    """Round 5: the halo-exchange distributed capped JFA is BITWISE equal
    to the replicated transform, including map-edge blocks and the no-seed
    sentinel."""
    from slam_tpu.ops.edt import edt_jfa
    from slam_tpu.parallel.edt import edt_jfa_sharded

    mesh = make_mesh(8, beam_axis=4)
    for density, cap in ((0.03, 7.0), (0.2, 12.0), (0.0, 7.0)):
        blocked = jnp.asarray(rng.random((96, 80)) < density)
        want = edt_jfa(blocked, max_dist=cap)
        blocked_sh = jax.device_put(blocked, grid_sharding(mesh))
        got = edt_jfa_sharded(mesh, blocked_sh, max_dist=cap)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(want),
            err_msg=f"density={density} cap={cap}",
        )


def test_sharded_jfa_rejects_oversized_step():
    from slam_tpu.parallel.edt import edt_jfa_sharded

    mesh = make_mesh(8, beam_axis=8)  # 8 row blocks of 8 rows each
    blocked = jax.device_put(
        jnp.zeros((64, 64), bool), grid_sharding(mesh)
    )
    with pytest.raises(ValueError, match="block height"):
        edt_jfa_sharded(mesh, blocked, max_dist=30.0)


def test_sharded_lf_window_matches_replicated_box_build(rng):
    """lf_window_sharded assembles the padded score window the replicated
    box build materializes (`lf_score_table` origin branch) — bitwise,
    including the out-of-map floor ring."""
    import math

    from slam_tpu.ops.edt import edt_jfa
    from slam_tpu.ops.measurement import lf_log_score_field
    from slam_tpu.parallel.edt import lf_window_sharded

    mesh = make_mesh(8, beam_axis=4)
    h, w = 96, 80
    blocked = jnp.asarray(rng.random((h, w)) < 0.05)
    cap, stddev, z_hit, z_rand, max_dist = 12.0, 2.0, 0.95, 0.05, 30.0
    edt = edt_jfa(blocked, max_dist=cap)
    pad = int(math.ceil(max_dist)) + 1
    si = sj = 24
    i0, j0 = 5, 60  # box partially padding out of the map on the right
    # Replicated reference: the origin-branch window math.
    floor_val = float(math.log(max(z_rand / max_dist, 1e-30)))
    L = lf_log_score_field(
        edt, stddev=stddev, z_hit=z_hit, z_rand=z_rand, max_dist=max_dist
    )
    rows = i0 - pad + np.arange(si + 2 * pad)
    cols = j0 - pad + np.arange(sj + 2 * pad)
    in_i = (rows >= 0) & (rows < h)
    in_j = (cols >= 0) & (cols < w)
    core = np.asarray(L)[np.clip(rows, 0, h - 1)][:, np.clip(cols, 0, w - 1)]
    want = np.where(in_i[:, None] & in_j[None, :], core, floor_val)

    edt_sh = jax.device_put(edt, grid_sharding(mesh))
    got = lf_window_sharded(
        mesh, edt_sh, i0 - pad, j0 - pad,
        out_shape=(si + 2 * pad, sj + 2 * pad),
        stddev=stddev, z_hit=z_hit, z_rand=z_rand, max_dist=max_dist,
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_sharded_direct_lf_matches_replicated(rng):
    from slam_tpu.ops.edt import edt_jfa
    from slam_tpu.ops.measurement import (
        particle_log_weights_likelihood_field,
    )
    from slam_tpu.ops.rayfield import RayField
    from slam_tpu.parallel.edt import lf_log_weights_sharded

    cfg = _cfg()
    mesh = make_mesh(8, beam_axis=4)
    blocked = jnp.asarray(synthetic_room(H, W))
    cap = 5.0 * cfg.mcl.meas_stddev + 2.0
    edt = edt_jfa(blocked, max_dist=cap)
    pose = Pose.create(30.0, 30.0, 0.8)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    n = 32
    poses = Pose.create(
        jnp.asarray(rng.uniform(-5, W + 5, n), jnp.float32),
        jnp.asarray(rng.uniform(-5, H + 5, n), jnp.float32),
        jnp.asarray(rng.uniform(-4, 4, n), jnp.float32),
    )
    want = particle_log_weights_likelihood_field(
        RayField(blocked=blocked, edt=edt),
        poses,
        scan,
        rc=cfg.raycast,
        scanner_offset=cfg.mcl.scanner_offset,
        stddev=cfg.mcl.meas_stddev,
    )
    edt_sh = jax.device_put(edt, grid_sharding(mesh))
    got = lf_log_weights_sharded(
        mesh, edt_sh, poses, scan,
        rc=cfg.raycast,
        scanner_offset=cfg.mcl.scanner_offset,
        stddev=cfg.mcl.meas_stddev,
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-6
    )


@pytest.mark.parametrize(
    "measurement,box",
    [("likelihood_field", None), ("likelihood_field_table", 32)],
)
def test_map_sharded_slam_lf_tiers_match_single_device(measurement, box):
    """MapShardedGridSLAM with the
    likelihood-field tiers — distributed JFA + sharded endpoint gathers /
    boxed table from the psum-assembled window — matches the replicated
    engine's numerics on the 8-device mesh."""
    import dataclasses as dc

    # 128 rows so the 4-row-block mesh keeps blocks >= the capped
    # transform's C+1 = 18-row halo at cap = 5*stddev+2 = 17 (validated
    # in edt_capped_sharded).
    hh = ww = 128
    cfg = _cfg()
    cfg = dc.replace(
        cfg,
        mcl=dc.replace(
            cfg.mcl, measurement=measurement, lf_table_box=box
        ),
        map=MapConfig(height=hh, width=ww),
        raycast=dc.replace(cfg.raycast, backend="sdf"),
    )
    blocked = jnp.asarray(synthetic_room(hh, ww))
    pose = Pose.create(ww / 2.0, hh / 2.0, np.pi / 2)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    odom = Odometry.create(0.05, 1.5, 0.05)

    engine0 = slam_mod.GridSLAM(cfg, seed=0)
    st0 = engine0.init(pose)
    for _ in range(3):
        st0 = engine0.step(st0, odom, scan)

    mesh = make_mesh(8, beam_axis=4)
    engine = MapShardedGridSLAM(mesh, cfg)
    st = engine.init(pose, seed=0)
    for _ in range(3):
        st = engine.step(st, odom, scan)
    jax.block_until_ready(st)

    np.testing.assert_allclose(
        np.asarray(st.grid), np.asarray(st0.grid), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.mcl.particles.pose.x),
        np.asarray(st0.mcl.particles.pose.x),
        rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(st.mcl.particles.log_weight),
        np.asarray(st0.mcl.particles.log_weight),
        rtol=1e-4, atol=1e-4,
    )
    assert st.grid.sharding.shard_shape((hh, ww))[0] == hh // 4


def test_map_sharded_table_requires_box():
    import dataclasses as dc

    cfg = _cfg()
    cfg = dc.replace(
        cfg, mcl=dc.replace(cfg.mcl, measurement="likelihood_field_table")
    )
    mesh = make_mesh(8, beam_axis=4)
    with pytest.raises(ValueError, match="lf_table_box"):
        MapShardedGridSLAM(mesh, cfg)


def test_sharded_edt_capped_matches_replicated(rng):
    """Round 5: the sharded separable capped EDT (one blocked-mask halo
    exchange) is BITWISE equal to the replicated `edt_capped`."""
    from slam_tpu.ops.edt import edt_capped
    from slam_tpu.parallel.edt import edt_capped_sharded

    mesh = make_mesh(8, beam_axis=4)
    for density, cap in ((0.03, 7.0), (0.2, 12.0), (0.0, 7.0)):
        blocked = jnp.asarray(rng.random((96, 80)) < density)
        want = edt_capped(blocked, cap)
        blocked_sh = jax.device_put(blocked, grid_sharding(mesh))
        got = edt_capped_sharded(mesh, blocked_sh, max_dist=cap)
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(want),
            err_msg=f"density={density} cap={cap}",
        )


def test_sharded_edt_capped_rejects_small_blocks():
    from slam_tpu.parallel.edt import edt_capped_sharded

    mesh = make_mesh(8, beam_axis=8)  # blocks of 8 rows
    blocked = jax.device_put(jnp.zeros((64, 64), bool), grid_sharding(mesh))
    with pytest.raises(ValueError, match="block height"):
        edt_capped_sharded(mesh, blocked, max_dist=30.0)
