"""Sharded (multi-device) particle filter tests on the 8-device virtual CPU
mesh (see conftest.py). Checks (a) the SPMD program compiles and executes with
real 2D ('p', 'b') shardings, (b) outputs stay sharded on the particle axis,
and (c) sharded results match the single-device reference path numerically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_tpu.core.config import (
    LidarConfig,
    MapConfig,
    MCLConfig,
    RaycastConfig,
    SLAMConfig,
)
from slam_tpu.core.types import Odometry, Pose, Scan
from slam_tpu.models import fake_lidar, mcl as mcl_mod, slam as slam_mod
from slam_tpu.models.simulate import synthetic_room
from slam_tpu.parallel import ShardedGridSLAM, ShardedMCL, make_mesh


N = 64  # divisible by every mesh layout used below
H = W = 64


def _scene():
    blocked = jnp.asarray(synthetic_room(H, W))
    pose = Pose.create(W / 2.0, H / 2.0, np.pi / 2)
    lidar = LidarConfig(n_rays=16, max_dist=100.0)
    rc = RaycastConfig(max_dist=100.0, chunk=32)
    scan = fake_lidar.scan(blocked, pose, lidar, rc)
    return blocked, pose, scan, rc


@pytest.mark.parametrize("beam_axis", [1, 2])
def test_sharded_mcl_matches_single_device(beam_axis):
    blocked, pose, scan, rc = _scene()
    cfg = MCLConfig(n_particles=N, ess_threshold=0.0)  # no resample: exact cmp
    odom = Odometry.create(0.1, 2.0, 0.1)
    alphas = (1e-3, 1e-3, 1e-3, 1e-3)

    # Single-device reference.
    st0 = mcl_mod.init(jax.random.key(0), N, pose)
    st0 = mcl_mod.predict(st0, odom, jnp.asarray(alphas))
    st0 = mcl_mod.update(st0, scan, blocked, cfg, rc)

    mesh = make_mesh(8, beam_axis=beam_axis)
    m = ShardedMCL(mesh, cfg, rc)
    st = m.init(H, W)
    st = m.predict(st, odom, alphas)
    st = m.update(st, scan, blocked)

    np.testing.assert_allclose(
        np.asarray(st.particles.pose.x), np.asarray(st0.particles.pose.x), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.particles.log_weight),
        np.asarray(st0.particles.log_weight),
        rtol=1e-4,
        atol=1e-4,
    )
    # The particle axis must actually be sharded over 'p'.
    shard_shape = st.particles.pose.x.sharding.shard_shape((N,))
    assert shard_shape[0] == N * beam_axis // 8


def test_sharded_slam_step_runs_and_stays_sharded():
    blocked, pose, scan, _ = _scene()
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=N),
        map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, chunk=32),
    )
    mesh = make_mesh(8, beam_axis=2)
    engine = ShardedGridSLAM(mesh, cfg)
    state = engine.init(pose)
    odom = Odometry.create(0.0, 2.0, 0.0)
    for _ in range(2):
        state = engine.step(state, odom, scan)
    jax.block_until_ready(state)

    assert state.grid.shape == (H, W)
    # Map must have been updated away from all-unknown.
    assert float(jnp.abs(state.grid).sum()) > 0.0
    shard_shape = state.mcl.particles.pose.x.sharding.shard_shape((N,))
    assert shard_shape[0] == N // 4  # 4-way 'p' axis


@pytest.mark.parametrize("table_box", [None, 40])
def test_sharded_slam_lf_table_matches_single_device(table_box):
    """The correlative-table measurement (the 1M-step fast path) under the
    sharded engine: the heading-window circular stats — and, with
    lf_table_box, the box-center mean — reduce over the SHARDED particle
    axis (GSPMD psum) and must match the single-device numerics; the table
    itself is replicated."""
    blocked, pose, scan, _ = _scene()
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=N,
            measurement="likelihood_field_table",
            lf_table_box=table_box,
            ess_threshold=0.0,  # no resample: exact comparison
        ),
        map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, chunk=32, backend="sdf"),
    )
    odom = Odometry.create(0.05, 2.0, 0.05)

    st0 = slam_mod.init(jax.random.key(0), cfg, pose)
    st0 = slam_mod.step(st0, odom, scan, cfg)

    mesh = make_mesh(8, beam_axis=2)
    engine = ShardedGridSLAM(mesh, cfg)
    st1 = engine.init(pose)
    st1 = engine.step(st1, odom, scan)
    jax.block_until_ready(st1)

    np.testing.assert_allclose(
        np.asarray(st0.mcl.particles.log_weight),
        np.asarray(st1.mcl.particles.log_weight),
        rtol=1e-4,
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(st0.grid), np.asarray(st1.grid), rtol=1e-4, atol=1e-5
    )
    shard_shape = st1.mcl.particles.pose.x.sharding.shard_shape((N,))
    assert shard_shape[0] == N // 4


def test_sharded_auto_tier_matches_forced_table():
    """ShardedGridSLAM with measurement='likelihood_field_auto' (the
    host-lagged AutoTierDispatcher): a converged cloud steps bit-identically
    to the forced-table sharded engine — the dispatcher literally runs that
    jit — and the predicate's reductions psum over the sharded axis."""
    import dataclasses as dc

    blocked, pose, scan, _ = _scene()
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=N,
            measurement="likelihood_field_auto",
            lf_table_box=40,
            ess_threshold=0.0,
        ),
        map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, chunk=32, backend="sdf"),
    )
    odom = Odometry.create(0.05, 2.0, 0.05)
    mesh = make_mesh(8, beam_axis=2)

    auto = ShardedGridSLAM(mesh, cfg)
    st_a = auto.step(auto.init(pose), odom, scan)
    assert auto._auto.converged is True

    forced = ShardedGridSLAM(mesh, dc.replace(
        cfg, mcl=dc.replace(cfg.mcl, measurement="likelihood_field_table")
    ))
    st_f = forced.step(forced.init(pose), odom, scan)
    np.testing.assert_array_equal(
        np.asarray(st_a.mcl.particles.log_weight),
        np.asarray(st_f.mcl.particles.log_weight),
    )


def test_distributed_helpers_single_process():
    from slam_tpu.parallel import distributed

    assert not distributed.is_multihost()
    sl = distributed.host_local_slice(64)
    assert sl == slice(0, 64)
    tree = {"a": jnp.arange(3), "b": 1.5}
    out = distributed.replicate_to_all_hosts(tree)
    np.testing.assert_array_equal(np.asarray(out["a"]), [0, 1, 2])


class TestShardedResample:
    """Reduce-scatter systematic resampler (parallel/resample.py): selection
    must be index-exact vs the single-device path, including degenerate
    weight distributions that route every slot across shard boundaries."""

    def _check(self, mesh, log_w, key):
        from slam_tpu.core.types import Particles
        from slam_tpu.ops import resample as rs
        from slam_tpu.parallel.resample import systematic_resample_sharded

        n = log_w.shape[0]
        pose = Pose(
            x=jnp.arange(n, dtype=jnp.float32),
            y=jnp.arange(n, dtype=jnp.float32) * 2.0,
            theta=jnp.arange(n, dtype=jnp.float32) * 1e-3,
        )
        p = Particles(pose=pose, log_weight=log_w)
        ref = rs.resample(key, p, "systematic")
        got = systematic_resample_sharded(mesh, key, p)
        for fld in ("x", "y", "theta"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got.pose, fld)),
                np.asarray(getattr(ref.pose, fld)),
            )
        # Output must still be sharded over 'p'.
        assert got.pose.x.sharding.shard_shape((n,))[0] < n

    @pytest.mark.parametrize("beam_axis", [1, 2])
    def test_exact_match(self, beam_axis):
        mesh = make_mesh(8, beam_axis=beam_axis)
        key = jax.random.key(5)
        n = 512
        self._check(mesh, jax.random.normal(jax.random.key(1), (n,)) * 6.0, key)

    def test_degenerate_weights(self):
        mesh = make_mesh(8, beam_axis=1)
        key = jax.random.key(9)
        n = 512
        for lw in (
            jnp.full((n,), -50.0).at[300].set(10.0),  # all mass on one
            jnp.full((n,), -50.0).at[0].set(10.0),
            jnp.full((n,), -50.0).at[n - 1].set(10.0),
            jnp.zeros((n,)),
            jnp.where(jnp.arange(n) >= n - 64, 0.0, -40.0),  # last shard only
        ):
            self._check(mesh, lw, key)

    def test_update_hlo_has_no_large_all_gather(self):
        """The sharded MCL update compiles
        with NO [N]-sized all-gather — resampling exchanges state via
        reduce-scatter, best-pose extraction via masked psum; the only
        all-gathers left are [D]-sized shard reductions."""
        import re

        blocked, pose, scan, rc = _scene()
        n = 4096
        cfg = MCLConfig(n_particles=n)
        mesh = make_mesh(8, beam_axis=1)
        from slam_tpu.parallel import ShardedMCL as SM

        m = SM(mesh, cfg, rc)
        st = m.init(H, W)
        txt = m._update.lower(st, scan, blocked).compile().as_text()
        for line in txt.splitlines():
            mt = re.search(r"= \w+\[([\d,]*)\][^ ]* all-gather\(", line)
            if mt:
                dims = [int(d) for d in mt.group(1).split(",") if d]
                size = int(np.prod(dims)) if dims else 1
                assert size <= 8 * 16, f"large all-gather in HLO: {line[:160]}"


def test_sharded_mcl_with_lut_backend():
    """The LUT table rides along as a replicated array in the sharded path."""
    from slam_tpu.core.config import MCLConfig, RaycastConfig
    from slam_tpu.ops import rayfield

    blocked, pose, _, _ = _scene()
    rc = RaycastConfig(max_dist=100.0, backend="lut", lut_bins=64)
    field = rayfield.make_ray_field(blocked, rc)
    scan = fake_lidar.scan(
        blocked, pose, LidarConfig(n_rays=16, max_dist=100.0), RaycastConfig(max_dist=100.0)
    )
    cfg = MCLConfig(n_particles=N)
    mesh = make_mesh(8, beam_axis=2)
    m = ShardedMCL(mesh, cfg, rc)
    st = m.init(H, W)
    st = m.update(st, scan, field)
    jax.block_until_ready(st)
    assert st.particles.pose.x.sharding.shard_shape((N,))[0] == N // 4


def test_sharded_fleet_matches_unsharded():
    """Robots over the 'p' axis: sharded fleet == unsharded fleet exactly,
    outputs stay robot-sharded, and the step inserts no cross-robot
    collectives (the fleet axis is embarrassingly parallel)."""
    from slam_tpu.models import fleet as fleet_mod
    from slam_tpu.ops import rayfield
    from slam_tpu.parallel import ShardedMCLFleet

    blocked, _, _, rc = _scene()
    lidar = LidarConfig(n_rays=16, max_dist=100.0)
    cfg = MCLConfig(n_particles=32, meas_stddev=3.0)
    field = rayfield.make_ray_field(blocked, rc)
    alphas = (1e-3, 1e-3, 5e-3, 5e-3)
    r = 8
    poses = Pose.create(
        jnp.linspace(20.0, 44.0, r),
        jnp.linspace(20.0, 44.0, r),
        jnp.zeros((r,)),
    )
    from slam_tpu.ops.measurement import sensor_pose

    scans = [
        fake_lidar.scan(
            blocked,
            sensor_pose(
                Pose.create(poses.x[q], poses.y[q], poses.theta[q]),
                cfg.scanner_offset,
            ),
            lidar,
            rc,
        )
        for q in range(r)
    ]
    scans_b = jax.tree.map(lambda *z: jnp.stack(z), *scans)
    odoms_b = jax.tree.map(
        lambda *z: jnp.stack(z), *([Odometry.create(0.05, 1.0, 0.05)] * r)
    )

    mesh = make_mesh(8, beam_axis=1)
    sf = ShardedMCLFleet(mesh, r, cfg, rc, seed=3)
    st_s = sf.init(poses)
    for _ in range(2):
        st_s = sf.step(st_s, odoms_b, scans_b, field, alphas)
    jax.block_until_ready(st_s)

    fl = fleet_mod.MCLFleet(r, cfg, rc, seed=3)
    st_u = fl.init(poses)
    for _ in range(2):
        st_u = fl.step(st_u, odoms_b, scans_b, field, alphas)

    np.testing.assert_allclose(
        np.asarray(st_s.particles.pose.x),
        np.asarray(st_u.particles.pose.x),
        rtol=1e-5,
        atol=1e-4,
    )
    # Outputs stay sharded: each device holds r/8 robots.
    assert st_s.particles.pose.x.sharding.shard_shape((r, 32))[0] == 1

    # And the step moves no DATA between devices: the only collective GSPMD
    # inserts is a scalar pred[] all-reduce (control), never an array op.
    import re

    txt = (
        sf._step.lower(st_s, odoms_b, scans_b, field, jnp.asarray(alphas))
        .compile()
        .as_text()
    )
    for line in txt.splitlines():
        m = re.search(
            r"= (\S+) (?:all-reduce|all-gather|collective-permute|"
            r"all-to-all|reduce-scatter)\(",
            line,
        )
        if m:
            assert m.group(1).startswith("pred[]"), f"data collective: {line[:160]}"


def test_sharded_slam_scanmatch_matches_single_device():
    """SLAMConfig.scanmatch under the particle-sharded engine: the
    correlative refinement runs on the replicated grid/EDT after the
    sharded update, and `est_pose` must match the single-device engine."""
    blocked, pose, scan, _ = _scene()
    from slam_tpu.core.config import ScanMatchConfig

    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=N, ess_threshold=0.0),
        map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, chunk=32),
        scanmatch=ScanMatchConfig(),
    )
    odom = Odometry.create(0.05, 2.0, 0.05)

    st0 = slam_mod.init(jax.random.key(0), cfg, pose)
    st0 = slam_mod.step(st0, odom, scan, cfg)

    mesh = make_mesh(8, beam_axis=2)
    engine = ShardedGridSLAM(mesh, cfg)
    st1 = engine.init(pose)
    st1 = engine.step(st1, odom, scan)
    jax.block_until_ready(st1)

    # The refinement's argmax sits on a near-tied score surface here (all
    # particles share one seed pose), and the sharded psum's summation order
    # perturbs it by at most one candidate-grid quantum — compare to within
    # one translation cell / one theta sub-bin, not bitwise.
    tstep = 2 * cfg.scanmatch.theta_halfwidth / (cfg.scanmatch.theta_bins - 1)
    np.testing.assert_allclose(
        np.asarray(st0.est_pose.x), np.asarray(st1.est_pose.x), atol=1.0
    )
    np.testing.assert_allclose(
        np.asarray(st0.est_pose.y), np.asarray(st1.est_pose.y), atol=1.0
    )
    np.testing.assert_allclose(
        np.asarray(st0.est_pose.theta),
        np.asarray(st1.est_pose.theta),
        atol=tstep + 1e-5,
    )
    # The refined estimate must differ from the raw best particle in at
    # least one coordinate (the refinement actually ran), except in the
    # measure-zero case of a perfect seed.
    moved = any(
        abs(float(a) - float(b)) > 0
        for a, b in zip(jax.tree.leaves(st1.est_pose), jax.tree.leaves(st1.mcl.best_pose))
    )
    assert moved
    shard_shape = st1.mcl.particles.pose.x.sharding.shard_shape((N,))
    assert shard_shape[0] == N // 4


def test_sharded_state_checkpoint_roundtrip(tmp_path):
    """Orbax save/restore of a SHARDED SLAM state on the 8-device mesh —
    the production restore path. The restored state
    must match numerically AND come back sharded per the template."""
    blocked, pose, scan, _ = _scene()
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=N),
        map=MapConfig(height=H, width=W),
        lidar=LidarConfig(n_rays=16, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, chunk=32),
    )
    odom = Odometry.create(0.05, 2.0, 0.05)
    mesh = make_mesh(8, beam_axis=2)
    engine = ShardedGridSLAM(mesh, cfg)
    state = engine.init(pose)
    state = engine.step(state, odom, scan)
    jax.block_until_ready(state)

    from slam_tpu.utils import checkpoint as ckpt

    path = str(tmp_path / "sharded_slam")
    ckpt.save(path, state)
    template = engine.init(pose)  # fresh sharded state = structure template
    restored = ckpt.restore(path, template)

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        if hasattr(a, "dtype") and jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            a, b = jax.random.key_data(a), jax.random.key_data(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Particle leaves restore sharded over 'p' (not replicated on one device).
    shard_shape = restored.mcl.particles.pose.x.sharding.shard_shape((N,))
    assert shard_shape[0] == N // 4

    # One more step runs from the restored state (shardings are usable).
    out = engine.step(restored, odom, scan)
    jax.block_until_ready(out)


def test_sharded_kidnap_recovery_with_capped_injection():
    """The capped-injection + auto-tier kidnap
    scenario through ShardedMCL on the 8-device mesh — the injection's
    free-space sampling, the EMAs, the auto-tier predicate, and the
    mode_pose estimator all cross sharded reductions."""
    from slam_tpu.core.config import AdaptiveConfig
    from slam_tpu.models.simulate import synthetic_room as room
    from slam_tpu.ops import edt as edtlib, motion
    from slam_tpu.ops.rayfield import RayField

    h = w = 128
    blocked = jnp.asarray(room(h, w))
    rc = RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    lidar = LidarConfig(max_dist=60.0, n_rays=36)
    cfg = MCLConfig(
        n_particles=1024,
        meas_stddev=3.0,
        measurement="likelihood_field_auto",
        lf_table_box=48,
        adaptive=AdaptiveConfig(max_ratio=0.1),
    )
    mesh = make_mesh(8, beam_axis=2)
    m = ShardedMCL(mesh, cfg, rc)
    # Same scenario as the single-device e2e
    # (test_mcl.test_kidnap_recovery_with_capped_injection): cloud starts
    # at the true pose, sharded over the mesh.
    from slam_tpu.parallel import shard_state

    gt = Pose.create(40.0, 40.0, 0.3)
    st = mcl_mod.init(jax.random.key(2), cfg.n_particles, gt)
    st = shard_state(st, mesh, cfg.n_particles)
    odom = Odometry.create(0.03, 1.2, 0.03)
    alphas = (0.002,) * 4
    key = jax.random.key(102)

    def tick(st, gt, t):
        k, _ = jax.random.split(jax.random.fold_in(key, t))
        gt = motion.sample_motion_model_odometry(k, odom, gt, alphas)
        scan = fake_lidar.scan(blocked, gt, lidar, rc)
        st = m.predict(st, odom, alphas)
        st = m.update(st, scan, field)
        return st, gt

    for t in range(10):
        st, gt = tick(st, gt, t)
    mode = st.mode_pose
    assert float(jnp.hypot(mode.x - gt.x, mode.y - gt.y)) < 2.0

    gt = Pose.create(90.0, 90.0, -0.8)  # kidnap
    errs = []
    for t in range(10, 50):
        st, gt = tick(st, gt, t)
        mode = st.mode_pose
        errs.append(float(jnp.hypot(mode.x - gt.x, mode.y - gt.y)))
    assert min(errs) < 3.0, f"never re-localized: min err {min(errs):.2f}"
    assert np.mean(errs[-10:]) < 4.0, f"unstable tail: {errs[-10:]}"
    # The particle axis stayed sharded throughout.
    assert st.particles.pose.x.sharding.shard_shape((1024,))[0] == 256


def test_sharded_slam_with_incremental_edt_matches_single_device():
    """SLAMConfig.edt_box composes with the particle-sharded engine: the
    cached EDT is replicated by state_shardings, the refresh's
    dynamic-slice window runs under GSPMD, and the run matches the
    single-device incremental engine bitwise."""
    import dataclasses as dc

    hh = 128
    cfg = SLAMConfig(
        # meas_stddev=1 -> cap 7 -> capped reach 8 -> min box 33
        mcl=MCLConfig(
            n_particles=64, meas_stddev=1.0,
            measurement="likelihood_field_table",
        ),
        map=MapConfig(height=hh, width=hh),
        lidar=LidarConfig(n_rays=16, max_dist=50.0),
        raycast=RaycastConfig(step=1.0, max_dist=50.0, backend="sdf"),
        edt_box=72,
    )
    blocked = jnp.asarray(synthetic_room(hh, hh))
    pose = Pose.create(hh / 2.0, hh / 2.0, np.pi / 2)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    odom = Odometry.create(0.05, 1.5, 0.05)

    st0 = slam_mod.init(jax.random.key(0), cfg, pose)
    for _ in range(3):
        st0 = slam_mod.step(st0, odom, scan, cfg)

    mesh = make_mesh(8, beam_axis=2)
    engine = ShardedGridSLAM(mesh, cfg)
    st = engine.init(pose, seed=0)
    for _ in range(3):
        st = engine.step(st, odom, scan)
    jax.block_until_ready(st)

    np.testing.assert_allclose(
        np.asarray(st.grid), np.asarray(st0.grid), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.edt), np.asarray(st0.edt), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st.mcl.particles.pose.x),
        np.asarray(st0.mcl.particles.pose.x),
        rtol=1e-4,
    )
