"""End-to-end filter tests: localization and SLAM on a synthetic room with
scripted odometry, ATE-bounded against ground truth (the golden-trajectory
strategy SURVEY.md section 4 prescribes)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.core.config import (
    AdaptiveConfig,
    LidarConfig,
    MapConfig,
    MCLConfig,
    MotionConfig,
    RaycastConfig,
    SLAMConfig,
)
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar, mcl, simulate
from slam_tpu.utils.metrics import ate_rmse


def small_cfg(n_particles=300, adaptive=None):
    return SLAMConfig(
        mcl=MCLConfig(
            n_particles=n_particles,
            meas_stddev=3.0,
            scanner_offset=(0.0, 0.0, 0.0),
            adaptive=adaptive,
        ),
        map=MapConfig(height=128, width=128),
        lidar=LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=MotionConfig(alphas=(0.002, 0.002, 0.002, 0.002)),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, chunk=16),
    )


def circuit_commands(n=40):
    # Drive forward with a gentle constant turn: a loop inside the room.
    return [Odometry.create(0.04, 2.0, 0.04) for _ in range(n)]


class TestFakeLidar:
    def test_scan_angles_and_misses(self):
        blocked = jnp.asarray(simulate.synthetic_room())
        cfg = LidarConfig(max_dist=30.0, n_rays=8, stddev=0.0)
        scan = fake_lidar.scan(
            blocked, Pose.create(64.0, 64.0, 0.0), cfg, RaycastConfig(step=1.0)
        )
        assert scan.angles.shape == (8,)
        # angles span [-pi, pi) around the heading
        np.testing.assert_allclose(
            np.asarray(scan.angles),
            np.arange(8) * (2 * np.pi / 8) - np.pi,
            rtol=1e-5,
        )
        d = np.asarray(scan.dists)
        assert np.all(d <= 30.0) and np.all(d > 0)

    def test_noise_only_on_hits(self):
        blocked = jnp.zeros((64, 64), bool)
        cfg = LidarConfig(max_dist=20.0, n_rays=8, noise_stddev=2.0)
        scan = fake_lidar.scan(
            blocked,
            Pose.create(32.0, 32.0, 0.0),
            cfg,
            RaycastConfig(step=1.0),
            key=jax.random.key(0),
        )
        np.testing.assert_allclose(np.asarray(scan.dists), 20.0)


class TestLocalization:
    def test_tracks_trajectory(self):
        cfg = small_cfg()
        blocked = jnp.asarray(simulate.synthetic_room())
        res = simulate.run_localization(
            blocked,
            cfg,
            circuit_commands(40),
            Pose.create(40.0, 40.0, 0.3),
            seed=0,
        )
        ate = ate_rmse(res.est_xy, res.gt_xy)
        assert ate < 4.0, f"localization ATE {ate:.2f}px"

    def test_beats_dead_reckoning_with_drift(self):
        """With inflated motion noise, the filter must beat raw odometry."""
        cfg = small_cfg()
        cfg = dataclasses.replace(
            cfg, motion=MotionConfig(alphas=(0.01, 0.01, 0.01, 0.01))
        )
        blocked = jnp.asarray(simulate.synthetic_room())
        res = simulate.run_localization(
            blocked, cfg, circuit_commands(50), Pose.create(40.0, 40.0, 0.3), seed=3
        )
        ate = ate_rmse(res.est_xy, res.gt_xy)
        assert ate < 6.0, f"noisy localization ATE {ate:.2f}px"

    def test_adaptive_injection_runs(self):
        cfg = small_cfg(n_particles=200, adaptive=AdaptiveConfig())
        blocked = jnp.asarray(simulate.synthetic_room())
        res = simulate.run_localization(
            blocked, cfg, circuit_commands(10), Pose.create(40.0, 40.0, 0.3)
        )
        assert np.isfinite(res.est_xy).all()

    def test_ess_throttle_skips_and_fires(self):
        """ess_threshold < 1 resamples iff ESS <= thr * N: a degenerate
        cloud (all weight on one particle) fires (log weights reset to the
        uniform -log N and the cloud collapses onto the winner); an
        identical-pose cloud (ESS = N) skips (weights accumulate instead)."""
        cfg = small_cfg(n_particles=64)
        mcfg = dataclasses.replace(cfg.mcl, ess_threshold=0.5)
        blocked = jnp.asarray(simulate.synthetic_room())
        pose = Pose.create(40.0, 40.0, 0.3)
        scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)

        # Skip branch: identical particles -> equal weights -> ESS = N.
        state = mcl.init(jax.random.key(0), 64, pose)
        out = mcl.update(state, scan, blocked, mcfg, cfg.raycast)
        lw = np.asarray(out.particles.log_weight)
        assert not np.allclose(lw, -math.log(64.0)), (
            "resample fired (weights reset) despite ESS = N"
        )

        # Fire branch: one particle at the true pose, the rest far away.
        bad_x = state.particles.pose.x.at[1:].set(100.0)
        bad_y = state.particles.pose.y.at[1:].set(100.0)
        st = state.replace(
            particles=state.particles.replace(
                pose=state.particles.pose.replace(x=bad_x, y=bad_y)
            )
        )
        out = mcl.update(st, scan, blocked, mcfg, cfg.raycast)
        np.testing.assert_allclose(
            np.asarray(out.particles.log_weight), -math.log(64.0), rtol=1e-6
        )
        np.testing.assert_allclose(np.asarray(out.particles.pose.x), 40.0)
        np.testing.assert_allclose(np.asarray(out.particles.pose.y), 40.0)

    def test_update_with_scanner_offset(self):
        cfg = small_cfg()
        cfg = dataclasses.replace(
            cfg, mcl=dataclasses.replace(cfg.mcl, scanner_offset=(0.0, 5.0, 0.0))
        )
        blocked = jnp.asarray(simulate.synthetic_room())
        res = simulate.run_localization(
            blocked, cfg, circuit_commands(20), Pose.create(50.0, 40.0, 0.5), seed=1
        )
        ate = ate_rmse(res.est_xy, res.gt_xy)
        assert ate < 5.0, f"offset localization ATE {ate:.2f}px"


class TestSLAM:
    def test_slam_tracks_and_maps(self):
        # SLAM drifts in gauge (map and trajectory are self-consistent but
        # the frame can rotate vs ground truth when odometry is noisy), so:
        # realistic odometry noise + SE(2)-aligned ATE.
        cfg = small_cfg(n_particles=300)
        cfg = dataclasses.replace(
            cfg, motion=MotionConfig(alphas=(1e-4, 1e-4, 1e-3, 1e-3))
        )
        blocked = jnp.asarray(simulate.synthetic_room())
        res = simulate.run_slam(
            blocked, cfg, circuit_commands(40), Pose.create(40.0, 40.0, 0.3), seed=0
        )
        ate_aligned = ate_rmse(res.est_xy, res.gt_xy, align=True)
        ate_raw = ate_rmse(res.est_xy, res.gt_xy)
        assert ate_aligned < 3.0, f"SLAM aligned ATE {ate_aligned:.2f}px"
        assert ate_raw < 8.0, f"SLAM raw ATE {ate_raw:.2f}px"

        # Every mapped-occupied cell, transported into the gt frame by the
        # fitted trajectory alignment, must lie near a ground-truth obstacle.
        from scipy.spatial import cKDTree

        from slam_tpu.utils.metrics import fit_se2

        grid = np.asarray(res.final_state.grid)
        observed = np.abs(grid) > 0.3
        gt = np.asarray(blocked)
        h = gt.shape[0]

        def cells_to_world(mask):
            ii, jj = np.nonzero(mask)
            return np.stack([jj + 0.5, h - ii - 0.5], axis=1)  # (x, y)

        r, t = fit_se2(res.est_xy, res.gt_xy)
        est_pts = cells_to_world(grid > 0) @ r.T + t
        gt_tree = cKDTree(cells_to_world(gt))
        d, _ = gt_tree.query(est_pts)
        precision = (d <= 2.5).mean()
        assert observed.mean() > 0.2, "too little of the map observed"
        assert precision > 0.85, f"occupied-cell precision {precision:.2%}"

    def test_global_localization_uniform_init(self):
        blocked = jnp.asarray(simulate.synthetic_room())
        st = mcl.init_uniform(jax.random.key(0), 500, blocked)
        x = np.asarray(st.particles.pose.x)
        y = np.asarray(st.particles.pose.y)
        assert x.std() > 20 and y.std() > 20  # spread over the map


def test_slam_with_likelihood_field_measurement():
    """Full SLAM with the likelihood-field model: the dynamic map's EDT is
    rebuilt (JFA) inside the jitted step; no raycasting in the update."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.core.config import (
        LidarConfig,
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Pose
    from slam_tpu.models.simulate import (
        forward_arc_commands,
        run_slam,
        synthetic_room,
    )
    from slam_tpu.utils.metrics import ate_rmse

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=256, meas_stddev=3.0, measurement="likelihood_field"
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=MotionConfig(alphas=(0.002,) * 4),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )
    res = run_slam(
        blocked,
        cfg,
        forward_arc_commands(30, trans=1.5, rot=0.12),
        Pose.create(40.0, 40.0, 0.3),
        seed=3,
    )
    ate = ate_rmse(res.est_xy, res.gt_xy)
    assert ate < 8.0, f"SLAM+LF ATE {ate}"


def test_slam_with_lf_table_measurement():
    """Full SLAM with the windowed correlative LF table
    (measurement='likelihood_field_table'): same scenario and ATE bound as
    the direct likelihood-field test — the table is a drop-in large-N fast
    path, not a quality trade."""
    import jax.numpy as jnp

    from slam_tpu.core.config import (
        LidarConfig,
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Pose
    from slam_tpu.models.simulate import (
        forward_arc_commands,
        run_slam,
        synthetic_room,
    )
    from slam_tpu.utils.metrics import ate_rmse

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=256,
            meas_stddev=3.0,
            measurement="likelihood_field_table",
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=MotionConfig(alphas=(0.002,) * 4),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )
    res = run_slam(
        blocked,
        cfg,
        forward_arc_commands(30, trans=1.5, rot=0.12),
        Pose.create(40.0, 40.0, 0.3),
        seed=3,
    )
    ate = ate_rmse(res.est_xy, res.gt_xy)
    assert ate < 8.0, f"SLAM+LF-table ATE {ate}"


def test_slam_with_boxed_lf_table_measurement():
    """Full SLAM with the box-localized table build (lf_table_box): same
    scenario and ATE bound as the dense-table test — in tracking mode the
    box follows the cloud and the quality is unchanged while the build cost
    drops from T*H*W to T*box^2."""
    import jax.numpy as jnp

    from slam_tpu.core.config import (
        LidarConfig,
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Pose
    from slam_tpu.models.simulate import (
        forward_arc_commands,
        run_slam,
        synthetic_room,
    )
    from slam_tpu.utils.metrics import ate_rmse

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=256,
            meas_stddev=3.0,
            measurement="likelihood_field_table",
            lf_table_box=48,
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
        motion=MotionConfig(alphas=(0.002,) * 4),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )
    res = run_slam(
        blocked,
        cfg,
        forward_arc_commands(30, trans=1.5, rot=0.12),
        Pose.create(40.0, 40.0, 0.3),
        seed=3,
    )
    ate = ate_rmse(res.est_xy, res.gt_xy)
    assert ate < 8.0, f"SLAM+boxed-LF-table ATE {ate}"


def test_kidnap_recovery_with_capped_injection():
    """Kidnapped-robot recovery e2e: tracking -> teleport -> re-localize.
    Requires the round-4 injection cap (AdaptiveConfig.max_ratio=0.1 —
    the uncapped notebook ratio death-spirals on ordinary likelihood
    fluctuations) and the weight-aware mode_pose estimator (the unweighted
    mean is polluted by the injected uniform particles)."""
    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.models.simulate import synthetic_room
    from slam_tpu.ops import edt as edtlib, motion
    from slam_tpu.ops.rayfield import RayField

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    rc = RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    lidar = LidarConfig(max_dist=60.0, n_rays=36)
    cfg = MCLConfig(
        n_particles=1024, meas_stddev=3.0, measurement="likelihood_field",
        adaptive=AdaptiveConfig(max_ratio=0.1),
    )
    gt = Pose.create(40.0, 40.0, 0.3)
    st = mcl_mod.init(jax.random.key(2), cfg.n_particles, gt)
    odom = Odometry.create(0.03, 1.2, 0.03)
    key = jax.random.key(102)

    def tick(st, gt, t):
        k, _ = jax.random.split(jax.random.fold_in(key, t))
        gt = motion.sample_motion_model_odometry(k, odom, gt, (0.002,) * 4)
        scan = fake_lidar.scan(blocked, gt, lidar, rc)
        st = mcl_mod.predict(st, odom, (0.002,) * 4)
        st = mcl_mod.update(st, scan, field, cfg, rc)
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


def test_resample_every_counts_updates_not_frames():
    """`resample_every=k` must throttle by UPDATE count: with
    update_every=2 (two predicts per update) a frame-counter modulo would
    make every update land on an even step and resample EVERY update —
    the documented every-k throttle would silently do nothing."""
    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.models.simulate import synthetic_room
    from slam_tpu.ops import edt as edtlib
    from slam_tpu.ops.rayfield import RayField

    h = w = 96
    blocked = jnp.asarray(synthetic_room(h, w))
    rc = RaycastConfig(step=1.0, max_dist=50.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    lidar = LidarConfig(max_dist=50.0, n_rays=18)
    cfg = MCLConfig(n_particles=128, meas_stddev=3.0,
                    measurement="likelihood_field", resample_every=2)
    gt = Pose.create(30.0, 30.0, 0.4)
    st = mcl_mod.init(jax.random.key(0), cfg.n_particles, gt)
    odom = Odometry.create(0.02, 1.0, 0.02)
    scan = fake_lidar.scan(blocked, gt, lidar, rc)
    fired = []
    for _ in range(4):
        # update_every = 2: two motion frames per measurement update.
        st = mcl_mod.predict(st, odom, (0.001,) * 4)
        st = mcl_mod.predict(st, odom, (0.001,) * 4)
        st = mcl_mod.update(st, scan, field, cfg, rc)
        # Resample fired iff weights were reset to uniform.
        fired.append(bool(jnp.ptp(st.particles.log_weight) == 0))
    assert fired == [True, False, True, False], fired


def test_auto_measurement_tier_dispatch():
    """measurement='likelihood_field_auto' (round 4): a converged cloud
    scores EXACTLY like the forced boxed-table path, a dispersed
    (global-localization-like) cloud EXACTLY like the forced direct
    likelihood field — the lax.cond picks the branch from the cloud's own
    statistics."""
    import dataclasses as dc

    import jax.numpy as jnp

    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.ops import edt as edtlib
    from slam_tpu.ops.rayfield import RayField
    from slam_tpu.models.simulate import synthetic_room

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    rc = RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    lidar = LidarConfig(max_dist=60.0, n_rays=24)
    scan = fake_lidar.scan(blocked, Pose.create(40.0, 40.0, 0.3), lidar, rc)

    def run_update(cfg, pose_fn):
        st = mcl_mod.init(
            jax.random.key(0), cfg.n_particles, Pose.create(40.0, 40.0, 0.3)
        )
        pp = st.particles
        x, y, th = pose_fn(pp.n)
        st = st.replace(
            particles=pp.replace(
                pose=Pose(x=x, y=y, theta=th)
            )
        )
        out = mcl_mod.update(st, scan, field, cfg, rc)
        return np.asarray(out.particles.log_weight)

    base = MCLConfig(
        n_particles=64, meas_stddev=3.0, lf_table_box=32,
        ess_threshold=0.0,  # no resample: exact comparison
    )
    rs = np.random.RandomState(0)

    def converged(n):
        return (
            jnp.asarray(40.0 + 0.5 * rs.randn(n), jnp.float32),
            jnp.asarray(40.0 + 0.5 * rs.randn(n), jnp.float32),
            jnp.asarray(0.3 + 0.01 * rs.randn(n), jnp.float32),
        )

    def dispersed(n):
        return (
            jnp.asarray(rs.uniform(5, w - 5, n), jnp.float32),
            jnp.asarray(rs.uniform(5, h - 5, n), jnp.float32),
            jnp.asarray(rs.uniform(-np.pi, np.pi, n), jnp.float32),
        )

    for pose_fn, want_meas, other_meas in (
        (converged, "likelihood_field_table", "likelihood_field"),
        (dispersed, "likelihood_field", "likelihood_field_table"),
    ):
        rs = np.random.RandomState(0)
        auto = run_update(
            dc.replace(base, measurement="likelihood_field_auto"), pose_fn
        )
        rs = np.random.RandomState(0)
        forced = run_update(dc.replace(base, measurement=want_meas), pose_fn)
        rs = np.random.RandomState(0)
        other = run_update(dc.replace(base, measurement=other_meas), pose_fn)
        # Equal to the selected branch up to lax.cond-context compilation
        # rounding (ulps), and NOT equal to the other branch.
        np.testing.assert_allclose(auto, forced, rtol=1e-6, atol=1e-4)
        assert float(np.max(np.abs(auto - other))) > 0.01, want_meas


def test_auto_tier_global_localization_converges():
    """e2e through the tier switch: a uniform-init cloud on the known map
    localizes under measurement='likelihood_field_auto' — early steps run
    the direct branch (dispersed), late steps the boxed table (converged) —
    and ends within a few px of the true pose."""
    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.models.simulate import synthetic_room
    from slam_tpu.ops import edt as edtlib, motion
    from slam_tpu.ops.rayfield import RayField

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    rc = RaycastConfig(step=1.0, max_dist=60.0, backend="sdf")
    field = RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    lidar = LidarConfig(max_dist=60.0, n_rays=36)
    cfg = MCLConfig(
        n_particles=2048, meas_stddev=3.0,
        measurement="likelihood_field_auto", lf_table_box=32,
    )
    st = mcl_mod.init_uniform(jax.random.key(1), cfg.n_particles, blocked)
    # Dispersed enough that the first updates MUST take the direct branch.
    assert float(jnp.std(st.particles.pose.x)) > cfg.lf_table_box

    gt = Pose.create(40.0, 40.0, 0.3)
    odom = Odometry.create(0.05, 1.5, 0.05)
    key = jax.random.key(2)
    for t in range(12):
        key, kgt = jax.random.split(key)
        gt = motion.sample_motion_model_odometry(
            kgt, odom, gt, (0.002,) * 4
        )
        scan = fake_lidar.scan(blocked, gt, lidar, rc)
        st = mcl_mod.predict(st, odom, (0.002,) * 4)
        st = mcl_mod.update(st, scan, field, cfg, rc)
    mp = mcl_mod.mean_pose(st)
    err = float(jnp.hypot(mp.x - gt.x, mp.y - gt.y))
    # The cloud collapses onto the nearest uniform-init particle after one
    # update (~1/sqrt(N) pose-space coverage, ~9 px here) and then tracks;
    # the bound checks the switchover localizes, not MCL's global-loc
    # quality (beam-model + adaptive-injection tests cover that).
    assert err < 10.0, f"auto-tier global localization error {err}"
    # Converged: the cloud now fits the box, so the table branch is active.
    assert float(jnp.std(st.particles.pose.x)) * cfg.lf_auto_sigma < (
        cfg.lf_table_box / 2
    )


def test_auto_tier_host_dispatch_grid_slam():
    """GridSLAM's host-lagged auto dispatch: a dispersed cloud steps
    bit-identically to the forced-direct engine, a converged one to the
    forced-table engine (the wrapper literally runs those jits), and the
    lagged predicate flips tiers as the cloud converges."""
    import dataclasses as dc

    from slam_tpu.models import fake_lidar, slam as slam_mod
    from slam_tpu.models.simulate import synthetic_room

    h = w = 128
    blocked = jnp.asarray(synthetic_room(h, w))
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=256, meas_stddev=3.0,
            measurement="likelihood_field_auto", lf_table_box=32,
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(max_dist=60.0, n_rays=24),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )
    start = Pose.create(40.0, 40.0, 0.3)
    odom = Odometry.create(0.05, 1.5, 0.05)

    def disperse(state):
        rs = np.random.RandomState(7)
        pp = state.mcl.particles
        pose = Pose(
            x=jnp.asarray(rs.uniform(5, w - 5, pp.n), jnp.float32),
            y=jnp.asarray(rs.uniform(5, h - 5, pp.n), jnp.float32),
            theta=jnp.asarray(rs.uniform(-np.pi, np.pi, pp.n), jnp.float32),
        )
        return state.replace(mcl=state.mcl.replace(
            particles=pp.replace(pose=pose)))

    scan = fake_lidar.scan(blocked, start, cfg.lidar, cfg.raycast)

    for pose_prep, forced_meas in (
        (disperse, "likelihood_field"),
        (lambda s: s, "likelihood_field_table"),
    ):
        auto_engine = slam_mod.GridSLAM(cfg, seed=0)
        st_a = pose_prep(auto_engine.init(start))
        out_a = auto_engine.step(st_a, odom, scan)

        forced = slam_mod.GridSLAM(
            dc.replace(cfg, mcl=dc.replace(cfg.mcl, measurement=forced_meas)),
            seed=0,
        )
        out_f = forced.step(pose_prep(forced.init(start)), odom, scan)
        np.testing.assert_array_equal(
            np.asarray(out_a.mcl.particles.log_weight),
            np.asarray(out_f.mcl.particles.log_weight),
        )
        # The tier flag matches the cloud regime that selected forced_meas.
        assert auto_engine._auto.converged == (
            forced_meas == "likelihood_field_table"
        )


def test_first_update_uninformative_fallback():
    """The first SLAM update runs against an EMPTY grid: every particle
    scores the z_rand floor, argmax-of-uniform-weights is an arbitrary
    particle, and mapping from it bakes one random motion-noise heading
    draw into the shared map's gauge (measured -0.049 rad at t=0 and
    11-31 px of 120-step arc ATE). best_pose must fall
    back to the sharpened weighted mean (MCLState.mode_pose) whenever the
    measurement is uninformative — under uniform weights, the prior mean."""
    from slam_tpu.models import fake_lidar, slam as slam_mod

    h = w = 128
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=64, measurement="likelihood_field_table"),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=30, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, backend="sdf"),
    )
    engine = slam_mod.GridSLAM(cfg, seed=0)
    start = Pose.create(64.0, 64.0, 0.5)
    state = engine.init(start)
    blocked = jnp.zeros((h, w), bool).at[10, :].set(True)
    scan = fake_lidar.scan(blocked, start, cfg.lidar, cfg.raycast)
    st1 = engine.step(state, Odometry.create(0.02, 2.0, 0.02), scan)

    # Fallback fired: best_pose == mode_pose exactly...
    for b, m in zip(
        jax.tree.leaves(st1.mcl.best_pose), jax.tree.leaves(st1.mcl.mode_pose)
    ):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(m))
    # ...and it is a MEAN, not any single particle's pose (the pre-round-4
    # behavior picked an arbitrary particle here).
    assert not bool(
        jnp.any(st1.mcl.particles.pose.x == st1.mcl.best_pose.x)
    )


def test_first_update_uninformative_fallback_with_table_box():
    """Same empty-grid first update, but with the box-localized build
    (lf_table_box): a handful of far-tail particles fall outside the box
    and score the z_rand floor, so the weights are NOT all equal — yet the
    in-box majority still ties at the top, the measurement carries no pose
    information, and the fallback must STILL fire (the detection is a
    majority-tie test, not ptp == 0)."""
    from slam_tpu.models import fake_lidar, slam as slam_mod

    h = w = 128
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=64,
            measurement="likelihood_field_table",
            lf_table_box=24,
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=30, max_dist=100.0),
        raycast=RaycastConfig(max_dist=100.0, backend="sdf"),
    )
    engine = slam_mod.GridSLAM(cfg, seed=0)
    start = Pose.create(64.0, 64.0, 0.5)
    state = engine.init(start)
    # Push a few particles far out of the 24-cell box so they take the
    # floor score (ptp(lw) > 0 — the old detection would declare the
    # measurement informative and crown an arbitrary tied particle).
    pp = state.mcl.particles
    x = pp.pose.x.at[:3].set(jnp.asarray([5.0, 120.0, 5.0]))
    y = pp.pose.y.at[:3].set(jnp.asarray([5.0, 5.0, 120.0]))
    state = state.replace(
        mcl=state.mcl.replace(
            particles=pp.replace(pose=pp.pose.replace(x=x, y=y))
        )
    )
    blocked = jnp.zeros((h, w), bool).at[10, :].set(True)
    scan = fake_lidar.scan(blocked, start, cfg.lidar, cfg.raycast)
    st1 = engine.step(state, Odometry.create(0.02, 2.0, 0.02), scan)
    for b, m in zip(
        jax.tree.leaves(st1.mcl.best_pose), jax.tree.leaves(st1.mcl.mode_pose)
    ):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(m))


def test_mcl_wrapper_honors_seed():
    """Round-5 fix: `MCL(cfg, seed=...)` used to accept the seed and then
    hardcode key(0) in init() — a user sweeping filter seeds through the
    reference-parity wrapper got identical runs."""
    cfg = MCLConfig(n_particles=16)
    st1 = mcl.MCL(cfg, seed=1).init(64, 64)
    st1b = mcl.MCL(cfg, seed=1).init(64, 64)
    st2 = mcl.MCL(cfg, seed=2).init(64, 64)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(st1.key)),
        np.asarray(jax.random.key_data(st1b.key)),
    )
    assert not np.array_equal(
        np.asarray(jax.random.key_data(st1.key)),
        np.asarray(jax.random.key_data(st2.key)),
    )


def test_map_every_first_update_always_maps():
    """Round-5 advisor fix: with map_every=k>1 the map throttle read the
    POST-increment update counter, so the first k-1 scans — including the
    bootstrap scan against the empty grid — never mapped, while
    resample_every (PRE-increment) fired on the first update. Both
    throttles now share the pre-increment phase: updates 1, 3, 5...
    (1-indexed) map under map_every=2."""
    from slam_tpu.models import slam as slam_mod

    h = w = 96
    cfg = SLAMConfig(
        mcl=MCLConfig(n_particles=32, measurement="likelihood_field"),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=16, max_dist=50.0),
        raycast=RaycastConfig(step=1.0, max_dist=50.0, backend="sdf"),
        map_every=2,
    )
    engine = slam_mod.GridSLAM(cfg, seed=0)
    start = Pose.create(48.0, 48.0, 0.5)
    state = engine.init(start)
    blocked = jnp.zeros((h, w), bool).at[10, :].set(True)
    scan = fake_lidar.scan(blocked, start, cfg.lidar, cfg.raycast)
    odom = Odometry.create(0.0, 0.5, 0.0)
    mapped = []
    prev_grid = state.grid
    for _ in range(4):
        state = engine.step(state, odom, scan)
        mapped.append(bool(jnp.any(state.grid != prev_grid)))
        prev_grid = state.grid
    assert mapped == [True, False, True, False], mapped


def test_map_pose_auto_resolution_and_equivalence():
    """map_pose='auto' (round 5): the measured regime rule resolves at
    trace time — best at small N, mean at large N with k=1, mode at large
    N with resample_every>1 — and an auto-config step is BIT-identical to
    the forced resolved-estimator step."""
    from slam_tpu.models import fake_lidar, slam as slam_mod

    base = MCLConfig(n_particles=32, measurement="likelihood_field")
    mk = lambda mcl_cfg, **kw: SLAMConfig(
        mcl=mcl_cfg,
        map=MapConfig(height=96, width=96),
        lidar=LidarConfig(n_rays=16, max_dist=50.0),
        raycast=RaycastConfig(step=1.0, max_dist=50.0, backend="sdf"),
        **kw,
    )
    assert slam_mod.resolve_map_pose(mk(base, map_pose="auto")) == "best"
    big = dataclasses.replace(base, n_particles=100_000)
    assert slam_mod.resolve_map_pose(mk(big, map_pose="auto")) == "mean"
    big_k = dataclasses.replace(big, resample_every=4)
    assert slam_mod.resolve_map_pose(mk(big_k, map_pose="auto")) == "mode"
    assert slam_mod.resolve_map_pose(mk(base, map_pose="mode")) == "mode"

    # Bitwise step equivalence auto vs forced-resolved at small N.
    cfg_auto = mk(base, map_pose="auto")
    cfg_best = mk(base, map_pose="best")
    from slam_tpu.models.simulate import synthetic_room

    blocked = jnp.asarray(synthetic_room(96, 96))
    start = Pose.create(48.0, 48.0, 0.5)
    scan = fake_lidar.scan(blocked, start, cfg_auto.lidar, cfg_auto.raycast)
    odom = Odometry.create(0.01, 1.0, 0.01)
    s_a = slam_mod.init(jax.random.key(3), cfg_auto, start)
    s_b = slam_mod.init(jax.random.key(3), cfg_best, start)
    for _ in range(3):
        s_a = slam_mod.step(s_a, odom, scan, cfg_auto)
        s_b = slam_mod.step(s_b, odom, scan, cfg_best)
    def raw(leaf):
        if hasattr(leaf, "dtype") and jax.dtypes.issubdtype(
            leaf.dtype, jax.dtypes.prng_key
        ):
            return np.asarray(jax.random.key_data(leaf))
        return np.asarray(leaf)

    for la, lb in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_array_equal(raw(la), raw(lb))


def test_incremental_edt_slam_bitwise_equivalence():
    """SLAMConfig.edt_box (round 5): a full SLAM run with the incremental
    EDT cache is BIT-identical to the rebuild-per-step run — across the
    exploration phase (wide flip bboxes falling back to the full rebuild)
    and the converged phase (window refreshes and no-flip skips)."""
    import dataclasses as dc

    from slam_tpu.models import fake_lidar, slam as slam_mod
    from slam_tpu.models.simulate import synthetic_room

    h = w = 128
    base = SLAMConfig(
        # meas_stddev=1 -> cap 7 -> capped reach 8 -> min box 33
        mcl=MCLConfig(
            n_particles=48, meas_stddev=1.0,
            measurement="likelihood_field_table",
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=20, max_dist=60.0),
        raycast=RaycastConfig(step=1.0, max_dist=60.0, backend="sdf"),
    )
    cfg_inc = dc.replace(base, edt_box=72)
    blocked = jnp.asarray(synthetic_room(h, w))
    start = Pose.create(64.0, 64.0, 0.3)
    odom = Odometry.create(0.01, 1.5, 0.01)

    def run(cfg):
        eng = slam_mod.GridSLAM(cfg, seed=0)
        st = eng.init(start)
        gt = start
        out = []
        for t in range(12):
            scan = fake_lidar.scan(blocked, gt, cfg.lidar, cfg.raycast)
            st = eng.step(st, odom, scan)
            out.append(st)
            th1 = gt.theta + 0.01
            gt = Pose.create(
                gt.x + 1.5 * jnp.cos(th1),
                gt.y + 1.5 * jnp.sin(th1),
                th1 + 0.01,
            )
        return out

    ref_states = run(base)
    inc_states = run(cfg_inc)
    for t, (a, b) in enumerate(zip(ref_states, inc_states)):
        np.testing.assert_array_equal(
            np.asarray(a.grid), np.asarray(b.grid), err_msg=f"grid t={t}"
        )
        for name in ("x", "y", "theta"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a.est_pose, name)),
                np.asarray(getattr(b.est_pose, name)),
                err_msg=f"est_pose.{name} t={t}",
            )
        np.testing.assert_array_equal(
            np.asarray(a.mcl.particles.log_weight),
            np.asarray(b.mcl.particles.log_weight),
            err_msg=f"log_weight t={t}",
        )
    # The cache invariant itself: state.edt == full rebuild of the grid.
    from slam_tpu.core import grid as gridlib
    from slam_tpu.ops import edt as edtlib

    final = inc_states[-1]
    want = edtlib.edt_capped(
        gridlib.blocked_from_logodds(final.grid), 7.0
    )
    np.testing.assert_array_equal(np.asarray(final.edt), np.asarray(want))
