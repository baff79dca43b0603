"""Correlative scan-matching refinement (slam_tpu.ops.scanmatch): oracle
pose-recovery tests plus closed-loop SLAM integration."""

import dataclasses

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
    ScanMatchConfig,
    SLAMConfig,
)
from slam_tpu.core.types import Pose
from slam_tpu.models import fake_lidar, simulate
from slam_tpu.ops import edt as edtlib, rayfield, scanmatch
from slam_tpu.utils.metrics import ate_rmse


STDDEV = 3.0


def room_field():
    blocked = jnp.asarray(simulate.synthetic_room())
    return blocked, rayfield.RayField(
        blocked=blocked,
        edt=edtlib.edt_jfa(blocked, max_dist=5.0 * STDDEV + 2.0),
    )


def room_scan(blocked, pose, offset=(0.0, 0.0, 0.0)):
    from slam_tpu.ops.measurement import sensor_pose

    lidar = LidarConfig(max_dist=60.0, n_rays=48, stddev=0.0)
    rc = RaycastConfig(step=0.5, max_dist=60.0)
    return fake_lidar.scan(blocked, sensor_pose(pose, offset), lidar, rc), rc


class TestRefinePose:
    @pytest.mark.parametrize(
        "dx,dy,dth",
        [(2.3, -1.7, 0.03), (-3.1, 0.4, -0.04), (0.0, 0.0, 0.0)],
    )
    def test_recovers_perturbed_pose(self, dx, dy, dth):
        """Seeding with a perturbed pose recovers the scan's true pose to
        sub-cell translation and sub-bin heading."""
        blocked, field = room_field()
        true = Pose.create(52.0, 47.0, 0.8)
        scan, rc = room_scan(blocked, true)
        seed = Pose.create(true.x + dx, true.y + dy, true.theta + dth)
        refined, _ = scanmatch.refine_pose(
            field, seed, scan, rc=rc, stddev=STDDEV
        )
        assert abs(float(refined.x) - 52.0) < 0.8
        assert abs(float(refined.y) - 47.0) < 0.8
        assert abs(float(refined.theta) - 0.8) < 0.02

    def test_refined_beats_seed(self):
        """The refinement must not move a pose AWAY from the truth: over a
        grid of seeds within the window, mean refined error < mean seed
        error."""
        blocked, field = room_field()
        true = Pose.create(52.0, 47.0, 0.8)
        scan, rc = room_scan(blocked, true)
        rng = np.random.default_rng(0)
        seed_err, ref_err = [], []
        for _ in range(10):
            dx, dy = rng.uniform(-3.5, 3.5, 2)
            dth = rng.uniform(-0.05, 0.05)
            seed = Pose.create(true.x + dx, true.y + dy, true.theta + dth)
            refined, _ = scanmatch.refine_pose(
                field, seed, scan, rc=rc, stddev=STDDEV
            )
            seed_err.append(np.hypot(dx, dy))
            ref_err.append(
                np.hypot(float(refined.x) - 52.0, float(refined.y) - 47.0)
            )
        assert np.mean(ref_err) < 0.5 * np.mean(seed_err)

    def test_scanner_offset_round_trip(self):
        """With a lidar mounting offset the refinement must return a ROBOT
        pose (the sensor-frame search inverted through the offset)."""
        offset = (0.0, 5.0, 0.1)
        blocked, field = room_field()
        true = Pose.create(50.0, 45.0, 0.5)
        scan, rc = room_scan(blocked, true, offset)
        seed = Pose.create(true.x + 2.0, true.y - 1.0, true.theta + 0.02)
        refined, _ = scanmatch.refine_pose(
            field, seed, scan, rc=rc, stddev=STDDEV, scanner_offset=offset
        )
        assert abs(float(refined.x) - 50.0) < 1.0
        assert abs(float(refined.y) - 45.0) < 1.0
        assert abs(float(refined.theta) - 0.5) < 0.02

    def test_flat_surface_returns_seed(self):
        """All-max-range scans carry no information: the center-preferring
        tiebreak must keep the seed pose instead of a window corner."""
        blocked = jnp.zeros((64, 64), bool)
        field = rayfield.RayField(
            blocked=blocked, edt=edtlib.edt_jfa(blocked, max_dist=17.0)
        )
        lidar = LidarConfig(max_dist=20.0, n_rays=16)
        rc = RaycastConfig(step=1.0, max_dist=20.0)
        seed = Pose.create(32.0, 32.0, 0.3)
        scan = fake_lidar.scan(blocked, seed, lidar, rc)
        refined, _ = scanmatch.refine_pose(field, seed, scan, rc=rc)
        np.testing.assert_allclose(float(refined.x), 32.0, atol=1e-4)
        np.testing.assert_allclose(float(refined.y), 32.0, atol=1e-4)
        np.testing.assert_allclose(float(refined.theta), 0.3, atol=1e-4)

    def test_jit_and_no_subcell(self):
        blocked, field = room_field()
        true = Pose.create(52.0, 47.0, 0.8)
        scan, rc = room_scan(blocked, true)
        seed = Pose.create(53.0, 46.0, 0.82)
        cfg = ScanMatchConfig(subcell=False)
        fn = jax.jit(
            lambda p, z: scanmatch.refine_pose(
                field, p, z, rc=rc, cfg=cfg, stddev=STDDEV
            )
        )
        refined, peak = fn(seed, scan)
        # Integer-cell search: within one cell / one bin of the truth.
        assert abs(float(refined.x) - 52.0) <= 1.0
        assert abs(float(refined.y) - 47.0) <= 1.0
        assert np.isfinite(float(peak))


class TestSLAMIntegration:
    def _cfg(self, scanmatch_cfg):
        return SLAMConfig(
            mcl=MCLConfig(
                n_particles=300,
                meas_stddev=3.0,
                measurement="likelihood_field_table",
                lf_table_bins=16,
            ),
            map=MapConfig(height=128, width=128),
            lidar=LidarConfig(max_dist=60.0, n_rays=24, stddev=3.0),
            motion=MotionConfig(alphas=(0.002, 0.002, 0.002, 0.002)),
            raycast=RaycastConfig(step=1.0, max_dist=60.0, chunk=16),
            scanmatch=scanmatch_cfg,
        )

    def test_slam_with_scanmatch_tracks(self):
        """SLAM-mode refinement (vs the LEARNED map) is bounded by map
        quality: the refined trajectory must track within a small margin of
        the best-particle trajectory it seeds from (the measured behavior:
        neutral at converged scale, the win is in known-map
        localization)."""
        blocked = jnp.asarray(simulate.synthetic_room())
        cfg = self._cfg(ScanMatchConfig())
        res = simulate.run_slam(
            blocked,
            cfg,
            simulate.forward_arc_commands(40, trans=2.0, rot=0.04),
            Pose.create(40.0, 40.0, 0.3),
            seed=3,
        )
        sm_ate = ate_rmse(res.sm_xy, res.gt_xy)
        best_ate = ate_rmse(res.best_xy, res.gt_xy)
        assert sm_ate < 6.0, f"scan-matched SLAM ATE {sm_ate:.2f}px"
        assert sm_ate <= best_ate + 1.5, (
            f"refinement degraded best-particle ATE: {sm_ate:.2f} vs "
            f"{best_ate:.2f}"
        )

    def test_localization_refinement_beats_small_filter(self):
        """The serving win: with a KNOWN map and very few particles, the
        refined mean pose tracks substantially better than the raw mean
        (0.69 vs 1.98 px measured at 32 particles on the floor plan; the
        room-scale bound here is looser but the ordering must hold)."""
        from slam_tpu.models import mcl as mcl_mod
        from slam_tpu.ops import motion, rayfield, scanmatch
        from slam_tpu.ops.measurement import sensor_pose

        blocked = jnp.asarray(simulate.synthetic_room())
        cfg = dataclasses.replace(
            self._cfg(None),
            mcl=MCLConfig(
                n_particles=32, meas_stddev=3.0, measurement="likelihood_field"
            ),
            raycast=RaycastConfig(
                step=1.0, max_dist=60.0, chunk=16, backend="sdf"
            ),
        )
        rc = cfg.raycast
        field = rayfield.make_ray_field(blocked, rc)
        m = mcl_mod.MCL(cfg.mcl, rc)
        st = mcl_mod.init(jax.random.key(0), 32, Pose.create(40.0, 40.0, 0.3))
        gt = Pose.create(40.0, 40.0, 0.3)
        key = jax.random.key(1)
        scan_jit = jax.jit(
            lambda p: fake_lidar.scan(blocked, p, cfg.lidar, rc)
        )
        ref_jit = jax.jit(
            lambda p, z: scanmatch.refine_pose(
                field, p, z, rc=rc, stddev=3.0
            )[0]
        )
        mean_xy, sm_xy, gt_xy = [], [], []
        for t in range(40):
            odom = simulate.forward_arc_commands(1, trans=2.0, rot=0.04)[0]
            k_gt, _ = jax.random.split(jax.random.fold_in(key, t))
            st = m.predict(st, odom, cfg.motion.alphas)
            gt = motion.sample_motion_model_odometry(
                k_gt, odom, gt, cfg.motion.alphas
            )
            scan = scan_jit(sensor_pose(gt, cfg.mcl.scanner_offset))
            st = m.update(st, scan, field)
            mp = mcl_mod.mean_pose(st)
            r = ref_jit(mp, scan)
            mean_xy.append([float(mp.x), float(mp.y)])
            sm_xy.append([float(r.x), float(r.y)])
            gt_xy.append([float(gt.x), float(gt.y)])
        mean_ate = ate_rmse(np.array(mean_xy), np.array(gt_xy))
        sm_ate = ate_rmse(np.array(sm_xy), np.array(gt_xy))
        assert sm_ate < 1.5, f"refined localization ATE {sm_ate:.2f}px"
        assert sm_ate < mean_ate + 0.2, (
            f"refined {sm_ate:.2f} vs raw mean {mean_ate:.2f}"
        )

    def test_est_pose_defaults_to_best(self):
        """Without scanmatch, SLAMState.est_pose is the best particle."""
        blocked = jnp.asarray(simulate.synthetic_room())
        cfg = self._cfg(None)
        res = simulate.run_slam(
            blocked,
            cfg,
            simulate.forward_arc_commands(5, trans=2.0, rot=0.05),
            Pose.create(40.0, 40.0, 0.3),
            seed=0,
        )
        st = res.final_state
        np.testing.assert_allclose(
            float(st.est_pose.x), float(st.mcl.best_pose.x)
        )
        np.testing.assert_allclose(
            float(st.est_pose.y), float(st.mcl.best_pose.y)
        )


class TestCoarseToFine:
    @pytest.mark.parametrize(
        "dx,dy,dth",
        [(14.0, -11.0, 0.12), (-15.0, 8.0, -0.18), (12.0, 13.0, 0.0)],
    )
    def test_recovers_beyond_fine_window(self, dx, dy, dth):
        """Seeds displaced far beyond the single-level window (+-5 cells,
        +-0.06 rad) recover once the coarse level (stride-max-pooled wide
        search) runs first."""
        blocked, field = room_field()
        true = Pose.create(52.0, 47.0, 0.8)
        scan, rc = room_scan(blocked, true)
        seed = Pose.create(true.x + dx, true.y + dy, true.theta + dth)
        cfg = ScanMatchConfig(coarse_window=20)
        refined, _ = scanmatch.refine_pose(
            field, seed, scan, rc=rc, cfg=cfg, stddev=STDDEV
        )
        assert abs(float(refined.x) - 52.0) < 1.0
        assert abs(float(refined.y) - 47.0) < 1.0
        assert abs(float(refined.theta) - 0.8) < 0.03

    def test_single_level_fails_far_seed(self):
        """Control: the same far seed does NOT recover single-level (the
        fine window cannot reach it) — the coarse level is load-bearing."""
        blocked, field = room_field()
        true = Pose.create(52.0, 47.0, 0.8)
        scan, rc = room_scan(blocked, true)
        seed = Pose.create(true.x + 14.0, true.y - 11.0, true.theta + 0.12)
        refined, _ = scanmatch.refine_pose(
            field, seed, scan, rc=rc, stddev=STDDEV
        )
        err = abs(float(refined.x) - 52.0) + abs(float(refined.y) - 47.0)
        assert err > 5.0

    def test_near_seed_matches_single_level(self):
        """With a near seed the coarse level must hand the fine level a
        block whose refinement lands within a cell of the single-level
        result (no regression when the coarse stage isn't needed)."""
        blocked, field = room_field()
        true = Pose.create(52.0, 47.0, 0.8)
        scan, rc = room_scan(blocked, true)
        seed = Pose.create(true.x + 1.5, true.y - 1.0, true.theta + 0.02)
        r1, _ = scanmatch.refine_pose(field, seed, scan, rc=rc, stddev=STDDEV)
        r2, _ = scanmatch.refine_pose(
            field,
            seed,
            scan,
            rc=rc,
            cfg=ScanMatchConfig(coarse_window=20),
            stddev=STDDEV,
        )
        assert abs(float(r1.x) - float(r2.x)) < 1.0
        assert abs(float(r1.y) - float(r2.y)) < 1.0
        assert abs(float(r1.theta) - float(r2.theta)) < 0.02


def test_scanmatch_with_incremental_edt_cache_bitwise():
    """SLAMConfig.scanmatch composes with the round-5 EDT cache: a
    scan-matched SLAM run with edt_box is bit-identical to the
    rebuild-per-step run (the refinement reads the same cached field)."""
    import dataclasses as dc

    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.core.config import (
        LidarConfig,
        MapConfig,
        MCLConfig,
        RaycastConfig,
        ScanMatchConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, slam as slam_mod
    from slam_tpu.models.simulate import synthetic_room

    h = w = 128
    base = SLAMConfig(
        mcl=MCLConfig(
            n_particles=32, meas_stddev=1.0,
            measurement="likelihood_field",
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=16, max_dist=50.0),
        raycast=RaycastConfig(step=1.0, max_dist=50.0, backend="sdf"),
        scanmatch=ScanMatchConfig(window=2, theta_bins=5),
    )
    cfg_inc = dc.replace(base, edt_box=72)
    blocked = jnp.asarray(synthetic_room(h, w))
    start = Pose.create(64.0, 64.0, 0.3)
    scan = fake_lidar.scan(blocked, start, base.lidar, base.raycast)
    odom = Odometry.create(0.01, 1.0, 0.01)

    sa = slam_mod.init(jax.random.key(1), base, start)
    sb = slam_mod.init(jax.random.key(1), cfg_inc, start)
    for _ in range(4):
        sa = slam_mod.step(sa, odom, scan, base)
        sb = slam_mod.step(sb, odom, scan, cfg_inc)
    np.testing.assert_array_equal(np.asarray(sa.grid), np.asarray(sb.grid))
    for f in ("x", "y", "theta"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sa.est_pose, f)),
            np.asarray(getattr(sb.est_pose, f)),
        )
