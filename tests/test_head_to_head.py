"""Opt-in head-to-head regression vs the C++ reference (with honest
statistics).

Runs the reference binary (`tools/refbench/ref_mcl_traj`, built from the
unmodified sources in /root/reference) along its deterministic trajectory
and replays the IDENTICAL trajectory + exact-DDA scans through slam_tpu.
SLAM on this arc is BIMODAL on both sides (keep-the-gauge ~1-3 px vs
bake-an-early-heading-error ~12-57 px; C++ measured 1.3-56.6 over 20
clock-seeded runs, long-run mean ~17.6 over the first 15), and the
deterministic runs are chaotic — a one-ULP code change flips a seed
between modes — so single-seed <= single-sample-mean assertions are coin
flips. What this file enforces instead:

  1. the ground-truth replay is bit-comparable (no-filter sanity);
  2. our RBPF (the reference's own algorithm family) at the reference's
     200 particles sits in the same regime: 2-seed mean under a bound set
     from the C++ long-run statistics;
  3. the FLAGSHIP shared-map engine's 2-seed mean beats the C++ long-run
     mean AND an absolute bar (so a lucky C++ sample can't mask a
     regression).

Opt-in because it needs the reference assets + a one-off native build and
takes ~15 minutes on CPU:

    python -m pytest tests/test_head_to_head.py -m headtohead
"""

import json
import os
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_BIN = os.path.join(REPO, ".build", "ref_mcl_traj")
FLOOR = "/root/reference/assets/floor_plan.png"

pytestmark = pytest.mark.headtohead


def _ensure_binary():
    if os.path.exists(TRAJ_BIN):
        return True
    build = os.path.join(REPO, "tools", "refbench", "build.sh")
    if not os.path.exists("/root/reference/slam/mcl.cpp"):
        return False
    try:
        subprocess.run(["bash", build], check=True, capture_output=True)
    except Exception:
        return False
    return os.path.exists(TRAJ_BIN)


N_REF_RUNS = 5  # the reference's clock-seeded RNG makes single runs noisy
                # (observed ATE spread 11-45px over repeated runs)


@pytest.fixture(scope="module")
def ref_trajs():
    if not os.path.exists(FLOOR):
        pytest.skip("reference floor plan asset unavailable")
    if not _ensure_binary():
        pytest.skip("reference harness binary unavailable")
    runs = []
    for _ in range(N_REF_RUNS):
        out = subprocess.run(
            [TRAJ_BIN, FLOOR, "200", "120", "2.5", "0.02"],
            check=True,
            capture_output=True,
            text=True,
            timeout=600,
        )
        runs.append(
            [json.loads(l) for l in out.stdout.splitlines() if l.strip()]
        )
    return runs


def test_gt_replay_matches_reference(ref_trajs):
    """The deterministic ground-truth arc integrates identically on both
    sides (no filter involved) — the precondition for any ATE comparison."""
    gt_xy = np.array([r["gt"][:2] for r in ref_trajs[0]])
    gt = np.array([648.5, 299.5, np.pi / 2])  # slam/mcl.cpp:22-25 start
    ours = []
    for _ in range(len(ref_trajs[0])):
        th1 = gt[2] + 0.01
        gt = np.array(
            [gt[0] + 2.5 * np.cos(th1), gt[1] + 2.5 * np.sin(th1), th1 + 0.01]
        )
        ours.append(gt[:2].copy())
    np.testing.assert_allclose(np.array(ours), gt_xy, atol=1e-2)


def test_rbpf_matches_reference_regime(ref_trajs):
    """Our RBPF — the reference's own per-particle-map algorithm family —
    at the reference's 200 particles, 2 seeds (~4 min CPU): the seed mean
    must sit in the C++'s own long-run regime (measured: ours 16.2-20.0
    over 3 seeds, C++ long-run mean 17.6 with runs up to 56.6)."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.core.config import LidarConfig, MCLConfig, RaycastConfig
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, rbpf
    from slam_tpu.ops.measurement import sensor_pose
    from slam_tpu.utils.maps import load_binary_map
    from slam_tpu.utils.metrics import ate_rmse

    blocked = jnp.asarray(load_binary_map(FLOOR) == 0)
    h, w = blocked.shape
    cfg = MCLConfig(
        n_particles=200, meas_stddev=5.0, scanner_offset=(0.0, 30.0, 0.0)
    )
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="march")
    lidar = LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0, n_rays=90)
    steps = len(ref_trajs[0])

    ates = []
    for seed in (0, 1):
        engine = rbpf.RBPF(cfg, rc, seed=seed)
        start = Pose.create(w / 2.0, h / 2.0, np.pi / 2)
        state = engine.init(start, (h, w))
        odom = Odometry.create(0.01, 2.5, 0.01)
        gt = start
        est, gts = [], []
        for _ in range(steps):
            th1 = gt.theta + 0.01
            gt = Pose.create(
                gt.x + 2.5 * jnp.cos(th1), gt.y + 2.5 * jnp.sin(th1),
                th1 + 0.01,
            )
            scan = fake_lidar.scan(
                blocked, sensor_pose(gt, cfg.scanner_offset), lidar, rc
            )
            state = engine.step(state, odom, scan)
            mp = rbpf.mean_pose(state)
            est.append([float(mp.x), float(mp.y)])
            gts.append([float(gt.x), float(gt.y)])
        ates.append(float(ate_rmse(np.array(est), np.array(gts))))
    ours = float(np.mean(ates))
    print(f"\nRBPF@200 ATE per seed {[round(a, 2) for a in ates]} "
          f"(mean {ours:.2f}px) vs C++ long-run mean {CPP_LONGRUN_MEAN_PX}px")
    assert ours <= RBPF_REGIME_BOUND_PX, (
        f"RBPF@200 2-seed mean {ours:.2f}px outside the reference regime "
        f"(bound {RBPF_REGIME_BOUND_PX}px; C++ long-run mean "
        f"{CPP_LONGRUN_MEAN_PX}px)"
    )


# C++ harness long-run statistics:
# 20 clock-seeded runs observed, per-run ATE 1.3-56.6 px; mean 17.6 over
# the first 15.
CPP_LONGRUN_MEAN_PX = 17.6
# RBPF regime bound: ours measured 16.2-20.0 px over 3 seeds (mean 18.2);
# the bound allows one good + one drifted seed but fails two drifted ones.
RBPF_REGIME_BOUND_PX = 30.0
# Absolute bar for the flagship engine's 2-seed mean: measured 12.6/12.9 px
# (seed 2: 1.6) after the round-4 uninformative-argmax fallback — the bar
# sits under the C++ long-run mean with headroom for seed noise, and exists
# so a "still beats a lucky C++ sample" regression cannot hide.
FLAGSHIP_MEAN_BOUND_PX = 16.0


def test_flagship_slam_beats_reference_longrun_mean(ref_trajs):
    """The FLAGSHIP shared-map configuration (likelihood_field_table) on the
    shared deterministic trajectory, 2 filter seeds (~10 min CPU): the seed
    mean must beat the C++ 15-run mean AND hold the absolute bar — a lucky
    5-run C++ sample (5-run means as low as ~4 px exist in the measured
    distribution) cannot mask a regression, nor can an unlucky one excuse
    us."""
    import jax.numpy as jnp

    from slam_tpu.core.config import (
        LidarConfig,
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.models.simulate import run_slam_deterministic
    from slam_tpu.utils.maps import load_binary_map
    from slam_tpu.utils.metrics import ate_rmse

    ref_ates = []
    for traj in ref_trajs:
        g = np.array([r["gt"][:2] for r in traj])
        ref_ates.append(ate_rmse(np.array([r["mean"] for r in traj]), g))

    blocked = jnp.asarray(load_binary_map(FLOOR) == 0)
    h, w = blocked.shape
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=200,
            meas_stddev=5.0,
            scanner_offset=(0.0, 30.0, 0.0),
            measurement="likelihood_field_table",
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0, n_rays=90),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=1.0, max_dist=500.0, backend="sdf"),
    )
    ates = []
    for seed in (0, 1):
        res = run_slam_deterministic(
            blocked, cfg, len(ref_trajs[0]), 2.5, 0.02, seed=seed
        )
        ates.append(float(ate_rmse(res.est_xy, res.gt_xy)))
    ours = float(np.mean(ates))
    print(
        f"\nflagship ATE per seed {[round(a, 2) for a in ates]} (mean "
        f"{ours:.2f}px) vs C++ long-run mean {CPP_LONGRUN_MEAN_PX}px "
        f"(this sample: {[round(a, 1) for a in ref_ates]})"
    )
    assert ours <= CPP_LONGRUN_MEAN_PX, (
        f"flagship 2-seed mean {ours:.2f}px worse than the C++ 15-run mean"
    )
    assert ours <= FLAGSHIP_MEAN_BOUND_PX, (
        f"flagship 2-seed mean {ours:.2f}px exceeds the absolute "
        f"{FLAGSHIP_MEAN_BOUND_PX}px bar"
    )
