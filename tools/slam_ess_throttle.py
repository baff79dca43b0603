#!/usr/bin/env python
"""ESS-throttled resampling at large N: quality + latency A/B.

The reference resamples after EVERY update (`slam/mcl.cpp:232-239`); the
standard particle-filter refinement (Doucet et al.) resamples only when the
effective sample size drops below a threshold, which `MCLConfig.
ess_threshold` already implements (default 1.0 = reference-faithful always).
IF the converged cloud keeps ESS above N/2, the throttle skips most of the
resample work for free.

This tool settles the IF: closed-loop full SLAM (unknown map, mapping every
step, measurement='likelihood_field_table') on the floor-plan arc for each
threshold, reporting ATE, the measured resample-fire fraction (detected by
the post-step log-weight reset: resample() sets log_w uniform), and a
steady-state step-latency A/B from each run's final state (same process, so
run-to-run variation cancels).

    nohup setsid python -u tools/slam_ess_throttle.py --particles 1000000 \
        > /tmp/slam_ess.log 2>&1 &
    python tools/slam_ess_throttle.py --particles 4096 --steps 15 --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--thresholds", default="1.0,0.5")
    ap.add_argument("--lat-iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax
    import jax.numpy as jnp

    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.core.config import (
        LidarConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod, slam as slam_mod
    from slam_tpu.ops import motion
    from slam_tpu.ops.measurement import sensor_pose
    from slam_tpu.utils.metrics import ate_rmse

    blocked = jnp.asarray(synthetic_floor_plan())
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="sdf")
    start = Pose.create(400.0, 400.0, np.pi)
    odom = Odometry.create(0.02, 2.5, 0.02)

    scan_fn = jax.jit(
        lambda pose: fake_lidar.scan(blocked, pose, lidar, rc)
    )

    # Resample fired this step iff log_w was reset to uniform.
    fired_probe = jax.jit(lambda st: jnp.ptp(st.mcl.particles.log_weight) == 0)

    results = {}
    for thr in (float(t) for t in args.thresholds.split(",")):
        cfg = SLAMConfig(
            mcl=MCLConfig(
                n_particles=args.particles,
                meas_stddev=5.0,
                measurement="likelihood_field_table",
                ess_threshold=thr,
            ),
            lidar=lidar,
            motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
            raycast=rc,
        )
        engine = slam_mod.GridSLAM(cfg, seed=0)
        state = engine.init(start)
        key = jax.random.key(1)
        gt = start
        est_xy, gt_xy = [], []
        fires = 0
        for t in range(args.steps):
            k_gt, _ = jax.random.split(jax.random.fold_in(key, t))
            gt = motion.sample_motion_model_odometry(
                k_gt, odom, gt, cfg.motion.alphas
            )
            scan = scan_fn(sensor_pose(gt, cfg.mcl.scanner_offset))
            state = engine.step(state, odom, scan)
            fires += bool(fired_probe(state))
            mp = mcl_mod.mean_pose(state.mcl)
            est_xy.append([float(mp.x), float(mp.y)])
            gt_xy.append([float(gt.x), float(gt.y)])
        ate = float(ate_rmse(np.array(est_xy), np.array(gt_xy)))

        # Steady-state latency from the converged final state (fixed scan,
        # repeated step; same process for every threshold so drift cancels).
        scan0 = scan_fn(sensor_pose(gt, cfg.mcl.scanner_offset))
        st = engine.step(state, odom, scan0)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(args.lat_iters):
            st = engine.step(st, odom, scan0)
        jax.block_until_ready(st)
        step_ms = (time.perf_counter() - t0) / args.lat_iters * 1e3
        # Whether the steady-state loop's last step resampled (the branch
        # the latency number actually measured).
        lat_fired = bool(fired_probe(st))

        results[thr] = dict(
            ate_px=round(ate, 3),
            fire_frac=round(fires / args.steps, 3),
            steady_step_ms=round(step_ms, 2),
            steady_fired=lat_fired,
        )
        print(
            f"# ess_threshold={thr}: ATE {ate:.2f} px, resample fired "
            f"{fires}/{args.steps} steps, steady step {step_ms:.2f} ms "
            f"(fired={lat_fired})",
            file=sys.stderr,
        )

    print(json.dumps({
        "metric": f"slam_ess_throttle_{args.particles // 1000}k",
        "unit": "ms/step + px",
        "steps": args.steps,
        "results": {str(k): v for k, v in results.items()},
    }))


if __name__ == "__main__":
    main()
