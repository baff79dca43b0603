#!/usr/bin/env python
"""Resample-every-k at large N: quality + latency A/B.

The ESS throttle was measured useless at 1M (tools/slam_ess_throttle.py: the
90-beam weights concentrate so hard that ESS < N/2 on 59/60 steps — the gate
fires anyway). `MCLConfig.resample_every` is the throttle that skips the
resample WORK unconditionally on k-1 of every k updates, log-weights
accumulating across the skipped steps (the textbook alternative the
reference's always-resample loop `slam/mcl.cpp:232-239` doesn't have) — worth
having IF the closed-loop ATE holds at the 3.5 px level.

Same-process sweep (run-to-run variation cancels): closed-loop full SLAM (unknown
map, mapping every step, measurement='likelihood_field_table') per k,
reporting ATE, measured fire fraction, and steady-state sustained step
latency averaged over the k-cycle.

    nohup setsid python -u tools/slam_resample_every.py --particles 1000000 \
        > /tmp/slam_rsk.log 2>&1 &
    python tools/slam_resample_every.py --particles 4096 --steps 15 --cpu
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
    ap.add_argument("--every", default="1,2,4")
    ap.add_argument("--lat-iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

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

    scan_fn = jax.jit(lambda pose: fake_lidar.scan(blocked, pose, lidar, rc))

    # Resample fired this step iff log_w was reset to uniform.
    fired_probe = jax.jit(
        lambda st: jnp.ptp(st.mcl.particles.log_weight) == 0
    )

    results = {}
    for k_every in (int(t) for t in args.every.split(",")):
        cfg = SLAMConfig(
            mcl=MCLConfig(
                n_particles=args.particles,
                meas_stddev=5.0,
                measurement="likelihood_field_table",
                resample_every=k_every,
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

        # Sustained latency over full k-cycles so the fired/skipped mix is
        # exactly the production mix (lat_iters should be a multiple of k).
        iters = args.lat_iters - (args.lat_iters % k_every)
        scan0 = scan_fn(sensor_pose(gt, cfg.mcl.scanner_offset))
        st = engine.step(state, odom, scan0)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(iters):
            st = engine.step(st, odom, scan0)
        jax.block_until_ready(st)
        step_ms = (time.perf_counter() - t0) / iters * 1e3

        results[k_every] = dict(
            ate_px=round(ate, 3),
            fire_frac=round(fires / args.steps, 3),
            steady_step_ms=round(step_ms, 2),
        )
        print(
            f"# resample_every={k_every}: ATE {ate:.2f} px, fired "
            f"{fires}/{args.steps}, sustained step {step_ms:.2f} ms",
            file=sys.stderr,
        )

    print(json.dumps({
        "metric": f"slam_resample_every_{args.particles // 1000}k",
        "unit": "ms/step + px",
        "steps": args.steps,
        "results": {str(k): v for k, v in results.items()},
    }))


if __name__ == "__main__":
    main()
