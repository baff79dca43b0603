#!/usr/bin/env python
"""Correlative scan-matching refinement: closed-loop quality + latency A/B.

Runs full SLAM (unknown map, mapping every step, correlative-table
measurement) on the floor-plan arc with the scan-matching refinement
(slam_tpu.ops.scanmatch) off / output-only / output+mapping, reporting the
mean-pose, best-particle, and scan-matched ATEs per variant plus the
steady-state step latency (the refinement's cost is particle-count-
independent, so the delta should be small and flat in N).

    nohup setsid python -u tools/slam_scanmatch_quality.py \
        --particles 100000 > /tmp/slam_sm.log 2>&1 &
    python tools/slam_scanmatch_quality.py --particles 2048 --steps 12 --cpu
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
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--lat-iters", type=int, default=20)
    ap.add_argument("--rot", type=float, default=0.04)
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
        ScanMatchConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, simulate, slam as slam_mod
    from slam_tpu.utils.metrics import ate_rmse

    blocked = jnp.asarray(synthetic_floor_plan())
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="sdf")
    start = Pose.create(400.0, 400.0, np.pi)
    cmds = simulate.forward_arc_commands(args.steps, trans=2.5, rot=args.rot)

    def cfg(sm):
        return SLAMConfig(
            mcl=MCLConfig(
                n_particles=args.particles,
                meas_stddev=5.0,
                measurement="likelihood_field_table",
            ),
            lidar=lidar,
            motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
            raycast=rc,
            scanmatch=sm,
        )

    variants = [
        ("off", None),
        ("out_only", ScanMatchConfig(mapping=False)),
        ("out_map", ScanMatchConfig(mapping=True)),
    ]
    out = {}
    for name, sm in variants:
        c = cfg(sm)
        ates = {"mean": [], "best": [], "sm": []}
        for seed in range(args.seeds):
            res = simulate.run_slam(blocked, c, cmds, start, seed=seed)
            ates["mean"].append(ate_rmse(res.est_xy, res.gt_xy))
            ates["best"].append(ate_rmse(res.best_xy, res.gt_xy))
            ates["sm"].append(ate_rmse(res.sm_xy, res.gt_xy))
        # Steady-state latency from the last run's final state.
        st = res.final_state
        engine = slam_mod.GridSLAM(c, seed=0)
        odom = Odometry.create(args.rot / 2, 2.5, args.rot / 2)
        from slam_tpu.ops.measurement import sensor_pose

        gt = Pose.create(
            float(res.gt_xy[-1][0]), float(res.gt_xy[-1][1]), np.pi
        )
        scan = fake_lidar.scan(
            blocked, sensor_pose(gt, c.mcl.scanner_offset), lidar, rc
        )
        st = engine.step(st, odom, scan)
        jax.block_until_ready(st)
        t0 = time.perf_counter()
        for _ in range(args.lat_iters):
            st = engine.step(st, odom, scan)
        jax.block_until_ready(st)
        step_ms = (time.perf_counter() - t0) / args.lat_iters * 1e3
        out[name] = {
            **{k: round(float(np.mean(v)), 2) for k, v in ates.items()},
            "step_ms": round(step_ms, 2),
        }
        print(
            f"# {name}: ATE mean {out[name]['mean']} / best "
            f"{out[name]['best']} / sm {out[name]['sm']} px; steady step "
            f"{out[name]['step_ms']} ms ({args.seeds} seeds)",
            file=sys.stderr,
        )

    print(json.dumps({
        "metric": f"slam_scanmatch_ate_{args.particles // 1000}k",
        "unit": "px + ms/step",
        "steps": args.steps,
        "seeds": args.seeds,
        "results": out,
    }))


if __name__ == "__main__":
    main()
