#!/usr/bin/env python
"""Multi-robot MCL fleet throughput (models/fleet.py).

R independent filters share one floor-plan LUT; stacking the fleet
amortizes the per-step fixed costs, so throughput should rise with R like it
rises with N.

    python benchmarks/fleet_bench.py [--robots 8] [--particles 100000]

Prints per-R JSON lines, each naming the device.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from slam_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu(args.cpu)
    enable_compile_cache()

    from slam_tpu.core.config import (
        LidarConfig,
        MCLConfig,
        RaycastConfig,
        beam_bin_stride,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, fleet
    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.ops import rayfield
    from slam_tpu.ops.measurement import sensor_pose

    blocked = jnp.asarray(synthetic_floor_plan())
    h, w = blocked.shape
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    cfg = MCLConfig(
        n_particles=args.particles,
        meas_stddev=5.0,
        scanner_offset=(0.0, 30.0, 0.0),
        lut_beam_stride=beam_bin_stride(lidar, rc),
    )
    field = rayfield.make_ray_field(blocked, rc)
    alphas = (0.0005, 0.0005, 0.01, 0.01)
    odom = Odometry.create(2.5, 0.02, 0.02)

    rng = np.random.default_rng(0)
    for r in args.robots:
        fl = fleet.MCLFleet(r, cfg, rc, seed=0)
        # Spread robots around the map's open middle band.
        xs = rng.uniform(300, w - 300, r)
        ys = rng.uniform(200, h - 200, r)
        poses = Pose.create(
            jnp.asarray(xs, jnp.float32),
            jnp.asarray(ys, jnp.float32),
            jnp.full((r,), np.pi, jnp.float32),
        )
        scans = [
            fake_lidar.scan(
                blocked,
                sensor_pose(
                    Pose.create(float(xs[q]), float(ys[q]), np.pi),
                    cfg.scanner_offset,
                ),
                lidar,
                RaycastConfig(max_dist=500.0),
            )
            for q in range(r)
        ]
        scans_b = jax.tree.map(lambda *z: jnp.stack(z), *scans) if r > 1 else (
            jax.tree.map(lambda z: z[None], scans[0])
        )
        odoms_b = jax.tree.map(lambda *z: jnp.stack(z), *([odom] * r)) if r > 1 else (
            jax.tree.map(lambda z: z[None], odom)
        )
        states = fl.init(poses)
        for _ in range(3):
            states = fl.step(states, odoms_b, scans_b, field, alphas)
        jax.block_until_ready(states)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            states = fl.step(states, odoms_b, scans_b, field, alphas)
        jax.block_until_ready(states)
        dt = (time.perf_counter() - t0) / args.iters
        pu = r * args.particles / dt
        prefix = "cpu_functional_check_" if device["platform"] == "cpu" else ""
        print(json.dumps({
            "metric": f"{prefix}fleet_mcl_step_ms_r{r}",
            "value": round(dt * 1e3, 2),
            "unit": "ms",
            "device": device,
        }))
        print(
            f"# R={r} x {args.particles}: {dt*1e3:.1f} ms/fleet-step = "
            f"{dt*1e3/r:.2f} ms/robot-step ({pu:,.0f} particle-updates/s)",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
