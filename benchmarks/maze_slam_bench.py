#!/usr/bin/env python
"""Full grid SLAM (unknown map, mapping every step) on the maze.

The last BASELINE.md config: big-map SLAM, where the EDT must be rebuilt
in-step (JFA over 2354x2464) because the map changes every scan — the
static-map LUT of `maze_bench.py` does not apply. Likelihood-field
measurement (no raycasting in the update). The map is
`simulate.synthetic_maze` at the reference maze's size unless ``--map``
names a PNG.

    python benchmarks/maze_slam_bench.py [--particles 10000] [--steps 40]

Emits one JSON line per measurement tier: maze_slam_step_ms_<N> with the
ATE and the device.
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
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--map", default=None,
                    help="maze PNG (default: the generated maze)")
    ap.add_argument(
        "--measurement",
        default="likelihood_field",
        help="comma list to A/B measurement tiers in ONE process (drift "
        "control): e.g. likelihood_field,likelihood_field_table — at "
        "2354x2464 the [T,H,W] table is ~0.8 GB per rebuild, so the "
        "100k-proven table tier is not obviously the big-map winner. "
        "A :N suffix sets lf_table_box (the round-4 box-localized build "
        "whose traffic is T*box^2, map-size-independent): "
        "likelihood_field_table:256. A :eN suffix sets SLAMConfig.edt_box "
        "(the round-5 incremental scan-localized EDT refresh): "
        "likelihood_field_table:128:e1024",
    )
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
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod, slam as slam_mod
    from slam_tpu.models.simulate import find_start, synthetic_maze
    from slam_tpu.ops import motion
    from slam_tpu.ops.measurement import sensor_pose
    from slam_tpu.utils.metrics import ate_rmse

    if args.map:
        from slam_tpu.utils.maps import load_binary_map

        blocked_np = np.asarray(load_binary_map(args.map) == 0)
    else:
        blocked_np = synthetic_maze()
    blocked = jnp.asarray(blocked_np)
    h, w = blocked.shape

    lidar = LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0, n_rays=90)

    sx, sy = find_start(blocked_np)
    odom = Odometry.create(0.02, 2.0, 0.02)

    for label in args.measurement.split(","):
        parts = label.split(":")
        meas, mods = parts[0], parts[1:]
        table_box = edt_box = None
        for mod in mods:
            if mod.startswith("e"):
                edt_box = int(mod[1:])
            elif mod:
                table_box = int(mod)
        cfg = SLAMConfig(
            mcl=MCLConfig(
                n_particles=args.particles,
                meas_stddev=5.0,
                measurement=meas,
                lf_table_box=table_box,
            ),
            map=MapConfig(height=h, width=w),
            lidar=lidar,
            motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
            raycast=RaycastConfig(step=1.0, max_dist=500.0, backend="sdf"),
            edt_box=edt_box,
        )
        engine = slam_mod.GridSLAM(cfg, seed=0)
        gt = Pose.create(sx, sy, 0.9)
        state = engine.init(gt)
        key = jax.random.key(3)

        est, gts = [], []
        t_meas = 0.0
        for t in range(args.steps):
            key, kgt = jax.random.split(key)
            gt = motion.sample_motion_model_odometry(
                kgt, odom, gt, jnp.asarray(cfg.motion.alphas)
            )
            sp = sensor_pose(gt, cfg.mcl.scanner_offset)
            scan = fake_lidar.scan(
                blocked, sp, lidar, RaycastConfig(max_dist=500.0)
            )
            t0 = time.perf_counter()
            state = engine.step(state, odom, scan)
            jax.block_until_ready(state.mcl.particles.log_weight)
            if t >= 2:
                t_meas += time.perf_counter() - t0
            mp = mcl_mod.mean_pose(state.mcl)
            est.append([float(mp.x), float(mp.y)])
            gts.append([float(gt.x), float(gt.y)])

        ate = ate_rmse(np.asarray(est), np.asarray(gts))
        per = t_meas / max(1, args.steps - 2)

        # Steady-state pipelined rate (one sync after the block) — the
        # methodology every other bench here uses. The per-step-synced
        # number above additionally pays one host round trip per step.
        # Two scans from slightly different poses, alternated: repeating
        # ONE scan converges the local map in a couple of iterations and
        # stops flipping blocked cells, which would let the round-5
        # incremental-EDT path measure its no-flip skip branch instead of
        # the window refresh it actually runs in operation. Alternating
        # keeps boundary cells flipping every step (a conservative,
        # flip-sustaining steady state for every tier).
        gt2 = Pose.create(gt.x + 3.0, gt.y + 3.0, gt.theta + 0.05)
        scans = [
            fake_lidar.scan(
                blocked, sensor_pose(p, cfg.mcl.scanner_offset), lidar,
                RaycastConfig(max_dist=500.0),
            )
            for p in (gt, gt2)
        ]
        st = engine.step(state, odom, scans[0])
        jax.block_until_ready(st.mcl.particles.log_weight)
        iters = 10
        t0 = time.perf_counter()
        for i in range(iters):
            st = engine.step(st, odom, scans[i % 2])
        jax.block_until_ready(st.mcl.particles.log_weight)
        pipe = (time.perf_counter() - t0) / iters

        prefix = "cpu_functional_check_" if device["platform"] == "cpu" else ""
        print(json.dumps({
            "metric": f"{prefix}maze_slam_step_ms_{args.particles}",
            "measurement": label,
            "value": round(pipe * 1e3, 2),
            "unit": "ms",
            "per_step_synced_ms": round(per * 1e3, 2),
            "ate_px": round(float(ate), 2),
            "device": device,
        }), flush=True)
        print(
            f"# maze SLAM {h}x{w} [{label}]: {args.particles} particles x "
            f"{args.steps} steps, {pipe*1e3:.1f} ms/step pipelined "
            f"({1/pipe:.1f} Hz; {per*1e3:.0f} ms with a host sync per "
            f"step), ATE {ate:.2f}px on {device['kind']}",
            file=sys.stderr,
        )


if __name__ == "__main__":
    main()
