#!/usr/bin/env python
"""Global localization at scale: uniform init over all free space, converge.

The capability the shared-map architecture unlocks and the reference
cannot touch: global localization NEEDS particle density over the whole
pose space (the notebook prototype, SURVEY.md item 23, ran it at toy
sizes; the C++ RBPF tops out near 250 particles because every particle
carries a map). Here 100k-1M particles initialize uniformly over the
floor plan's free cells with uniform headings (`mcl.init_uniform`), weight
against the known map with the panorama-fused LUT beam model, and the run
reports the step at which the filter commits to the true pose (cloud
spread < 20 px and mean error < 10 px), the post-convergence ATE, and the
per-step latency.

    nohup setsid python -u tools/global_loc_bench.py --particles 1000000 \
        > /tmp/global_loc.log 2>&1 &
    python tools/global_loc_bench.py --particles 20000 --steps 20 --cpu
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
    ap.add_argument("--seeds", type=int, default=3)
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
        beam_bin_stride,
    )
    from slam_tpu.core.types import Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod, simulate
    from slam_tpu.ops import motion, rayfield
    from slam_tpu.ops.measurement import sensor_pose

    blocked = jnp.asarray(synthetic_floor_plan())
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut")
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=args.particles,
            meas_stddev=5.0,
            lut_beam_stride=beam_bin_stride(lidar, rc),
        ),
        lidar=lidar,
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=rc,
    )
    field = rayfield.make_ray_field(blocked, rc)  # disk-cached LUT
    m = mcl_mod.MCL(cfg.mcl, rc)
    scan_jit = jax.jit(
        lambda p: fake_lidar.scan(
            blocked, p, lidar, RaycastConfig(step=0.5, max_dist=500.0)
        )
    )
    probe = jax.jit(
        lambda st: (
            jnp.std(st.particles.pose.x),
            jnp.std(st.particles.pose.y),
        )
    )

    runs = []
    for seed in range(args.seeds):
        key = jax.random.key(seed)
        st = mcl_mod.init_uniform(key, args.particles, blocked)
        gt = Pose.create(400.0, 400.0, np.pi)
        cmds = simulate.forward_arc_commands(args.steps, trans=2.5, rot=0.04)
        k_gt = jax.random.key(seed + 100)
        converged_at = None
        errs_after = []
        step_ms = []
        for t, odom in enumerate(cmds):
            kg, _ = jax.random.split(jax.random.fold_in(k_gt, t))
            gt = motion.sample_motion_model_odometry(
                kg, odom, gt, cfg.motion.alphas
            )
            scan = scan_jit(sensor_pose(gt, cfg.mcl.scanner_offset))
            t0 = time.perf_counter()
            st = m.predict(st, odom, cfg.motion.alphas)
            st = m.update(st, scan, field)
            jax.block_until_ready(st)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            mp = mcl_mod.mean_pose(st)
            err = float(
                np.hypot(float(mp.x) - float(gt.x), float(mp.y) - float(gt.y))
            )
            sx, sy = (float(v) for v in probe(st))
            if converged_at is None and max(sx, sy) < 20.0 and err < 10.0:
                converged_at = t + 1
            if converged_at is not None:
                errs_after.append(err)
        ate = float(np.sqrt(np.mean(np.square(errs_after)))) if errs_after else None
        runs.append({
            "converged_at_step": converged_at,
            "post_convergence_ate_px": round(ate, 2) if ate else None,
            "median_step_ms": round(float(np.median(step_ms)), 2),
        })
        print(
            f"# seed {seed}: converged at step {converged_at}, "
            f"post-convergence ATE {ate and round(ate, 2)} px, median step "
            f"{runs[-1]['median_step_ms']} ms",
            file=sys.stderr,
        )

    print(json.dumps({
        "metric": f"global_localization_{args.particles // 1000}k",
        "unit": "steps + px + ms",
        "steps": args.steps,
        "runs": runs,
    }))


if __name__ == "__main__":
    main()
