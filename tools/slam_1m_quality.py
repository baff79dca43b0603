#!/usr/bin/env python
"""Closed-loop SLAM quality at large N under the correlative-table
measurement (measurement='likelihood_field_table') against the direct
likelihood field.

Runs full SLAM (unknown map, mapping every step) on the floor plan over a
scripted arc for BOTH measurement models at --particles, reporting ATE —
the evidence that the table path keeps the direct model's ATE bounds.

    nohup setsid python -u tools/slam_1m_quality.py --particles 1000000 \
        > /tmp/slam_1m_quality.log 2>&1 &
    python tools/slam_1m_quality.py --particles 4096 --steps 15 --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--table-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--map-pose", default="mean,best",
                    help="comma list: SLAMConfig.map_pose values to A/B")
    ap.add_argument("--l-occ", type=float, default=None,
                    help="override MapConfig.l_occ (map plasticity A/B)")
    ap.add_argument("--l-free", type=float, default=None)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--measurements",
                    default="likelihood_field,likelihood_field_table")
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
    from slam_tpu.core.types import Pose
    from slam_tpu.models import simulate
    from slam_tpu.utils.metrics import ate_rmse

    blocked = jnp.asarray(synthetic_floor_plan())
    h, w = blocked.shape
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="sdf")
    pose = Pose.create(400.0, 400.0, np.pi)
    commands = simulate.forward_arc_commands(args.steps, trans=2.5, rot=0.04)

    out = {}
    for meas in args.measurements.split(","):
        for mp in args.map_pose.split(","):
            ates = []
            for seed in range(args.seeds):
                from slam_tpu.core.config import MapConfig

                map_kw = {}
                if args.l_occ is not None:
                    map_kw["l_occ"] = args.l_occ
                if args.l_free is not None:
                    map_kw["l_free"] = args.l_free
                cfg = SLAMConfig(
                    mcl=MCLConfig(
                        n_particles=args.particles,
                        meas_stddev=5.0,
                        measurement=meas,
                        lf_table_dtype=args.table_dtype,
                    ),
                    map=MapConfig(**map_kw),
                    lidar=lidar,
                    motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
                    raycast=rc,
                    map_pose=mp,
                )
                res = simulate.run_slam(blocked, cfg, commands, pose,
                                        seed=seed)
                ates.append(float(ate_rmse(res.est_xy, res.gt_xy)))
            out[f"{meas}/{mp}"] = [round(a, 3) for a in ates]
            print(f"# {meas} map_pose={mp}: ATE "
                  f"{[round(a, 2) for a in ates]} px over {args.steps} "
                  f"steps at N={args.particles}", file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": f"slam_quality_ate_px_{args.particles // 1000}k",
        "unit": "px",
        "results": out,
        "steps": args.steps,
        "table_dtype": args.table_dtype,
    }))


if __name__ == "__main__":
    main()
