#!/usr/bin/env python
"""Head-to-head trajectory quality vs the C++ reference — SLAM mode.

Run `tools/refbench/build.sh`, then
`.build/ref_mcl_traj <map> 200 120 2.5 0.02 > /tmp/ref_traj.jsonl` (several
times — the reference RNG is clock-seeded), then this script: it replays the
identical 120-step deterministic trajectory and exact-DDA scans
(`tools/refbench/ref_mcl_traj.cpp`; init convention `slam/mcl.cpp:22-39`)
through slam_tpu grid SLAM in BOTH configurations and prints each ATE:

  * parity   — 200 particles, march backend, beam measurement, mean pose
               (the configuration of the original recorded comparison);
  * flagship — likelihood_field_table measurement + correlative scan-matched
               `est_pose` (the round-3 fast path), at 200 and --flagship-n
               particles.

    python tools/quality_head_to_head_slam.py [ref1.jsonl ref2.jsonl ...]
        [--gpu] [--flagship-n 10000] [--steps 120] [--seeds 3]

Pass SEVERAL ref files: the reference's clock-seeded ATE is bimodal
(measured 1.3-24.7 px over 5 runs), so a single file is not a baseline.
Our side runs --seeds filter seeds per configuration for the same reason.
CPU by default (deterministic, matches the C++ machine); --gpu runs the
flagship configs on the GPU (the parity config stays CPU-comparable).
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ref", nargs="*", default=["/tmp/ref_traj.jsonl"],
                    help="reference trajectory jsonl files (length + ATE)")
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--flagship-n", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=None,
                    help="override step count (default: the ref file's)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="filter seeds per config on our side")
    args = ap.parse_args()

    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.core.config import (
        LidarConfig,
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        ScanMatchConfig,
        SLAMConfig,
    )
    from slam_tpu.models.simulate import run_slam_deterministic
    from slam_tpu.utils.maps import load_binary_map
    from slam_tpu.utils.metrics import ate_rmse

    n_steps = args.steps or 120
    ref_ate = None
    ref_ates = []
    for path in args.ref:
        if not os.path.exists(path):
            continue
        ref = [json.loads(l) for l in open(path)]
        n_steps = args.steps or len(ref)
        g = np.array([r["gt"][:2] for r in ref])
        ref_ates.append(ate_rmse(np.array([r["mean"] for r in ref]), g))
    if ref_ates:
        ref_ate = float(np.mean(ref_ates))
        print(
            f"C++ reference RBPF ATE over {len(ref_ates)} run(s): "
            f"mean {ref_ate:.2f} px, per-run "
            f"{[round(a, 2) for a in sorted(ref_ates)]}"
        )

    blocked = jnp.asarray(
        load_binary_map("/root/reference/assets/floor_plan.png") == 0
    )
    h, w = blocked.shape

    def cfg_for(n, flagship):
        mcl = MCLConfig(
            n_particles=n,
            meas_stddev=5.0,
            scanner_offset=(0.0, 30.0, 0.0),
            measurement="likelihood_field_table" if flagship else "beam",
        )
        return SLAMConfig(
            mcl=mcl,
            map=MapConfig(height=h, width=w),
            lidar=LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0,
                              n_rays=90),
            motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
            raycast=RaycastConfig(
                step=0.5 if not flagship else 1.0,
                max_dist=500.0,
                backend="sdf" if flagship else "march",
            ),
            scanmatch=ScanMatchConfig() if flagship else None,
        )

    runs = [
        ("parity_200 (march+beam, mean pose)", cfg_for(200, False), "mean"),
        ("flagship_200 (lf_table + scanmatch est_pose)",
         cfg_for(200, True), "sm"),
        (f"flagship_{args.flagship_n} (lf_table + scanmatch est_pose)",
         cfg_for(args.flagship_n, True), "sm"),
    ]
    for name, cfg, which in runs:
        ates, ates_mean = [], []
        for seed in range(args.seeds):
            res = run_slam_deterministic(
                blocked, cfg, n_steps, 2.5, 0.02, seed=seed
            )
            traj = res.est_xy if which == "mean" else res.sm_xy
            ates.append(float(ate_rmse(traj, res.gt_xy)))
            ates_mean.append(float(ate_rmse(res.est_xy, res.gt_xy)))
        rec = {
            "metric": f"h2h_slam_ate_px_{name.split(' ')[0]}",
            "value": round(float(np.mean(ates)), 2),
            "unit": "px",
            "per_seed": [round(a, 2) for a in ates],
            "mean_pose_ate_px": round(float(np.mean(ates_mean)), 2),
        }
        if ref_ate is not None:
            rec["vs_cpp_px"] = round(float(ref_ate), 2)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
