#!/usr/bin/env python
"""Head-to-head trajectory quality vs the C++ reference.

Run `tools/refbench/build.sh`, then
`.build/ref_mcl_traj <map> 200 120 2.5 0.02 > /tmp/ref_traj.jsonl`, then this
script: it replays the identical deterministic trajectory and exact-DDA scans
through the slam_tpu filter and prints both implementations' ATE.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np
from slam_tpu.core.config import LidarConfig, MCLConfig, RaycastConfig
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar, mcl as mcl_mod
from slam_tpu.ops import rayfield
from slam_tpu.ops.measurement import sensor_pose
from slam_tpu.utils.maps import load_binary_map
from slam_tpu.utils.metrics import ate_rmse

ref = [json.loads(l) for l in open(sys.argv[1] if len(sys.argv) > 1 else '/tmp/ref_traj.jsonl')]
gt_xy = np.array([r["gt"][:2] for r in ref])
ref_best = np.array([r["best"] for r in ref])
ref_mean = np.array([r["mean"] for r in ref])
print("reference ATE (best):", round(ate_rmse(ref_best, gt_xy), 2))
print("reference ATE (mean):", round(ate_rmse(ref_mean, gt_xy), 2))

blocked = jnp.asarray(load_binary_map('/root/reference/assets/floor_plan.png') == 0)
h, w = blocked.shape
lidar = LidarConfig(start=0.0, stop=2*np.pi, max_dist=500.0, n_rays=90)
rc = RaycastConfig(step=0.5, max_dist=500.0, backend="march")
field = blocked  # march: raw mask

for method in ["systematic", "multinomial"]:
    cfg = MCLConfig(n_particles=200, meas_stddev=5.0, scanner_offset=(0.,30.,0.), resample=method)
    m = mcl_mod.MCL(cfg, rc)
    # start pose = reference MCL::starting_pose = canvas center {w/2, h/2, pi/2}
    state = mcl_mod.init(jax.random.key(0), 200, Pose.create(w/2.0, h/2.0, np.pi/2))
    gt = Pose.create(w/2.0, h/2.0, np.pi/2)
    est_best, est_mean, gts = [], [], []
    odom = Odometry.create(0.01, 2.5, 0.01)
    alphas = (5e-4, 5e-4, 1e-2, 1e-2)
    for t in range(len(ref)):
        # deterministic gt, matching the C++ harness integration
        th1 = gt.theta + 0.01
        gt = Pose.create(gt.x + 2.5*jnp.cos(th1), gt.y + 2.5*jnp.sin(th1), th1 + 0.01)
        state = m.predict(state, odom, alphas)
        sp = sensor_pose(gt, cfg.scanner_offset)
        scan = fake_lidar.scan(blocked, sp, lidar, rc)
        state = m.update(state, scan, field)
        mp = mcl_mod.mean_pose(state)
        est_best.append([float(state.best_pose.x), float(state.best_pose.y)])
        est_mean.append([float(mp.x), float(mp.y)])
        gts.append([float(gt.x), float(gt.y)])
    gts = np.array(gts)
    print(f"ours ({method}) ATE (best):", round(ate_rmse(np.array(est_best), gts), 2))
    print(f"ours ({method}) ATE (mean):", round(ate_rmse(np.array(est_mean), gts), 2))
    # sanity: our gt must match the C++ harness's
    print("  gt match vs C++:", round(float(np.abs(gts - gt_xy).max()), 3))
