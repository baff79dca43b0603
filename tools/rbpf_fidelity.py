#!/usr/bin/env python
"""RBPF fidelity mode at scale: per-particle maps on the real floor plan.

The reference's exact algorithm (`slam/pose.h:32-37` Particle{pose, weight,
map}, `slam/mcl.cpp:49-77` fused weight+map, `slam/mcl.cpp:205-227` map
copies on resample) tops out near 250 particles on CPU — each particle owns
a 599x1297 map and the copies become the bottleneck. This tool runs
slam_tpu's RBPF (`models/rbpf.py`, maps resampled by one batched gather) at
--particles N on the same deterministic trajectory as the C++ harness
(`tools/refbench/ref_mcl_traj.cpp`) and prints ATE + step time.

    python tools/rbpf_fidelity.py --particles 1000 --steps 120
    python tools/rbpf_fidelity.py --particles 64 --steps 25 --cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ap = argparse.ArgumentParser()
ap.add_argument("--particles", type=int, default=1000)
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--cpu", action="store_true")
ap.add_argument("--map", default="/root/reference/assets/floor_plan.png")
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("--json", action="store_true",
                help="emit one machine-readable JSON line (for pytest -m fidelity)")
args = ap.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from slam_tpu.core.config import LidarConfig, MCLConfig, RaycastConfig
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar, rbpf
from slam_tpu.ops.measurement import sensor_pose
from slam_tpu.utils.maps import load_binary_map
from slam_tpu.utils.metrics import ate_rmse

blocked = jnp.asarray(load_binary_map(args.map) == 0)
h, w = blocked.shape
cfg = MCLConfig(
    n_particles=args.particles,
    meas_stddev=5.0,
    scanner_offset=(0.0, 30.0, 0.0),
    resample="systematic",
)
rc = RaycastConfig(step=0.5, max_dist=500.0, backend="march")
lidar = LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0, n_rays=90)

engine = rbpf.RBPF(cfg, rc, seed=args.seed)
start = Pose.create(w / 2.0, h / 2.0, np.pi / 2)
state = engine.init(start, (h, w))

# The C++ harness's deterministic wander (ref_mcl_traj.cpp): rot1=0.01,
# trans=2.5, rot2=0.01 every step; scans are exact DDA off the true map.
odom = Odometry.create(0.01, 2.5, 0.01)
gt = start
est, gts = [], []
t_total, t0_all = 0.0, time.perf_counter()
for t in range(args.steps):
    th1 = gt.theta + 0.01
    gt = Pose.create(
        gt.x + 2.5 * jnp.cos(th1), gt.y + 2.5 * jnp.sin(th1), th1 + 0.01
    )
    sp = sensor_pose(gt, cfg.scanner_offset)
    scan = fake_lidar.scan(blocked, sp, lidar, rc)
    t0 = time.perf_counter()
    state = engine.step(state, odom, scan)
    np.asarray(jax.device_get(state.particles.log_weight[:1]))  # fence
    if t >= 2:  # skip compile steps
        t_total += time.perf_counter() - t0
    mp = rbpf.mean_pose(state)
    est.append([float(mp.x), float(mp.y)])
    gts.append([float(gt.x), float(gt.y)])

ate = ate_rmse(np.asarray(est), np.asarray(gts))
per_step = t_total / max(1, args.steps - 2)
print(
    f"RBPF fidelity: {args.particles} particles x {args.steps} steps on "
    f"{h}x{w} map ({jax.devices()[0].device_kind}): ATE {ate:.2f}px, "
    f"{per_step * 1e3:.0f} ms/step "
    f"({args.particles / per_step:,.0f} particle-updates/s), "
    f"total {time.perf_counter() - t0_all:.0f}s"
)
if args.json:
    import json

    print(json.dumps({
        "ate_px": round(float(ate), 3),
        "ms_per_step": round(per_step * 1e3, 1),
        "particles": args.particles,
        "steps": args.steps,
        "device": jax.devices()[0].device_kind,
    }))
