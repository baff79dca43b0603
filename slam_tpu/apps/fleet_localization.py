"""Multi-robot localization demo: a fleet of MCL filters on one map.

No reference equivalent (the C++ apps run one filter per process,
`apps/grid_slam.cpp`); this is the serving demo — every robot's
predict + panorama-fused update + resample advances in ONE device program
per step (`slam_tpu.models.fleet`). Each robot wanders independently
(wall-avoiding, like grid_slam's auto driver), localizes against the known
map, and the app reports per-robot ATE and renders all trajectories.

    python -m slam_tpu.apps.fleet_localization --map floor_plan.png \
        --robots 8 --particles 10000 --steps 100 --out fleet.png
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.apps.common import load_blocked
from slam_tpu.core.config import (
    LidarConfig,
    MCLConfig,
    RaycastConfig,
    beam_bin_stride,
)
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar, fleet
from slam_tpu.ops import rayfield
from slam_tpu.ops.measurement import sensor_pose
from slam_tpu.utils import render
from slam_tpu.utils.metrics import ate_rmse
from slam_tpu.utils.runtime import enable_compile_cache, require_gpu


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-robot MCL fleet demo")
    ap.add_argument("--map", required=True)
    ap.add_argument("--robots", type=int, default=8)
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--beams", type=int, default=90)
    ap.add_argument("--trans", type=float, default=2.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="image to write (nothing is written when absent)")
    ap.add_argument("--backend", default="lut", choices=["lut", "sdf", "march"])
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    print("device:", require_gpu(args.cpu))
    enable_compile_cache()

    blocked = jnp.asarray(load_blocked(args.map))
    h, w = blocked.shape
    lidar = LidarConfig(
        start=0.0, stop=np.pi, max_dist=500.0, n_rays=args.beams
    )
    rc = RaycastConfig(step=1.0, max_dist=500.0, backend=args.backend)
    cfg = MCLConfig(
        n_particles=args.particles,
        meas_stddev=5.0,
        lut_beam_stride=(
            beam_bin_stride(lidar, rc) if args.backend == "lut" else None
        ),
    )
    field = rayfield.make_ray_field(blocked, rc)
    alphas = (5e-4, 5e-4, 1e-2, 1e-2)

    # Spawn robots on free cells with a little clearance.
    rng = np.random.default_rng(args.seed)
    free_np = np.asarray(~np.asarray(blocked))
    ii, jj = np.nonzero(free_np[8:-8, 8:-8])
    picks = rng.choice(len(ii), size=args.robots, replace=False)
    gts = [
        Pose.create(
            float(jj[p] + 8) + 0.5,
            float(h - (ii[p] + 8)) - 0.5,
            float(rng.uniform(0, 2 * np.pi)),
        )
        for p in picks
    ]

    fl = fleet.MCLFleet(args.robots, cfg, rc, seed=args.seed)
    states = fl.init(jax.tree.map(lambda *x: jnp.stack(x), *gts))

    from slam_tpu.core.types import Scan
    from slam_tpu.ops import motion as motion_ops
    from slam_tpu.ops.raycast import raycast_march

    scan_rc = RaycastConfig(max_dist=500.0)
    beam_angles = jnp.asarray(lidar.angles, jnp.float32)

    # Whole-fleet ground-truth step in ONE device program (wall-avoiding
    # wander + batched exact-DDA scans) — per-robot eager simulation costs
    # 3R dispatches per step.
    @jax.jit
    def gt_step(key, gt: Pose):
        d, hit = raycast_march(
            blocked, gt.x, gt.y, gt.theta,
            step=1.0, max_dist=4.0 * args.trans, chunk=8,
        )
        rot = jnp.where(hit, 0.6, 0.0)
        tr = jnp.where(hit, args.trans * 0.4, args.trans)
        odoms = Odometry.create(rot, tr, rot)
        new_gt = motion_ops.sample_motion_model_odometry(
            key, odoms, gt, jnp.asarray(alphas)
        )
        sp = sensor_pose(new_gt, cfg.scanner_offset)
        dists, hits = raycast_march(
            blocked,
            sp.x[:, None],
            sp.y[:, None],
            sp.theta[:, None] + beam_angles[None, :],
            step=scan_rc.step,
            max_dist=lidar.max_dist,
            chunk=scan_rc.chunk,
        )
        dists = jnp.where(hits, dists, lidar.max_dist)
        scans = Scan(
            angles=jnp.broadcast_to(beam_angles, dists.shape), dists=dists
        )
        return new_gt, odoms, scans

    key = jax.random.key(args.seed + 1)
    gt = jax.tree.map(lambda *x: jnp.stack(x), *gts)  # Pose [R]
    trails_gt = [[] for _ in range(args.robots)]
    trails_est = [[] for _ in range(args.robots)]
    for t in range(args.steps):
        key, k = jax.random.split(key)
        gt, odoms, scans = gt_step(k, gt)
        states = fl.step(states, odoms, scans, field, alphas)
        mp = fleet.mean_poses(states)
        gx, gy = np.asarray(gt.x), np.asarray(gt.y)
        ex, ey = np.asarray(mp.x), np.asarray(mp.y)
        for q in range(args.robots):
            trails_gt[q].append([float(gx[q]), float(gy[q])])
            trails_est[q].append([float(ex[q]), float(ey[q])])

    ates = [
        ate_rmse(np.asarray(trails_est[q]), np.asarray(trails_gt[q]))
        for q in range(args.robots)
    ]
    for q, a in enumerate(ates):
        print(f"robot {q}: ATE {a:.2f}px")
    print(f"fleet mean ATE {np.mean(ates):.2f}px over {args.steps} steps")

    if args.out:
        # Render: map + one colored trail per robot (gt thin, estimate solid).
        palette = [
            render.RED, render.GREEN, render.BLUE, render.MAGENTA,
            render.CYAN, render.YELLOW, (255, 128, 0), (128, 0, 255),
        ]
        img = render.blocked_to_rgb(np.asarray(blocked))
        for q in range(args.robots):
            color = palette[q % len(palette)]
            faint = tuple(int(0.45 * c + 0.55 * 255) for c in color)
            render.draw_path_world(img, trails_gt[q], faint)
            render.draw_path_world(img, trails_est[q], color)
        render.save_png(img, args.out)
        print(f"wrote {args.out}")
    return np.mean(ates)


if __name__ == "__main__":
    main()
