"""SLAM + online replanning: the closed navigation loop (capstone demo).

The reference ships grid SLAM (`apps/grid_slam.cpp:110-170`) and planner
apps (`apps/hastar_planner.cpp`, `apps/rrt_planner.cpp`) but never couples
them; BASELINE.md's stretch config — sharded SLAM + online replanning — is
exactly that coupling. This app closes the loop on one engine stack:

    sense (fake lidar on the ground-truth map)
      -> SLAM step (boxed correlative table, optional incremental EDT)
      -> every k updates: threshold the evolving log-odds grid, inflate by
         the vehicle radius (erode), lattice Hybrid A* from the current
         estimate to the goal (planner tables REBUILT on the fresh map)
      -> follow: steer toward a lookahead waypoint on the latest path
      -> actuate with motor noise; repeat until the goal is reached.

Unknown cells (log-odds ~ 0) plan as FREE (optimistic exploration — the
standard frontier assumption); replans repair the path as walls appear.

    python -m slam_tpu.apps.slam_replan --cpu            # smoke (room)
    python -m slam_tpu.apps.slam_replan --map assets/floor_plan.png \
        --particles 100000 --replan-every 10 --n-rays 90  # GPU demo

Emits one JSON line: combined step rate, SLAM step ms, replan latency ms,
goal outcome and the device; renders the traversed trajectory + final
map/path to --out when given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np


def wrap_angle(a):
    return (a + math.pi) % (2.0 * math.pi) - math.pi


def cell_to_world(h, i, j):
    return j + 0.5, h - i - 0.5


def pick_waypoint(path, h, x, y, lookahead):
    """Pure-pursuit target: the first cell >= `lookahead` ahead of the
    path point NEAREST the robot. Searching from the path start instead
    would pick cells the robot already passed (between replans the path
    head falls up to replan_every*speed behind), steering it backward
    into a limit-cycle wiggle."""
    pts = [cell_to_world(h, i, j) for i, j in path]
    near = min(range(len(pts)),
               key=lambda k: (pts[k][0] - x) ** 2 + (pts[k][1] - y) ** 2)
    for wx, wy in pts[near:]:
        if math.hypot(wx - x, wy - y) >= lookahead:
            return wx, wy
    return pts[-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None, help="ground-truth PNG (synthetic room if absent)")
    ap.add_argument("--size", type=int, default=192, help="synthetic room size when --map is absent")
    ap.add_argument("--particles", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=600, help="frame budget")
    ap.add_argument("--replan-every", type=int, default=10)
    ap.add_argument("--goal", type=float, nargs=2, default=None, help="world x y (default: far corner free cell)")
    ap.add_argument("--start", type=float, nargs=2, default=None)
    ap.add_argument("--radius", type=int, default=3, help="vehicle inflation radius (cells)")
    ap.add_argument("--tol", type=float, default=6.0, help="goal tolerance (world units)")
    ap.add_argument("--speed", type=float, default=2.5)
    ap.add_argument("--lookahead", type=float, default=8.0)
    ap.add_argument("--n-rays", type=int, default=60)
    ap.add_argument("--max-dist", type=float, default=150.0)
    ap.add_argument("--table-box", type=int, default=128)
    ap.add_argument("--edt-box", type=int, default=0,
                    help="SLAMConfig.edt_box (0 = rebuild per step)")
    ap.add_argument("--theta-res", type=int, default=24)
    ap.add_argument("--planner-batch", type=int, default=256)
    ap.add_argument("--max-rounds", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="PNG of the final map/path")
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from slam_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu(args.cpu)
    enable_compile_cache()

    from slam_tpu.apps.common import inflate, load_blocked
    from slam_tpu.core.config import (
        HybridAStarConfig,
        LidarConfig,
        MapConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, slam as slam_mod
    from slam_tpu.ops import motion as motion_ops
    from slam_tpu.planners import HybridAStar
    from slam_tpu.utils import render

    gt_blocked_np = np.asarray(load_blocked(args.map, args.size, args.size))
    h, w = gt_blocked_np.shape
    gt_blocked = jnp.asarray(gt_blocked_np)

    free_cells = np.argwhere(~gt_blocked_np)

    def nearest_free(x, y):
        d = np.abs(free_cells[:, 0] - (h - y)) + np.abs(free_cells[:, 1] - x)
        i, j = free_cells[np.argmin(d)]
        return cell_to_world(h, i, j)

    if args.start is None:
        sx, sy = nearest_free(w * 0.2, h * 0.2)
    else:
        sx, sy = nearest_free(*args.start)
    if args.goal is None:
        gx, gy = nearest_free(w * 0.8, h * 0.8)
    else:
        gx, gy = nearest_free(*args.goal)

    lidar = LidarConfig(max_dist=args.max_dist, n_rays=args.n_rays)
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=args.particles,
            meas_stddev=5.0,
            measurement="likelihood_field_table",
            lf_table_box=args.table_box or None,
        ),
        map=MapConfig(height=h, width=w),
        lidar=lidar,
        motion=MotionConfig(alphas=(5e-4, 5e-4, 5e-3, 5e-3)),
        raycast=RaycastConfig(step=1.0, max_dist=args.max_dist, backend="sdf"),
        map_pose="auto",
        edt_box=args.edt_box or None,
    )
    hcfg = HybridAStarConfig(
        velocity=max(4.0, args.speed * 2),
        theta_res=args.theta_res,
        branching_factor=3,
        tol=max(args.tol, 4.0),
        mode="lattice",
        batch=args.planner_batch,
        heuristic_weight=1.3,
    )

    engine = slam_mod.GridSLAM(cfg, seed=args.seed)
    gt = Pose.create(sx, sy, math.atan2(gy - sy, gx - sx))
    state = engine.init(gt)
    goal_pose = Pose.create(gx, gy, 0.0)
    key = jax.random.key(args.seed + 17)

    planner = None
    path = []
    replan_ms = []
    slam_s = 0.0
    reached = False
    traj_est, traj_gt = [], []
    # Map passed as an ARG, not closed over (CLAUDE.md: closing large
    # arrays into jit stalls compilation — the map is a traced input).
    scan_fn = jax.jit(
        lambda b, p, k: fake_lidar.scan(b, p, lidar, cfg.raycast, key=k)
    )

    def fetch_pose(p):
        # One host fetch for all three scalars.
        x, y, th = jax.device_get((p.x, p.y, p.theta))
        return float(x), float(y), float(th)

    t_all0 = time.perf_counter()
    steps_done = 0
    for t in range(args.steps):
        # --- plan / replan on the EVOLVING estimated map -----------------
        if t % args.replan_every == 0:
            ex, ey, eth = fetch_pose(state.est_pose)
            t0 = time.perf_counter()
            est_blocked = np.asarray(state.grid > 0.0)
            est_blocked = inflate(est_blocked, args.radius)
            a = Pose.create(ex, ey, eth)
            b = Pose.create(gx, gy, 0.0)
            if planner is None:
                planner = HybridAStar(jnp.asarray(~est_blocked), a, b, hcfg)
            else:
                planner.reset(jnp.asarray(~est_blocked), a, b)
            ok = planner.solve(max_rounds=args.max_rounds)
            new_path = planner.recover_path() if ok else []
            replan_ms.append((time.perf_counter() - t0) * 1e3)
            if new_path:
                path = new_path

        # --- follow ------------------------------------------------------
        ex, ey, eth = fetch_pose(state.est_pose)
        if math.hypot(gx - ex, gy - ey) <= args.tol:
            reached = True
            steps_done = t
            break
        if path:
            wx, wy = pick_waypoint(path, h, ex, ey, args.lookahead)
        else:
            wx, wy = gx, gy
        err = wrap_angle(math.atan2(wy - ey, wx - ex) - eth)
        rot1 = float(np.clip(err, -0.35, 0.35))
        trans = args.speed if abs(err) < 1.0 else args.speed * 0.3
        odom = Odometry.create(rot1, trans, 0.0)

        # --- actuate (noisy), sense, SLAM --------------------------------
        key, k1, k2 = jax.random.split(key, 3)
        gt = motion_ops.sample_motion_model_odometry(
            k1, odom, gt, jnp.asarray(cfg.motion.alphas)
        )
        scan = scan_fn(gt_blocked, gt, k2)
        t0 = time.perf_counter()
        state = engine.step(state, odom, scan)
        if t >= 2:
            jax.block_until_ready(state.mcl.particles.log_weight)
            slam_s += time.perf_counter() - t0
        traj_est.append([ex, ey])
        gtx, gty, _ = fetch_pose(gt)
        traj_gt.append([gtx, gty])
        steps_done = t + 1

    wall = time.perf_counter() - t_all0
    slam_ms = slam_s / max(1, steps_done - 2) * 1e3
    final_err = math.hypot(gx - float(state.est_pose.x), gy - float(state.est_pose.y))
    gt_err = math.hypot(gx - float(gt.x), gy - float(gt.y))

    # --- render -----------------------------------------------------------
    if args.out:
        img = render.blocked_to_rgb(np.asarray(state.grid > 0.0))
        for i, j in path:
            if 0 <= i < h and 0 <= j < w:
                img[i, j] = render.BLUE
        for x, y in traj_gt:
            ii, jj = int(h - y), int(x)
            if 0 <= ii < h and 0 <= jj < w:
                img[ii, jj] = render.GREEN
        for x, y in traj_est:
            ii, jj = int(h - y), int(x)
            if 0 <= ii < h and 0 <= jj < w:
                img[ii, jj] = render.RED
        render.draw_disc(img, int(h - gy), int(gx), 3, render.MAGENTA)
        render.save_png(img, args.out)

    print(json.dumps({
        "metric": "slam_replan_combined_hz",
        "value": round(steps_done / wall, 2),
        "unit": "Hz",
        "steps": steps_done,
        "reached": bool(reached),
        "final_est_err": round(final_err, 2),
        "final_gt_err": round(gt_err, 2),
        "slam_step_ms": round(slam_ms, 2),
        "replan_ms_mean": round(float(np.mean(replan_ms)), 1),
        "replan_ms_max": round(float(np.max(replan_ms)), 1),
        "n_replans": len(replan_ms),
        "device": device,
    }), flush=True)
    print(
        f"# slam+replan {h}x{w}: {steps_done} steps in {wall:.1f}s "
        f"({steps_done / wall:.1f} Hz combined), SLAM {slam_ms:.1f} ms/step, "
        f"replan {np.mean(replan_ms):.0f} ms x {len(replan_ms)}, "
        f"goal {'REACHED' if reached else 'not reached'} "
        f"(est err {final_err:.1f}, gt err {gt_err:.1f}) on {device['kind']}",
        file=sys.stderr,
    )
    return 0 if reached else 1


if __name__ == "__main__":
    sys.exit(main())
