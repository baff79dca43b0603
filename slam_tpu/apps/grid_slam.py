"""Grid-SLAM demo app (headless rebuild of `apps/grid_slam.cpp`).

The reference opens an OpenCV window and turns arrow keys into odometry
(`apps/grid_slam.cpp:38-67`); ground truth advances through the same noisy
motion model (`:134-135`), the fake lidar scans the ground-truth map
(`:144-146`), `mcl.predict` runs every frame and `mcl.update` every k-th
(`:132,142-168`), and the best particle's map + the particle cloud are drawn
(`:112-127`).

This app does the same loop headlessly: commands come from a scripted driver
(auto wall-avoiding wander or a --commands file of `rot1 trans rot2` lines,
or interactive stdin w/a/s/d), and frames are written to an animated GIF with
the estimated map, particle cloud, mean/best poses, and ground truth. ATE is
reported at the end.

    python -m slam_tpu.apps.grid_slam --map assets/floor_plan.png \
        --particles 1000 --steps 200 --out slam.gif
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.apps.common import load_blocked
from slam_tpu.core import grid as gridlib
from slam_tpu.core.config import (
    LidarConfig,
    MapConfig,
    MCLConfig,
    MotionConfig,
    RaycastConfig,
    ScanMatchConfig,
    SLAMConfig,
)
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar, mcl as mcl_mod, slam as slam_mod
from slam_tpu.ops import motion as motion_ops
from slam_tpu.ops.measurement import sensor_pose
from slam_tpu.utils import render
from slam_tpu.utils.metrics import ate_rmse
from slam_tpu.utils.runtime import enable_compile_cache, require_gpu


def auto_commands(step_idx, gt_pose, blocked, trans, key):
    """Wall-avoiding wander: forward unless a short raycast ahead hits."""
    from slam_tpu.ops.raycast import raycast_march

    d, hit = raycast_march(
        jnp.asarray(blocked), gt_pose.x, gt_pose.y, gt_pose.theta,
        step=1.0, max_dist=4.0 * trans, chunk=8,
    )
    turn = jax.random.uniform(key, (), minval=0.3, maxval=0.9)
    if bool(hit):
        return Odometry.create(float(turn), trans * 0.4, float(turn))
    return Odometry.create(0.0, trans, 0.0)


def keyboard_command(trans, rot):
    """w/a/s/d from stdin -> odometry (`apps/grid_slam.cpp:38-67`)."""
    ch = sys.stdin.readline().strip()[:1].lower()
    if ch == "w":
        return Odometry.create(0.0, trans, 0.0)
    if ch == "s":
        return Odometry.create(0.0, -trans, 0.0)
    if ch == "a":
        return Odometry.create(rot / 2, 0.0, rot / 2)
    if ch == "d":
        return Odometry.create(-rot / 2, 0.0, -rot / 2)
    if ch == "q":
        return None
    return Odometry.create(0.0, 0.0, 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None, help="ground-truth PNG (synthetic room if absent)")
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--update-every", type=int, default=1, help="EVERY_OTHER throttle")
    ap.add_argument("--trans", type=float, default=2.5)
    ap.add_argument("--mode", choices=["slam", "loc"], default="slam")
    ap.add_argument("--backend", default="sdf", choices=["march", "sdf", "lut"])
    ap.add_argument(
        "--measurement",
        default="beam",
        choices=["beam", "likelihood_field", "likelihood_field_table",
                 "likelihood_field_auto"],
    )
    ap.add_argument("--table-box", type=int, default=0,
                    help="lf_table_box for the table measurement (0 = dense "
                    "build; 128 = the 1M production setting)")
    ap.add_argument("--n-rays", type=int, default=60)
    ap.add_argument("--max-dist", type=float, default=200.0)
    ap.add_argument("--scanner-offset", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="animated GIF to write (no frames are drawn when absent)")
    ap.add_argument("--frame-every", type=int, default=2)
    ap.add_argument("--interactive", action="store_true", help="read w/a/s/d from stdin")
    ap.add_argument("--commands", default=None, help="file of 'rot1 trans rot2' lines")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save rolling orbax checkpoints here and resume if present")
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument(
        "--scanmatch", action="store_true",
        help="correlative scan-matching pose refinement (SLAM mode): the "
        "output estimate (and the mapping pose) is the local likelihood-"
        "field peak around the best particle (ops/scanmatch.py)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    print("device:", require_gpu(args.cpu))
    enable_compile_cache()

    blocked_np = load_blocked(args.map)
    blocked = jnp.asarray(blocked_np)
    h, w = blocked.shape

    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=args.particles,
            meas_stddev=5.0,
            scanner_offset=tuple(args.scanner_offset),
            measurement=args.measurement,
            lf_table_box=args.table_box or None,
        ),
        map=MapConfig(height=h, width=w),
        lidar=LidarConfig(n_rays=args.n_rays, max_dist=args.max_dist, stddev=5.0),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=1.0, max_dist=args.max_dist, backend=args.backend),
        scanmatch=ScanMatchConfig() if args.scanmatch else None,
    )

    start = Pose.create(w / 2.0, h / 2.0, np.pi / 2)
    key = jax.random.key(args.seed)

    engine = slam_mod.GridSLAM(cfg, seed=args.seed)
    state = engine.init(start)
    loc_field = None
    if args.mode == "loc":
        from slam_tpu.models.mcl import MCL
        from slam_tpu.ops import rayfield

        mcl_engine = MCL(cfg.mcl, cfg.raycast)
        mcl_state = mcl_mod.init(key, args.particles, start)
        loc_field = rayfield.make_ray_field(blocked, cfg.raycast)

    refine_fn = None
    if args.scanmatch and args.mode == "loc":
        from slam_tpu.ops import edt as edtlib, rayfield as rf_mod, scanmatch

        sm_field = loc_field
        if sm_field.edt is None:
            sm_field = rf_mod.RayField(
                blocked=blocked,
                edt=edtlib.edt_capped(
                    blocked, 5.0 * cfg.mcl.meas_stddev + 2.0
                ),
            )
        refine_fn = jax.jit(
            lambda p, z: scanmatch.refine_pose(
                sm_field,
                p,
                z,
                rc=cfg.raycast,
                cfg=cfg.scanmatch,
                scanner_offset=cfg.mcl.scanner_offset,
                stddev=cfg.mcl.meas_stddev,
                z_hit=cfg.mcl.lf_z_hit,
                z_rand=cfg.mcl.lf_z_rand,
            )[0]
        )

    scripted = None
    if args.commands:
        with open(args.commands) as f:
            scripted = [
                Odometry.create(*map(float, line.split())) for line in f if line.strip()
            ]

    ckpt_mgr = None
    start_step = 0
    if args.checkpoint_dir and args.mode == "slam":
        from slam_tpu.utils import checkpoint as ckpt_lib

        ckpt_mgr = ckpt_lib.CheckpointManager(args.checkpoint_dir)

    gt_pose = start
    if ckpt_mgr is not None and ckpt_mgr.latest_step() is not None:
        # The sim's ground truth AND the host loop key ride along so a
        # resumed run continues the same trajectory and noise stream as an
        # uninterrupted one (a real deployment would only carry `state`).
        payload = ckpt_mgr.restore({"state": state, "gt": gt_pose, "key": key})
        # Re-derive the EDT cache from the RESTORED grid: a migrated
        # old-format checkpoint fills derived leaves from the template
        # (the fresh empty-map EDT), which would leave the incremental
        # refresh silently blind to the restored map. No-op when
        # cfg.edt_box is unset or the checkpoint carried a consistent
        # cache shape (the rebuild is one capped transform, ~ms).
        state = slam_mod.rebuild_edt(payload["state"], cfg)
        gt_pose = payload["gt"]
        key = payload["key"]
        start_step = int(ckpt_mgr.latest_step()) + 1
        print(f"resumed from step {start_step - 1}")
    frames, est_xy, gt_xy = [], [], []
    last_scan = None
    for t in range(start_step, args.steps if not scripted else len(scripted)):
        key, k_gt, k_cmd = jax.random.split(key, 3)
        if args.interactive:
            odom = keyboard_command(args.trans, 0.4)
            if odom is None:
                break
        elif scripted:
            odom = scripted[t]
        else:
            odom = auto_commands(t, gt_pose, blocked_np, args.trans, k_cmd)

        # Ground truth moves through the same noisy model (`:134-135`).
        gt_pose = motion_ops.sample_motion_model_odometry(
            k_gt, odom, gt_pose, cfg.motion.alphas
        )

        if (t + 1) % args.update_every == 0:
            sp = sensor_pose(gt_pose, cfg.mcl.scanner_offset)
            scan = last_scan = fake_lidar.scan(
                blocked, sp, cfg.lidar, cfg.raycast
            )
            if args.mode == "slam":
                state = engine.step(state, odom, scan)
            else:
                mcl_state = mcl_engine.predict(mcl_state, odom, cfg.motion.alphas)
                mcl_state = mcl_engine.update(mcl_state, scan, loc_field)
        else:
            if args.mode == "slam":
                state = engine.predict(state, odom)
            else:
                mcl_state = mcl_engine.predict(mcl_state, odom, cfg.motion.alphas)

        st = state.mcl if args.mode == "slam" else mcl_state
        mp = mcl_mod.mean_pose(st)
        # The scan-matched estimate is only meaningful on UPDATE frames: on
        # predict-only frames slam-mode est_pose is stale (predict_only never
        # advances it) and loc-mode refinement would score the CURRENT mean
        # against the OLD scan, dragging the estimate back toward the old
        # scan pose by up to the search window. Fall back to the raw mean
        # there (advisor finding, round 3).
        updated = (t + 1) % args.update_every == 0
        if args.mode == "slam" and args.scanmatch and updated:
            est_xy.append([float(state.est_pose.x), float(state.est_pose.y)])
        elif refine_fn is not None and updated and last_scan is not None:
            r = refine_fn(mp, last_scan)
            est_xy.append([float(r.x), float(r.y)])
        else:
            est_xy.append([float(mp.x), float(mp.y)])
        gt_xy.append([float(gt_pose.x), float(gt_pose.y)])

        if ckpt_mgr is not None and (t + 1) % args.checkpoint_every == 0:
            ckpt_mgr.save(t, {"state": state, "gt": gt_pose, "key": key})

        if args.out and t % args.frame_every == 0:
            if args.mode == "slam":
                img = render.prob_to_rgb(np.asarray(engine.prob_map(state)))
            else:
                img = render.blocked_to_rgb(blocked_np)
            render.draw_particles(
                img, np.asarray(st.particles.pose.x), np.asarray(st.particles.pose.y)
            )
            render.draw_pose(img, mp.x, mp.y, mp.theta, render.GREEN, 3)
            render.draw_pose(
                img, st.best_pose.x, st.best_pose.y, st.best_pose.theta, render.BLUE, 3
            )
            render.draw_pose(img, gt_pose.x, gt_pose.y, gt_pose.theta, render.MAGENTA, 3)
            frames.append(img)

    if ckpt_mgr is not None:
        ckpt_mgr.close()
    if frames:
        render.save_gif(frames, args.out)
    ate = ate_rmse(np.asarray(est_xy), np.asarray(gt_xy))
    print(f"steps={len(est_xy)} ATE={ate:.2f}px" + (f" -> {args.out}" if frames else ""))
    return ate


if __name__ == "__main__":
    main()
