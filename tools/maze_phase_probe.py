#!/usr/bin/env python
"""Phase attribution of the maze full-SLAM step.

With the box-localized table and the incremental EDT
(`SLAMConfig.edt_box`), what bounds the maze 10k step? Each phase of
`slam_tpu.models.slam.step` is jitted and timed IN ISOLATION on a
realistic mid-run state (same process, so run-to-run variation cancels
across phases):

  predict        motion sampling over N particles
  edt_refresh    the incremental window transform
  edt_full       the full-map capped transform
  table_build    boxed correlative score-table build (T x box^2)
  lookup         per-particle pair gather + mixture floor
  map_update     log-odds scatter along the scan's beams
  resample       systematic resampling of N particles
  blocked+diff   threshold + flip-diff/bbox planning passes (map-sized)

    nohup setsid python -u tools/maze_phase_probe.py > /tmp/mzp.log 2>&1 &
    python tools/maze_phase_probe.py --cpu --particles 256 --size 512
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
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=10_000)
    ap.add_argument("--map", default="/root/reference/assets/maze.png")
    ap.add_argument("--size", type=int, default=2048,
                    help="synthetic map size when --map is missing")
    ap.add_argument("--table-box", type=int, default=128)
    ap.add_argument("--edt-box", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--steps", type=int, default=12,
                    help="closed-loop steps to reach a realistic state")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from slam_tpu.models.simulate import find_start
    from slam_tpu.core import grid as gridlib
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
    from slam_tpu.ops import edt as edtlib, mapping, measurement, motion, resample
    from slam_tpu.ops.rayfield import RayField
    from slam_tpu.utils.maps import load_binary_map

    if os.path.exists(args.map):
        blocked_np = np.asarray(load_binary_map(args.map) == 0)
    else:
        rng = np.random.default_rng(0)
        s = args.size
        blocked_np = np.ones((s, s), bool)
        blocked_np[8:-8, 8:-8] = rng.random((s - 16, s - 16)) > 0.97
    blocked = jnp.asarray(blocked_np)
    h, w = blocked.shape
    lidar = LidarConfig(start=0.0, stop=2 * np.pi, max_dist=500.0, n_rays=90)
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=args.particles,
            meas_stddev=5.0,
            measurement="likelihood_field_table",
            lf_table_box=args.table_box,
        ),
        map=MapConfig(height=h, width=w),
        lidar=lidar,
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=1.0, max_dist=500.0, backend="sdf"),
        edt_box=args.edt_box,
    )
    sx, sy = find_start(blocked_np)
    gt = Pose.create(sx, sy, 0.9)
    engine = slam_mod.GridSLAM(cfg, seed=0)
    state = engine.init(gt)
    odom = Odometry.create(0.02, 2.0, 0.02)
    key = jax.random.key(3)
    scans = []
    for t in range(args.steps):
        key, kgt = jax.random.split(key)
        gt = motion.sample_motion_model_odometry(
            kgt, odom, gt, jnp.asarray(cfg.motion.alphas)
        )
        scan = fake_lidar.scan(blocked, gt, lidar, cfg.raycast)
        scans.append(scan)
        state = engine.step(state, odom, scan)
    jax.block_until_ready(state)
    scan = scans[-1]
    prev_grid = state.grid
    cap = 5.0 * cfg.mcl.meas_stddev + 2.0

    # A successor grid from ONE MORE real trajectory step, so the refresh
    # sees a realistic consecutive-frame flip diff (an out-of-sequence
    # scan would write at a stale pose and inflate the diff into the
    # full-rebuild fallback).
    key, kgt = jax.random.split(key)
    gt2 = motion.sample_motion_model_odometry(
        kgt, odom, gt, jnp.asarray(cfg.motion.alphas)
    )
    next_state = engine.step(
        state, odom, fake_lidar.scan(blocked, gt2, lidar, cfg.raycast)
    )
    jax.block_until_ready(next_state)

    bl_prev = gridlib.blocked_from_logodds(prev_grid)
    bl_next = gridlib.blocked_from_logodds(next_state.grid)

    def timeit(name, fn, *a):
        f = jax.jit(fn)
        out = f(*a)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = f(*a)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        print(f"# {name:14s} {ms:8.3f} ms", file=sys.stderr, flush=True)
        return ms

    res = {}
    res["predict"] = timeit(
        "predict",
        lambda s: mcl_mod.predict(s, odom, cfg.motion.alphas),
        state.mcl,
    )
    res["edt_refresh"] = timeit(
        "edt_refresh",
        lambda e, a, b: edtlib.edt_refresh(
            e, a, b, max_dist=cap, box=args.edt_box
        ),
        state.edt, bl_prev, bl_next,
    )
    res["edt_full"] = timeit(
        "edt_full",
        lambda b: edtlib.edt_capped(b, cap),
        bl_next,
    )
    res["edt_jfa_legacy"] = timeit(
        "edt_jfa_legacy",
        lambda b: edtlib.edt_jfa(b, max_dist=cap),
        bl_next,
    )
    res["blocked_diff"] = timeit(
        "blocked+diff",
        lambda g1, g2: edtlib._refresh_plan(
            gridlib.blocked_from_logodds(g1),
            gridlib.blocked_from_logodds(g2),
            reach=edtlib.edt_capped_reach(cap),
            box=args.edt_box,
        ),
        prev_grid, next_state.grid,
    )

    field = RayField(blocked=bl_prev, edt=state.edt)

    def build(f):
        return measurement.lf_table_prepare(
            f, state.mcl.particles.pose, scan, rc=cfg.raycast,
            scanner_offset=cfg.mcl.scanner_offset,
            stddev=cfg.mcl.meas_stddev, z_hit=cfg.mcl.lf_z_hit,
            z_rand=cfg.mcl.lf_z_rand, table_bins=cfg.mcl.lf_table_bins,
            spread_mult=cfg.mcl.lf_table_spread,
            min_halfwidth=cfg.mcl.lf_table_min_halfwidth,
            table_dtype=cfg.mcl.lf_table_dtype, box_size=cfg.mcl.lf_table_box,
        )

    res["table_build"] = timeit("table_build", build, field)
    prep = jax.jit(build)(field)
    res["lookup"] = timeit(
        "lookup",
        lambda p: measurement.lf_table_lookup(
            p, state.mcl.particles.pose, scan, rc=cfg.raycast,
            scanner_offset=cfg.mcl.scanner_offset, z_rand=cfg.mcl.lf_z_rand,
            grid_shape=(h, w),
        ),
        prep,
    )
    res["map_update"] = timeit(
        "map_update",
        lambda g: mapping.scan_logodds_update(
            g, state.est_pose, scan,
            scanner_offset=cfg.mcl.scanner_offset, step=cfg.raycast.step,
            max_dist=cfg.raycast.max_dist, l_occ=cfg.map.l_occ,
            l_free=cfg.map.l_free, l_min=cfg.map.l_min, l_max=cfg.map.l_max,
        ),
        prev_grid,
    )
    res["resample"] = timeit(
        "resample",
        lambda p, k: resample.resample(k, p, cfg.mcl.resample),
        state.mcl.particles, jax.random.key(5),
    )
    res["full_step"] = timeit(
        "full_step",
        lambda s: slam_mod.step(s, odom, scan, cfg),
        state,
    )
    print(json.dumps({
        "metric": f"maze_phase_ms_{args.particles}",
        "map": f"{h}x{w}",
        "phases": {k: round(v, 3) for k, v in res.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
