#!/usr/bin/env python
"""Smoke run of the main paths on NVIDIA GPUs, each checked against a
reference.

    python chip_smoke.py            # one GPU: mcl, slam, maze, planners, fleet
    python chip_smoke.py --multi    # four GPUs: sharded engines vs one device

Everything runs in this one process (a second JAX process could not get the
card's memory). Each phase prints one JSON line with its median step time,
the device's peak memory so far, and every check with its value, its
tolerance and the reason for it. Maps are generated from a seed; nothing is
read from outside the checkout. The line before the last is nvidia-smi's
name and power limit of each card; the last line is
``{"ok": true, "device": {...}}``. A failed check exits non-zero after all
phases ran; a failed phase raises. Without a GPU the script exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import heapq
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

FLOOR_PLAN = (599, 1297)  # the reference floor plan's size
MAZE = (2354, 2464)  # the reference maze's size
PLANNER_QUERY = ((150, 450), (450, 750))  # reference benchmark query (i, j)


def _median_ms(fn, warmup: int, iters: int) -> float:
    """Median wall time of ``fn()`` in ms, each call waited for."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _check(name, value, tol, ok, why):
    return {"name": name, "value": value, "tol": tol, "ok": bool(ok),
            "why": why}


def _rel_agree(a, b, rel=1e-4):
    """Share of entries with |a - b| <= rel * max(1, |b|)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean(np.abs(a - b) <= rel * np.maximum(1.0, np.abs(b))))


def _floor_plan_lut_setup(shape, n_bins):
    """bench.py's MCL configuration on the synthetic floor plan."""
    import jax.numpy as jnp

    from slam_tpu.core.config import (
        LidarConfig, MCLConfig, RaycastConfig, beam_bin_stride,
    )
    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.ops import rayfield

    blocked = jnp.asarray(synthetic_floor_plan(*shape))
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="lut",
                       lut_bins=n_bins)
    cfg = MCLConfig(
        meas_stddev=5.0,
        scanner_offset=(0.0, 30.0, 0.0),
        lut_beam_stride=beam_bin_stride(lidar, rc),
    )
    field = rayfield.make_ray_field(blocked, rc)
    return blocked, lidar, rc, cfg, field


def phase_mcl(particles=100_000, n_bins=360, warmup=3, steps=20,
              cpu_slice=4096, loc_particles=10_000, loc_steps=30,
              shape=FLOOR_PLAN, pose=(400.0, 400.0, math.pi)):
    """bench.py's MCL step (fused LUT path) against the unfused per-beam
    path, the CPU backend and closed-loop localization quality."""
    import jax

    from slam_tpu.core.config import MotionConfig, SLAMConfig
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod, simulate
    from slam_tpu.ops import lut as lutlib, measurement
    from slam_tpu.utils.metrics import ate_rmse

    t0 = time.perf_counter()
    blocked, lidar, rc, cfg, field = _floor_plan_lut_setup(shape, n_bins)
    jax.block_until_ready(field)
    build_s = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, n_particles=particles)
    odom = Odometry.create(2.5, 0.02, 0.02)
    alphas = jax.numpy.asarray((0.0005, 0.0005, 0.01, 0.01))
    start = Pose.create(*pose)
    scan = fake_lidar.scan(
        blocked, mcl_mod.MCL.sensor_position(start, cfg.scanner_offset),
        lidar, dataclasses.replace(rc, backend="march"),
    )

    step = jax.jit(lambda st, f, z: mcl_mod.update(
        mcl_mod.predict(st, odom, alphas), z, f, cfg, rc))
    state = mcl_mod.init(jax.random.key(0), particles, start)

    def one_step():
        nonlocal state
        state = step(state, field, scan)
        return state

    step_ms = _median_ms(one_step, warmup, steps)
    poses = state.particles.pose

    def weights_fn(stride):
        return jax.jit(lambda f, p, z: measurement.particle_log_weights(
            f, p, z, rc=rc, scanner_offset=cfg.scanner_offset,
            stddev=cfg.meas_stddev, eps=cfg.meas_epsilon,
            lut_beam_stride=stride))

    fused, unfused = weights_fn(cfg.lut_beam_stride), weights_fn(None)
    lw_fused = np.asarray(fused(field, poses, scan))
    lw_unfused = np.asarray(unfused(field, poses, scan))
    measurement_ms = _median_ms(lambda: fused(field, poses, scan), 2, steps)
    sp = measurement.sensor_pose(poses, cfg.scanner_offset)
    pano = jax.jit(lambda lut, x, y: lutlib.panorama_rows(lut, x, y, n_bins))
    pano_ms = _median_ms(lambda: pano(field.lut, sp.x, sp.y), 2, steps)

    cpu = jax.devices("cpu")[0]
    sl = jax.tree.map(lambda a: a[:cpu_slice], poses)
    lw_cpu = np.asarray(fused(*jax.device_put((field, sl, scan), cpu)))

    loc_cfg = SLAMConfig(
        mcl=dataclasses.replace(cfg, n_particles=loc_particles),
        lidar=lidar,
        motion=MotionConfig(alphas=(0.0005, 0.0005, 0.01, 0.01)),
        raycast=rc,
    )
    res = simulate.run_localization(
        blocked, loc_cfg,
        simulate.forward_arc_commands(loc_steps, trans=2.5, rot=0.02),
        start, seed=1, field=field,
    )
    ate = ate_rmse(res.est_xy, res.gt_xy)

    tie = ("one bin ties: a beam whose angle rounds to the neighbouring bin "
           "under other f32 angle arithmetic reads another range")
    vs_unfused = _rel_agree(lw_fused, lw_unfused)
    vs_cpu = _rel_agree(lw_fused[:cpu_slice], lw_cpu)
    finite = bool(np.isfinite(lw_fused).all())
    return {
        "phase": "mcl",
        "particles": particles,
        "median_step_ms": step_ms,
        "measurement_ms": measurement_ms,
        "panorama_gather_ms": pano_ms,
        "lut_build_s": build_s,
        "checks": [
            _check("fused_vs_unfused_share_within_1e-4_rel", vs_unfused,
                   ">= 0.999", vs_unfused >= 0.999,
                   "same bins and pdf, other f32 summation order; " + tie),
            _check("fused_gpu_vs_cpu_share_within_1e-4_rel", vs_cpu,
                   ">= 0.999", vs_cpu >= 0.999,
                   "same program on the CPU backend; " + tie),
            _check("weights_finite", finite, True, finite, "log weights"),
            _check("localization_ate_px", ate, "< 2.0", ate < 2.0,
                   "the repo's healthy localization ATE bound"),
        ],
        "peak_bytes_in_use": _peak_bytes(),
    }


def _production_slam_cfg(particles, shape, table_box=128):
    """The 1M production SLAM configuration (benchmarks/suite.py slam)."""
    from slam_tpu.core.config import (
        LidarConfig, MapConfig, MCLConfig, MotionConfig, RaycastConfig,
        SLAMConfig,
    )

    return SLAMConfig(
        mcl=MCLConfig(
            n_particles=particles,
            meas_stddev=5.0,
            measurement="likelihood_field_table",
            lf_table_box=table_box,
            resample_every=4,
        ),
        map=MapConfig(height=shape[0], width=shape[1]),
        lidar=LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=0.5, max_dist=500.0, backend="sdf"),
        map_pose="mode",
    )


def phase_slam(particles=1_000_000, steps=16, timed=10, table_box=128,
               shape=FLOOR_PLAN):
    """Production full SLAM on the floor plan along the deterministic arc;
    the boxed score table against the CPU backend."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, simulate, slam as slam_mod
    from slam_tpu.ops import edt as edtlib, measurement
    from slam_tpu.utils.metrics import ate_rmse

    blocked = jnp.asarray(simulate.synthetic_floor_plan(*shape))
    cfg = _production_slam_cfg(particles, shape, table_box)
    res = simulate.run_slam_deterministic(blocked, cfg, n_steps=steps)
    ate = ate_rmse(res.est_xy, res.gt_xy, align=True)

    engine = slam_mod.GridSLAM(cfg, seed=0)
    state = res.final_state
    odom = Odometry.create(0.01, 2.5, 0.01)
    gx, gy = res.gt_xy[-1]
    scans = [
        fake_lidar.scan(blocked, measurement.sensor_pose(p, (0.0, 0.0, 0.0)),
                        cfg.lidar, cfg.raycast)
        for p in (Pose.create(gx, gy, math.pi / 2),
                  Pose.create(gx + 1.5, gy - 1.5, math.pi / 2 + 0.05))
    ]
    k = 0

    def one_step():
        nonlocal state, k
        state = engine.step(state, odom, scans[k % 2])
        k += 1
        return state

    step_ms = _median_ms(one_step, 2, timed)

    # The box table around the last ground-truth cell, GPU vs CPU.
    edt = edtlib.edt_capped(blocked, 5.0 * cfg.mcl.meas_stddev + 2.0)
    h, w = shape
    i0 = int(np.clip(h - gy - table_box // 2, 0, h - table_box))
    j0 = int(np.clip(gx - table_box // 2, 0, w - table_box))
    headings = jnp.linspace(math.pi / 2 - 0.3, math.pi / 2 + 0.3,
                            cfg.mcl.lf_table_bins)
    origin = (jnp.int32(i0), jnp.int32(j0))

    table = jax.jit(lambda e, z, hd, o: measurement.lf_score_table(
        e, z, hd, rc=cfg.raycast, stddev=cfg.mcl.meas_stddev,
        z_hit=cfg.mcl.lf_z_hit, z_rand=cfg.mcl.lf_z_rand,
        dtype=cfg.mcl.lf_table_dtype, origin=o,
        out_shape=(table_box, table_box)))
    args = (edt, scans[0], headings, origin)
    tbl = np.asarray(table(*args))
    tbl_cpu = np.asarray(table(*jax.device_put(args, jax.devices("cpu")[0])))
    tbl_err = float(np.max(np.abs(tbl - tbl_cpu)))
    table_ms = _median_ms(lambda: table(*args), 2, timed)
    finite = bool(np.isfinite(np.asarray(state.grid)).all()
                  and np.isfinite(np.asarray(
                      state.mcl.particles.log_weight)).all())

    return {
        "phase": "slam",
        "particles": particles,
        "median_step_ms": step_ms,
        "score_table_ms": table_ms,
        "checks": [
            _check("score_table_gpu_vs_cpu_max_abs", tbl_err, "<= 1e-3",
                   tbl_err <= 1e-3,
                   "sums of 90 f32 log-scores of magnitude <= 10 in another "
                   "order differ by ~1e-5; TF32 inputs would differ by "
                   "~2e-3 per term"),
            _check("slam_ate_aligned_px", ate, "< 6.0", ate < 6.0,
                   "the repo's healthy SLAM ATE bound (SE(2)-aligned)"),
            _check("state_finite", finite, True, finite,
                   "grid and log weights"),
        ],
        "peak_bytes_in_use": _peak_bytes(),
    }


def _maze_slam_cfg(particles, shape, table_box, **kw):
    """Boxed-table SLAM on the maze (benchmarks/maze_slam_bench.py)."""
    from slam_tpu.core.config import (
        LidarConfig, MapConfig, MCLConfig, MotionConfig, RaycastConfig,
        SLAMConfig,
    )

    return SLAMConfig(
        mcl=MCLConfig(n_particles=particles, meas_stddev=5.0,
                      measurement="likelihood_field_table",
                      lf_table_box=table_box, **kw.pop("mcl", {})),
        map=MapConfig(height=shape[0], width=shape[1]),
        lidar=LidarConfig(start=0.0, stop=2 * math.pi, max_dist=500.0,
                          n_rays=90),
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=RaycastConfig(step=1.0, max_dist=500.0, backend="sdf"),
        **kw,
    )


def phase_maze(particles=10_000, steps=6, edt_box=1024, table_box=128,
               shape=MAZE):
    """Boxed-table SLAM with the incremental EDT on the generated maze; the
    carried EDT against a full rebuild, bitwise."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.core import grid as gridlib
    from slam_tpu.core.config import RaycastConfig
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, simulate, slam as slam_mod
    from slam_tpu.ops import edt as edtlib, motion
    from slam_tpu.ops.measurement import sensor_pose

    blocked_np = simulate.synthetic_maze(*shape)
    blocked = jnp.asarray(blocked_np)
    cfg = _maze_slam_cfg(particles, shape, table_box, edt_box=edt_box)
    engine = slam_mod.GridSLAM(cfg, seed=0)
    gt = Pose.create(*simulate.find_start(blocked_np), 0.9)
    state = engine.init(gt)
    odom = Odometry.create(0.02, 2.0, 0.02)
    key = jax.random.key(3)
    step_ms = []
    for _ in range(steps):
        key, kgt = jax.random.split(key)
        gt = motion.sample_motion_model_odometry(
            kgt, odom, gt, jnp.asarray(cfg.motion.alphas))
        scan = fake_lidar.scan(blocked, sensor_pose(gt, cfg.mcl.scanner_offset),
                               cfg.lidar, RaycastConfig(max_dist=500.0))
        jax.block_until_ready(scan)
        t0 = time.perf_counter()
        state = jax.block_until_ready(engine.step(state, odom, scan))
        step_ms.append(1e3 * (time.perf_counter() - t0))
    full = edtlib.edt_capped(gridlib.blocked_from_logodds(state.grid),
                             5.0 * cfg.mcl.meas_stddev + 2.0)
    same = bool(np.array_equal(np.asarray(state.edt), np.asarray(full)))
    return {
        "phase": "maze",
        "particles": particles,
        "map": list(shape),
        # The first steps compile; the median is over the steady ones.
        "median_step_ms": float(np.median(step_ms[2:] or step_ms)),
        "checks": [
            _check("incremental_edt_equals_full_rebuild", same, True, same,
                   "bitwise, as tests/test_edt.py asserts on the CPU"),
        ],
        "peak_bytes_in_use": _peak_bytes(),
    }


def _dijkstra_cost(free: np.ndarray, a, b) -> float:
    """8-connected (1, sqrt 2) shortest-path cost, heapq in float64."""
    h, w = free.shape
    dist = np.full((h, w), np.inf)
    dist[a] = 0.0
    q = [(0.0, a)]
    steps = [(di, dj, math.hypot(di, dj)) for di in (-1, 0, 1)
             for dj in (-1, 0, 1) if di or dj]
    while q:
        d, (i, j) = heapq.heappop(q)
        if (i, j) == b:
            return d
        if d > dist[i, j]:
            continue
        for di, dj, c in steps:
            ni, nj = i + di, j + dj
            if 0 <= ni < h and 0 <= nj < w and free[ni, nj]:
                nd = d + c
                if nd < dist[ni, nj]:
                    dist[ni, nj] = nd
                    heapq.heappush(q, (nd, (ni, nj)))
    return math.inf


def _spatial_reference(px, py, qx, qy, boxes):
    """Exact NN squared distances and per-box counts, numpy brute force."""
    pxi, pyi = px.astype(np.int64), py.astype(np.int64)
    nn_d2 = np.concatenate([
        np.min((qx[k:k + 16, None].astype(np.int64) - pxi) ** 2
               + (qy[k:k + 16, None].astype(np.int64) - pyi) ** 2, axis=1)
        for k in range(0, len(qx), 16)
    ])
    counts = np.concatenate([
        np.sum((px >= bx[:, 0:1]) & (px <= bx[:, 2:3])
               & (py >= bx[:, 1:2]) & (py <= bx[:, 3:4]), axis=1)
        for bx in (boxes[k:k + 8] for k in range(0, len(boxes), 8))
    ])
    return nn_d2, counts


def _hastar_cfg(batch):
    """Lattice Hybrid A* as benchmarks/suite.py runs it."""
    from slam_tpu.core.config import HybridAStarConfig

    vel, steer = 10.0, 40 * math.pi / 180
    return HybridAStarConfig(
        velocity=vel, max_steering=steer,
        length=vel * math.tan(steer) / (10 * math.pi / 180),
        theta_res=36, branching_factor=3, tol=5.0, batch=batch,
        mode="lattice", lattice_reps=1, heuristic_weight=1.3,
    )


def phase_planners(shape=FLOOR_PLAN, query=PLANNER_QUERY, inflate_r=7,
                   hastar_batch=512, rrt_nodes=8192, rrt_batch=256,
                   rrt_rounds=400, n_points=1_000_000, n_boxes=1000,
                   n_queries=1024, max_val=10_000, repeats=3):
    """A*, lattice Hybrid A* and RRT* on the eroded floor plan
    (benchmarks/suite.py settings), then the dense spatial queries."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import RaycastConfig, RRTStarConfig
    from slam_tpu.core.types import Pose
    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.ops import spatial
    from slam_tpu.planners import AStar, HybridAStar, RRTStar

    blocked = synthetic_floor_plan(*shape)
    h = blocked.shape[0]
    free_np = ~inflate(blocked, inflate_r)
    free = jnp.asarray(free_np)
    (ai, aj), (bi, bj) = query

    astar = AStar(free, (ai, aj), (bi, bj))

    def run_astar():
        astar.solve()
        return astar.dist

    astar_ms = _median_ms(run_astar, 1, repeats)
    a_cost = astar.path_cost()
    ref_cost = _dijkstra_cost(free_np, (ai, aj), (bi, bj))

    hcfg = _hastar_cfg(hastar_batch)
    a_pose = Pose.create(float(aj), float(h - ai), 0.0)
    b_pose = Pose.create(float(bj), float(h - bi), 0.0)
    hastar = HybridAStar(free, a_pose, b_pose, hcfg,
                         RaycastConfig(backend="lut", step=1.0, lut_bins=180))

    def run_hastar():
        hastar.reset_query(a_pose, b_pose)
        hastar.solve()
        return hastar.state

    hastar_ms = _median_ms(run_hastar, 1, repeats)
    h_ok, h_cost = hastar.success, hastar.path_cost()

    rrt = RRTStar(free, (float(aj), float(h - ai)), (float(bj), float(h - bi)),
                  RRTStarConfig(reach=20.0, radius=50.0, max_nodes=rrt_nodes,
                                batch=rrt_batch), seed=1234)

    def run_rrt():
        rrt.reset_query((float(aj), float(h - ai)),
                        (float(bj), float(h - bi)), 1234)
        rrt.solve(max_rounds=rrt_rounds)
        return rrt.state

    rrt_ms = _median_ms(run_rrt, 1, repeats)
    r_ok, r_cost = rrt.success, rrt.path_cost()

    rng = np.random.default_rng(0)
    px = rng.integers(0, max_val, n_points).astype(np.float32)
    py = rng.integers(0, max_val, n_points).astype(np.float32)
    qx = rng.integers(0, max_val, n_queries).astype(np.float32)
    qy = rng.integers(0, max_val, n_queries).astype(np.float32)
    lo = rng.integers(0, max_val, (n_boxes, 2)).astype(np.float32)
    ext = rng.integers(1, max_val // 10, (n_boxes, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + ext], axis=1)
    dpx, dpy, dqx, dqy, dboxes = map(jnp.asarray, (px, py, qx, qy, boxes))
    valid = jnp.ones((n_points,), bool)
    nn = jax.jit(spatial.nearest_neighbor_blocked)
    count = jax.jit(lambda x, y, v, bx: jax.lax.map(
        lambda b: jnp.sum(spatial.in_box(x, y, v, (b[0], b[1], b[2], b[3]))),
        bx))
    nn_ms = _median_ms(lambda: nn(dpx, dpy, valid, dqx, dqy), 1, repeats)
    range_ms = _median_ms(lambda: count(dpx, dpy, valid, dboxes), 1, repeats)
    idx = np.asarray(nn(dpx, dpy, valid, dqx, dqy)[0])
    got_counts = np.asarray(count(dpx, dpy, valid, dboxes))
    ref_d2, ref_counts = _spatial_reference(px, py, qx, qy, boxes)
    got_d2 = (px[idx].astype(np.int64) - qx.astype(np.int64)) ** 2 + (
        py[idx].astype(np.int64) - qy.astype(np.int64)) ** 2

    rel = abs(a_cost - ref_cost) / ref_cost
    return {
        "phase": "planners",
        "astar_ms": astar_ms,
        "hastar_ms": hastar_ms,
        "rrtstar_ms": rrt_ms,
        "nn_ms": nn_ms,
        "range_ms": range_ms,
        "median_step_ms": hastar_ms,
        "costs": {"astar": a_cost, "dijkstra": ref_cost, "hastar": h_cost,
                  "rrtstar": r_cost},
        "checks": [
            _check("astar_vs_dijkstra_rel", rel, "<= 1e-4", rel <= 1e-4,
                   "f32 sums along a path of <= 2000 edges"),
            _check("hastar_found_cost_over_astar", h_cost / a_cost,
                   "[0.9, 2.2]", h_ok and 0.9 <= h_cost / a_cost <= 2.2,
                   "a kinematic path is no shorter than the geodesic, which "
                   "the 8-connected cost overestimates by <= 8.3%; 2.2x is "
                   "the planner tests' suboptimality bound"),
            _check("rrtstar_found_cost_over_astar", r_cost / a_cost,
                   "[0.9, 2.2]", r_ok and 0.9 <= r_cost / a_cost <= 2.2,
                   "as for Hybrid A*"),
            _check("nn_exact", bool(np.array_equal(got_d2, ref_d2)), True,
                   np.array_equal(got_d2, ref_d2),
                   "distance of the returned point equals the brute-force "
                   "minimum (ties allowed)"),
            _check("range_counts_exact",
                   bool(np.array_equal(got_counts, ref_counts)), True,
                   np.array_equal(got_counts, ref_counts),
                   "integer-valued f32 coordinates compare exactly"),
        ],
        "peak_bytes_in_use": _peak_bytes(),
    }


def _free_poses(blocked: np.ndarray, n: int, clearance: int, seed: int):
    """n world poses on free cells at least `clearance` from any wall."""
    rng = np.random.default_rng(seed)
    h, w = blocked.shape
    out = []
    while len(out) < n:
        i = int(rng.integers(clearance, h - clearance))
        j = int(rng.integers(clearance, w - clearance))
        if not blocked[i - clearance:i + clearance + 1,
                       j - clearance:j + clearance + 1].any():
            out.append((j + 0.5, h - i - 0.5, float(rng.uniform(-np.pi, np.pi))))
    return np.asarray(out, np.float32)


def _fleet_inputs(blocked, lidar, rc, cfg, robots):
    import jax
    import jax.numpy as jnp

    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar
    from slam_tpu.ops.measurement import sensor_pose

    xyz = _free_poses(np.asarray(blocked), robots, clearance=12, seed=5)
    poses = Pose.create(*(jnp.asarray(xyz[:, k]) for k in range(3)))
    scan = jax.jit(jax.vmap(lambda p: fake_lidar.scan(
        blocked, sensor_pose(p, cfg.scanner_offset), lidar,
        dataclasses.replace(rc, backend="march"))))
    scans = scan(poses)
    odoms = jax.tree.map(lambda z: jnp.broadcast_to(z, (robots,)),
                         Odometry.create(0.02, 2.0, 0.02))
    return poses, scans, odoms


def phase_fleet(robots=64, particles=1024, ticks=3, n_bins=360,
                shape=FLOOR_PLAN):
    """MCLFleet ticks against the same robots stepped one at a time."""
    import jax

    from slam_tpu.models import fleet, mcl as mcl_mod

    blocked, lidar, rc, cfg, field = _floor_plan_lut_setup(shape, n_bins)
    cfg = dataclasses.replace(cfg, n_particles=particles)
    alphas = jax.numpy.asarray((0.0005, 0.0005, 0.01, 0.01))
    poses, scans, odoms = _fleet_inputs(blocked, lidar, rc, cfg, robots)

    fl = fleet.MCLFleet(robots, cfg, rc, seed=7)
    states = fl.init(poses)
    tick_ms = []
    for _ in range(ticks):
        t0 = time.perf_counter()
        states = jax.block_until_ready(
            fl.step(states, odoms, scans, field, alphas))
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    means = fleet.mean_poses(states)

    one = jax.jit(lambda st, od, sc, f: mcl_mod.update(
        mcl_mod.predict(st, od, alphas), sc, f, cfg, rc))
    keys = jax.random.split(jax.random.key(7), robots)
    err = []
    for q in range(robots):
        pick = lambda t: jax.tree.map(lambda a: a[q], t)  # noqa: E731
        st = mcl_mod.init(keys[q], particles, pick(poses))
        for _ in range(ticks):
            st = one(st, pick(odoms), pick(scans), field)
        m = mcl_mod.mean_pose(st)
        err.append(math.hypot(float(m.x - means.x[q]), float(m.y - means.y[q])))
    max_err = max(err)
    return {
        "phase": "fleet",
        "robots": robots,
        "particles": particles,
        "median_step_ms": float(np.median(tick_ms[1:] or tick_ms)),
        "checks": [
            _check("fleet_vs_single_mean_px", max_err, "<= 0.1",
                   max_err <= 0.1,
                   "same keys and inputs; vmapped kernels may sum in another "
                   "order, which can flip a resampling pick, moving one of "
                   f"{particles} particles"),
        ],
        "peak_bytes_in_use": _peak_bytes(),
    }


def _close(name, got, want, rtol, atol, why):
    got, want = np.asarray(got), np.asarray(want)
    ok = bool(np.allclose(got, want, rtol=rtol, atol=atol))
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    return _check(name, err, f"rtol {rtol}, atol {atol}", ok, why)


def phase_multi_sharded_slam(particles=1_000_000, steps=2, timed=5,
                             table_box=128, shape=FLOOR_PLAN):
    """ShardedGridSLAM (production config) on (4, 1) and (2, 2) meshes
    against the single-device engine."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, slam as slam_mod, simulate
    from slam_tpu.parallel import ShardedGridSLAM, make_mesh

    blocked = jnp.asarray(simulate.synthetic_floor_plan(*shape))
    cfg = _production_slam_cfg(particles, shape, table_box)
    # No resampling, as in tests/test_parallel.py: per-particle comparison.
    cfg = dataclasses.replace(
        cfg, mcl=dataclasses.replace(cfg.mcl, ess_threshold=0.0))
    pose = Pose.create(shape[1] / 2.0, shape[0] / 2.0, math.pi / 2)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    odom = Odometry.create(0.02, 2.0, 0.02)

    st0 = slam_mod.init(jax.random.key(0), cfg, pose)
    one = jax.jit(lambda s, o, z: slam_mod.step(s, o, z, cfg))
    for _ in range(steps):
        st0 = one(st0, odom, scan)
    st0 = jax.block_until_ready(st0)

    out = {"phase": "multi_sharded_slam", "particles": particles,
           "checks": [], "median_step_ms": {}}
    for p_axis, b_axis in ((4, 1), (2, 2)):
        mesh = make_mesh(4, beam_axis=b_axis)
        engine = ShardedGridSLAM(mesh, cfg)
        st = engine.init(pose)
        for _ in range(steps):
            st = engine.step(st, odom, scan)
        st = jax.block_until_ready(st)
        tag = f"mesh_{p_axis}x{b_axis}"
        why = "tests/test_parallel.py tolerance"
        diff = np.abs(np.asarray(st.grid) - np.asarray(st0.grid))
        flipped = float(np.mean(diff > 1e-5))
        pose_err = max(
            abs(float(st.mcl.mode_pose.x - st0.mcl.mode_pose.x)),
            abs(float(st.mcl.mode_pose.y - st0.mcl.mode_pose.y)))
        out["checks"] += [
            _close(f"{tag}_log_weight", st.mcl.particles.log_weight,
                   st0.mcl.particles.log_weight, 1e-4, 1e-5, why),
            _close(f"{tag}_pose_x", st.mcl.particles.pose.x,
                   st0.mcl.particles.pose.x, 1e-5, 0.0, why),
            _check(f"{tag}_map_pose_px", pose_err, "<= 1e-3",
                   pose_err <= 1e-3,
                   "the weighted mode pose over 1M particles, summed in "
                   "another order across devices"),
            # Looser than the CPU tests' atol 1e-5 on every cell: with the
            # beams split over devices XLA compiles the mapping rays' cell
            # geometry in another fused form, and a cell where a ray
            # grazes a corner or ends can take another log-odds increment.
            _check(f"{tag}_grid_cells_changed_share", flipped, "<= 1e-4",
                   flipped <= 1e-4 and float(diff.max()) <= 0.62 + 1e-5,
                   "cells may differ by at most one increment "
                   "(|l_occ| + |l_free| = 0.62) where a ray grazes a "
                   "corner or ends; max diff " + repr(float(diff.max()))),
        ]

        def one_step(engine=engine):
            nonlocal st
            st = engine.step(st, odom, scan)
            return st

        out["median_step_ms"][tag] = _median_ms(one_step, 1, timed)
    out["single_device_step_ms"] = _median_ms(
        lambda: one(st0, odom, scan), 1, timed)
    out["peak_bytes_in_use"] = _peak_bytes()
    return out


def phase_multi_mapshard(particles=10_000, steps=3, table_box=128,
                         shape=MAZE):
    """MapShardedGridSLAM (boxed table) with the maze's rows over 4 devices
    against the single-device engine."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.core.config import RaycastConfig
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, simulate, slam as slam_mod
    from slam_tpu.ops.measurement import sensor_pose
    from slam_tpu.parallel import make_mesh
    from slam_tpu.parallel.mapshard import MapShardedGridSLAM

    maze = simulate.synthetic_maze(*shape)
    # Row blocks must divide the map: pad with wall rows to a multiple of 4.
    maze = np.pad(maze, ((0, (-maze.shape[0]) % 4), (0, 0)),
                  constant_values=True)
    h, w = maze.shape
    blocked = jnp.asarray(maze)
    # No resampling, as in the sharded-engine tests: per-particle comparison.
    cfg = _maze_slam_cfg(particles, (h, w), table_box,
                         mcl={"ess_threshold": 0.0})
    pose = Pose.create(*simulate.find_start(maze), 0.9)
    scan = fake_lidar.scan(blocked, sensor_pose(pose, (0.0, 0.0, 0.0)),
                           cfg.lidar, RaycastConfig(max_dist=500.0))
    odom = Odometry.create(0.02, 1.5, 0.02)

    engine0 = slam_mod.GridSLAM(cfg, seed=0)
    st0 = engine0.init(pose)
    engine = MapShardedGridSLAM(make_mesh(4, beam_axis=4), cfg)
    st = engine.init(pose, seed=0)
    for _ in range(steps):
        st0 = engine0.step(st0, odom, scan)
        st = engine.step(st, odom, scan)
    st, st0 = jax.block_until_ready((st, st0))
    why = "tests/test_mapshard.py tolerance"
    rows = st.grid.sharding.shard_shape((h, w))[0]
    checks = [
        _close("grid", st.grid, st0.grid, 0.0, 1e-5, why),
        _close("pose_x", st.mcl.particles.pose.x,
               st0.mcl.particles.pose.x, 1e-4, 0.0, why),
        _close("log_weight", st.mcl.particles.log_weight,
               st0.mcl.particles.log_weight, 1e-4, 1e-4, why),
        _check("grid_row_blocks", rows, h // 4, rows == h // 4,
               "rows sharded over the 4 devices"),
    ]

    def one_step():
        nonlocal st
        st = engine.step(st, odom, scan)
        return st

    return {
        "phase": "multi_mapshard",
        "particles": particles,
        "map": [h, w],
        "median_step_ms": _median_ms(one_step, 1, 5),
        "checks": checks,
        "peak_bytes_in_use": _peak_bytes(),
    }


def phase_multi_fleet(robots=64, particles=1024, ticks=2, n_bins=360,
                      shape=FLOOR_PLAN):
    """ShardedMCLFleet (robots over 4 devices) against MCLFleet."""
    import jax

    from slam_tpu.models import fleet as fleet_mod
    from slam_tpu.parallel import ShardedMCLFleet, make_mesh

    blocked, lidar, rc, cfg, field = _floor_plan_lut_setup(shape, n_bins)
    cfg = dataclasses.replace(cfg, n_particles=particles)
    alphas = (0.0005, 0.0005, 0.01, 0.01)
    poses, scans, odoms = _fleet_inputs(blocked, lidar, rc, cfg, robots)
    sf = ShardedMCLFleet(make_mesh(4, beam_axis=1), robots, cfg, rc, seed=3)
    fl = fleet_mod.MCLFleet(robots, cfg, rc, seed=3)
    st_s, st_u = sf.init(poses), fl.init(poses)
    for _ in range(ticks):
        st_s = sf.step(st_s, odoms, scans, field, alphas)
        st_u = fl.step(st_u, odoms, scans, field, alphas)
    st_s, st_u = jax.block_until_ready((st_s, st_u))
    checks = [
        _close("pose_x", st_s.particles.pose.x, st_u.particles.pose.x,
               1e-5, 1e-4, "tests/test_parallel.py tolerance"),
    ]

    def one_tick():
        nonlocal st_s
        st_s = sf.step(st_s, odoms, scans, field, alphas)
        return st_s

    return {
        "phase": "multi_fleet",
        "robots": robots,
        "particles": particles,
        "median_step_ms": _median_ms(one_tick, 1, 5),
        "checks": checks,
        "peak_bytes_in_use": _peak_bytes(),
    }


def phase_multi_hastar(queries=8, shape=FLOOR_PLAN, query=PLANNER_QUERY,
                       inflate_r=7, batch=512):
    """HybridAStar.solve_many with the query axis over 4 devices against
    the same queries solved unsharded."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import RaycastConfig
    from slam_tpu.core.types import Pose
    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.parallel import make_mesh
    from slam_tpu.planners import HybridAStar

    blocked = synthetic_floor_plan(*shape)
    h = blocked.shape[0]
    free = jnp.asarray(~inflate(blocked, inflate_r))
    (ai, aj), (bi, bj) = query
    hcfg = _hastar_cfg(batch)
    goal = Pose.create(float(bj), float(h - bi), 0.0)
    qs = [(Pose.create(float(aj) + 3.0 * (q % 4), float(h - ai) - 3.0 * (q // 4),
                       0.0), goal) for q in range(queries)]
    planner = HybridAStar(free, qs[0][0], goal, hcfg,
                          RaycastConfig(backend="lut", step=1.0, lut_bins=180))
    want = planner.solve_many(qs)
    t0 = time.perf_counter()
    got = planner.solve_many(
        qs, query_sharding=NamedSharding(make_mesh(4, beam_axis=1), P("p")))
    first_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    planner.solve_many(
        qs, query_sharding=NamedSharding(make_mesh(4, beam_axis=1), P("p")))
    ms = 1e3 * (time.perf_counter() - t0)
    same = all(a[0] == b[0] and abs(a[1] - b[1]) < 1e-3
               for a, b in zip(got, want))
    return {
        "phase": "multi_hastar",
        "queries": queries,
        "median_step_ms": ms,
        "first_call_ms": first_ms,
        "checks": [
            _check("sharded_equals_unsharded", same, True,
                   same and all(a[0] for a in got),
                   "every query found, costs within 1e-3 "
                   "(tests/test_planners.py)"),
        ],
        "peak_bytes_in_use": _peak_bytes(),
    }


SINGLE = (phase_mcl, phase_slam, phase_maze, phase_planners, phase_fleet)
MULTI = (phase_multi_sharded_slam, phase_multi_mapshard, phase_multi_fleet,
         phase_multi_hastar)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU phases")
    args = ap.parse_args(argv)

    from slam_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu(allow_cpu=False)
    cache_dir = enable_compile_cache()
    want = 4 if args.multi else 1
    if device["count"] < want:
        sys.exit(f"error: {want} GPU(s) needed, {device['count']} found")

    failed = []
    for phase in MULTI if args.multi else SINGLE:
        t0 = time.perf_counter()
        rec = phase()
        rec["wall_s"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        failed += [f"{rec['phase']}.{c['name']}" for c in rec["checks"]
                   if not c["ok"]]

    entries = len(os.listdir(cache_dir)) if os.path.isdir(cache_dir) else 0
    print(json.dumps({"compile_cache": cache_dir, "entries": entries}),
          flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    if failed:
        sys.exit(f"error: failed checks: {', '.join(failed)}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
