#!/usr/bin/env python
"""Benchmark suite reproducing the reference's four Google-Benchmark configs
(reference `benchmark/{mcl,hastar,rrtstar,quadtree}.cpp`) on one GPU. Prints
one JSON line per benchmark, naming the device, with vs_baseline against the
measured C++ numbers on a host CPU (BASELINE_MEASURED.json).

    python benchmarks/suite.py all
    python benchmarks/suite.py mcl --particles 100000
    python benchmarks/suite.py hastar rrtstar spatial --cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

with open(
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "BASELINE_MEASURED.json")
) as f:
    _BASELINES = json.load(f)

def emit(args, metric, value, unit, baseline=None, extra=""):
    """One JSON result line naming ``args.device`` (set by main)."""
    on_cpu = args.device["platform"] == "cpu"
    rec = {
        "metric": f"cpu_functional_check_{metric}" if on_cpu else metric,
        "value": round(value, 2),
        "unit": unit,
        "device": args.device,
    }
    if baseline and not on_cpu:
        rec["vs_baseline"] = round(value / baseline, 2)
    print(json.dumps(rec))
    if extra:
        print(f"# {extra}", file=sys.stderr)


def floor_plan():
    from slam_tpu.models.simulate import synthetic_floor_plan

    return synthetic_floor_plan()


def bench_mcl(args):
    """`benchmark/mcl.cpp` config at the north-star particle count."""
    import bench as B

    sys.argv = ["bench.py", "--particles", str(args.particles), "--iters", str(args.iters)]
    if args.cpu:
        sys.argv.append("--cpu")
    B.main()


def bench_slam(args):
    """The production full-SLAM config: 1M particles, boxed correlative
    table, resample_every=4, map_pose=mode — sustained pipelined step +
    rate on the floor plan. Not a reference config (the C++ RBPF cannot reach this regime); the
    comparison row is the reference's own 25-particle MCL throughput."""
    import time as _t

    import jax
    import jax.numpy as jnp

    from slam_tpu.core.config import (
        LidarConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, slam as slam_mod
    from slam_tpu.ops.measurement import sensor_pose

    blocked = jnp.asarray(floor_plan())
    lidar = LidarConfig(start=0.0, stop=math.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend="sdf")
    n = args.slam_particles
    cfg = SLAMConfig(
        mcl=MCLConfig(
            n_particles=n,
            meas_stddev=5.0,
            measurement="likelihood_field_table",
            lf_table_box=128,
            resample_every=4,
        ),
        lidar=lidar,
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=rc,
        map_pose="mode",
        edt_box=args.slam_edt_box,
    )
    engine = slam_mod.GridSLAM(cfg, seed=0)
    start = Pose.create(400.0, 400.0, math.pi)
    state = engine.init(start)
    odom = Odometry.create(0.02, 2.5, 0.02)
    # Two alternating scans keep map cells flipping in steady state so the
    # round-5 incremental-EDT path measures its WINDOW refresh, not its
    # no-flip skip branch (a single repeated scan converges the local map
    # and stops flipping in a couple of iterations).
    start2 = Pose.create(403.0, 403.0, math.pi + 0.05)
    scans = [
        fake_lidar.scan(
            blocked, sensor_pose(p, cfg.mcl.scanner_offset), lidar, rc
        )
        for p in (start, start2)
    ]
    st = engine.step(state, odom, scans[0])
    jax.block_until_ready(st)
    for i in range(3):
        st = engine.step(st, odom, scans[i % 2])
    jax.block_until_ready(st)
    t0 = _t.perf_counter()
    for i in range(args.iters * 4):
        st = engine.step(st, odom, scans[i % 2])
    jax.block_until_ready(st)
    per = (_t.perf_counter() - t0) / (args.iters * 4)
    emit(
        args, f"slam_production_step_ms_{n // 1000}k",
        per * 1e3,
        "ms",
        extra=f"full SLAM (mapping every step) {n} particles: "
        f"{per * 1e3:.1f} ms/step = {1 / per:.1f} Hz on {args.device['kind']} "
        "(box table + resample_every=4 + map_pose=mode)",
    )
    emit(
        args, "slam_production_particle_updates_per_s",
        n / per,
        "pu/s",
        baseline=_BASELINES.get("ref_mcl_best_particle_updates_per_s"),
    )


def _ij_to_world(h, i, j):
    return float(j), float(h - i)


def bench_hastar(args):
    import jax.numpy as jnp

    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import HybridAStarConfig, RaycastConfig
    from slam_tpu.core.types import Pose
    from slam_tpu.planners import HybridAStar

    blocked = floor_plan()
    h, w = blocked.shape
    free = jnp.asarray(~inflate(blocked, 7))  # 15px ellipse kernel ~ r=7
    ax, ay = _ij_to_world(h, 150, 450)
    bx, by = _ij_to_world(h, 450, 750)
    vel, steer = 10.0, 40 * math.pi / 180
    cfg = HybridAStarConfig(
        velocity=vel,
        max_steering=steer,
        length=vel * math.tan(steer) / (10 * math.pi / 180),
        # Lattice mode snaps headings to bin centers, so bins must be no
        # wider than ~the 10-deg per-edge heading change (36 bins); the
        # continuous mode keeps the reference benchmark's theta_res=5
        # (`benchmark/hastar.cpp:14`). Same vehicle, start, goal, tol —
        # the finer discretization makes OUR search space 7x larger.
        theta_res=(
            args.hastar_tres
            or (36 if args.hastar_mode == "lattice" else 5)
        ),
        branching_factor=3,
        tol=5.0,
        # reps=1 + w=1.3 + batch 512 (tools/hastar_ab.py sweeps these;
        # not yet re-tuned on the GPU).
        batch=args.hastar_batch,
        mode=args.hastar_mode,
        lattice_reps=(
            args.hastar_reps if args.hastar_reps is not None else 1
        ),
        heuristic_weight=(
            args.hastar_hweight
            if args.hastar_hweight is not None
            else (1.3 if args.hastar_mode == "lattice" else 1.0)
        ),
    )
    # Edge feasibility via the directional LUT: one gather per edge. The
    # table is built once per map (construct-once + reset_query, exactly the
    # C++ benchmark's pattern of one HybridAStar object reset per query).
    rc = RaycastConfig(backend="lut", step=1.0, lut_bins=180)

    a_pose = Pose.create(ax, ay, 0.0)
    b_pose = Pose.create(bx, by, 0.0)
    p = HybridAStar(free, a_pose, b_pose, cfg, rc)
    p.solve()  # warmup/compile

    def run():
        p.reset_query(a_pose, b_pose)
        return p.solve(), p

    t0 = time.perf_counter()
    oks = [run()[0] for _ in range(args.iters)]
    dt = (time.perf_counter() - t0) / args.iters
    base = _BASELINES.get("ref_hastar", {}).get("pathfind_ms")
    note = f"success={all(oks)}; mode={cfg.mode}; cost={p.path_cost():.0f}"
    if base:
        note += f"; C++ ref {base} ms -> speedup {base / (dt * 1e3):.2f}x"
    emit(args, "hastar_pathfind_ms", dt * 1e3, "ms", None, note)


def bench_rrtstar(args):
    import jax.numpy as jnp

    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import RRTStarConfig
    from slam_tpu.core.types import Pose
    from slam_tpu.planners import RRTStar

    blocked = floor_plan()
    h, w = blocked.shape
    free = jnp.asarray(~inflate(blocked, 7))
    a = _ij_to_world(h, 150, 450)
    b = _ij_to_world(h, 450, 750)
    cfg = RRTStarConfig(reach=20.0, radius=50.0, max_nodes=8192, batch=args.rrt_batch)

    p = RRTStar(free, a, b, cfg, seed=999)
    p.solve(max_rounds=400)  # warmup/compile

    def run(seed):
        p.reset_query(a, b, seed)
        return p.solve(max_rounds=400), p

    t0 = time.perf_counter()
    oks = [run(1234 + k)[0] for k in range(args.iters)]
    dt = (time.perf_counter() - t0) / args.iters
    base = _BASELINES.get("ref_rrtstar", {}).get("pathfind_ms")
    emit(
        args, "rrtstar_pathfind_ms",
        dt * 1e3,
        "ms",
        None,
        f"success={all(oks)}; C++ ref {base} ms -> speedup {base / (dt * 1e3):.2f}x"
        if base
        else f"success={all(oks)}",
    )


def bench_spatial(args):
    """`benchmark/quadtree.cpp` equivalents on the dense SoA buffer."""
    import jax
    import jax.numpy as jnp

    from slam_tpu.ops import spatial

    n, max_val, n_boxes = 1_000_000, 10_000, 1000
    rng = np.random.default_rng(0)
    px = rng.integers(0, max_val, n).astype(np.float32)
    py = rng.integers(0, max_val, n).astype(np.float32)
    lo = rng.integers(0, max_val, (n_boxes, 2)).astype(np.float32)
    ext = rng.integers(1, max_val // 10, (n_boxes, 2)).astype(np.float32)
    boxes = np.concatenate([lo, lo + ext], axis=1)

    # "Insert" (a): the dense design has no build phase — what replaces the
    # pointer-tree build is DEVICE PLACEMENT of the SoA buffer, emitted
    # under that name so it is not read as an algorithmic comparison.
    t0 = time.perf_counter()
    dpx = jnp.asarray(px)
    dpy = jnp.asarray(py)
    valid = jnp.ones((n,), bool)
    jax.block_until_ready((dpx, dpy, valid))
    insert_s = time.perf_counter() - t0
    base_ins = _BASELINES.get("ref_quadtree", {}).get("insert_pts_per_s")
    emit(
        args, "spatial_insert_placement_pts_per_s",
        n / insert_s,
        "points/s",
        base_ins,
        "device placement of the SoA buffer, not an index build",
    )

    # "Insert" (b): a compute-meaningful structured build — bucket the
    # points into a 256x256 cell grid and sort by cell id (the dense
    # analogue of the quadtree's spatial partitioning; one argsort on
    # device). This is real index-construction work, comparable to the
    # C++ tree build's.
    grid_cells = 256
    cell = max_val / grid_cells

    @jax.jit
    def build_bucketed(px_, py_):
        ci = (
            jnp.floor(py_ / cell).astype(jnp.int32) * grid_cells
            + jnp.floor(px_ / cell).astype(jnp.int32)
        )
        order = jnp.argsort(ci)
        return ci[order], order

    cid, order = build_bucketed(dpx, dpy)  # compile
    jax.block_until_ready(cid)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        cid, order = build_bucketed(dpx, dpy)
    jax.block_until_ready(cid)
    build_s = (time.perf_counter() - t0) / args.iters
    emit(
        args, "spatial_insert_bucketed_build_pts_per_s",
        n / build_s,
        "points/s",
        base_ins,
        f"{grid_cells}x{grid_cells} cell-id bucket sort (argsort on device)",
    )

    dboxes = jnp.asarray(boxes)

    @jax.jit
    def count_all(px_, py_, valid_, boxes_):
        def body(carry, box):
            m = spatial.in_box(px_, py_, valid_, (box[0], box[1], box[2], box[3]))
            return carry + jnp.sum(m), jnp.sum(m)

        total, _ = jax.lax.scan(body, jnp.int32(0), boxes_)
        return total

    total = int(count_all(dpx, dpy, valid, dboxes))  # compile+check
    t0 = time.perf_counter()
    for _ in range(args.iters):
        total = int(count_all(dpx, dpy, valid, dboxes))
    q_s = (time.perf_counter() - t0) / args.iters
    # Accept both key spellings: BASELINE_MEASURED.json ships
    # 'range_queries_per_s' but ref_planners_bench.cpp historically emitted
    # 'queries_per_s' (ADVICE r1).
    _ref_q = _BASELINES.get("ref_quadtree", {})
    base_q = _ref_q.get("range_queries_per_s", _ref_q.get("queries_per_s"))
    emit(
        args, "spatial_range_queries_per_s",
        n_boxes / q_s,
        "queries/s",
        base_q,
        f"{total} total hits over 1M points x 1000 boxes",
    )

    # NN throughput (kd-tree equivalent; `apps/nearest_neighbor` workload).
    qx = jnp.asarray(rng.integers(0, max_val, 1024).astype(np.float32))
    qy = jnp.asarray(rng.integers(0, max_val, 1024).astype(np.float32))
    nn = jax.jit(spatial.nearest_neighbor_blocked)
    idx, _ = nn(dpx, dpy, valid, qx, qy)
    jax.block_until_ready(idx)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        idx, _ = nn(dpx, dpy, valid, qx, qy)
    jax.block_until_ready(idx)
    nn_s = (time.perf_counter() - t0) / args.iters
    emit(args, "spatial_nn_queries_per_s", 1024 / nn_s, "queries/s")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("which", nargs="+",
                    choices=["mcl", "hastar", "rrtstar", "spatial", "slam",
                             "all"])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--slam-particles", type=int, default=1_000_000)
    ap.add_argument(
        "--slam-edt-box", type=int, default=None,
        help="SLAMConfig.edt_box for the production config (incremental "
        "scan-localized EDT refresh; must exceed 4*edt_capped_reach = 112 "
        "at stddev 5). None = per-step full-map rebuild.",
    )
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--hastar-batch", type=int, default=512)
    ap.add_argument(
        "--hastar-mode", default="lattice", choices=["continuous", "lattice"],
        help="lattice: heading-snapped search with fixed-shape rounds; "
        "continuous: the reference's continuous-heading expansion",
    )
    ap.add_argument("--hastar-tres", type=int, default=None)
    ap.add_argument("--hastar-reps", type=int, default=None)
    ap.add_argument("--hastar-hweight", type=float, default=None)
    ap.add_argument("--rrt-batch", type=int, default=256)
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args()

    from slam_tpu.utils.runtime import enable_compile_cache, require_gpu

    args.device = require_gpu(args.cpu)
    enable_compile_cache()

    which = set(args.which)
    if "all" in which:
        which = {"mcl", "hastar", "rrtstar", "spatial"}
    if "mcl" in which:
        bench_mcl(args)
    if "hastar" in which:
        bench_hastar(args)
    if "rrtstar" in which:
        bench_rrtstar(args)
    if "spatial" in which:
        bench_spatial(args)
    if "slam" in which:
        bench_slam(args)


if __name__ == "__main__":
    main()
