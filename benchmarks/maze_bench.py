#!/usr/bin/env python
"""Big-map benchmark: MCL on a maze at the reference maze's 2354x2464 px.

Sphere tracing (sdf) is at its worst here (grazing rays in long corridors),
so the static-map path is the bins-LAST dense table + panorama-fused
measurement (see slam_tpu.ops.lut): the per-step cost is one 360-byte row
read per particle regardless of map size, and the u8 fixed-point table
(2.1 GB at 360 bins) halves device memory vs bf16. CDDT's compressed probes
(binary searches -> gather chains) trade that memory for dependent gathers.

The map is `simulate.synthetic_maze` unless ``--map`` names a PNG. Emits
JSON lines, each naming the device:
  <map>_mcl_step_ms_10k      — full predict+update+resample step latency
  <map>_localization_ate_px  — closed-loop tracking ATE (60 steps)
  <map>_lut_build_s          — one-off table build time

Usage: python benchmarks/maze_bench.py [--particles 10000] [--dtype u8]
"""

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
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dtype", default="u8", choices=["u8", "bf16"])
    ap.add_argument(
        "--backend", default="lut", choices=["lut", "cddt"],
        help="dense table or compressed intervals (50x less device memory "
        "on the maze: 42 MB vs 2.09 GiB, K=17)",
    )
    ap.add_argument("--bins", type=int, default=360)
    ap.add_argument("--quality-steps", type=int, default=60)
    ap.add_argument("--map", default=None,
                    help="maze PNG (default: the generated maze)")
    ap.add_argument("--size", type=int, nargs=2, default=(2354, 2464),
                    metavar=("H", "W"), help="generated-maze size")
    ap.add_argument("--pitch", type=int, default=40,
                    help="generated-maze wall spacing (px); with --size 7000 "
                    "7000 --pitch 400 --backend cddt the dense u8 table would "
                    "be size^2 * bins bytes (17.6 GB at 7000^2 x 360) while "
                    "the compressed intervals stay small")
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from slam_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu(args.cpu)
    enable_compile_cache()

    from slam_tpu.core.config import (
        LidarConfig,
        MCLConfig,
        MotionConfig,
        RaycastConfig,
        SLAMConfig,
        beam_bin_stride,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod, simulate
    from slam_tpu.ops import rayfield
    from slam_tpu.utils.metrics import ate_rmse

    if args.map:
        from slam_tpu.utils.maps import load_binary_map

        blocked_np = load_binary_map(args.map) == 0
    else:
        blocked_np = simulate.synthetic_maze(*args.size, pitch=args.pitch)
    h, w = blocked_np.shape
    blocked = jnp.asarray(blocked_np)

    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    rc = RaycastConfig(
        step=0.5,
        max_dist=500.0,
        backend=args.backend,
        lut_bins=args.bins,
        lut_dtype=args.dtype,
    )
    cfg = MCLConfig(
        n_particles=args.particles,
        meas_stddev=5.0,
        # The panorama-fused path needs the dense bins-last table.
        lut_beam_stride=(
            beam_bin_stride(lidar, rc) if args.backend == "lut" else None
        ),
    )

    t0 = time.perf_counter()
    field = rayfield.make_ray_field(
        blocked, rc, cache_dir=os.path.join(os.path.dirname(__file__), "..", ".build", "lut_cache")
    )
    if args.backend == "lut":
        jax.block_until_ready(field.lut)
        build_s = time.perf_counter() - t0
        gib = field.lut.size * field.lut.dtype.itemsize / 2**30
        print(
            f"# LUT [{h}x{w}x{args.bins}] {args.dtype} = {gib:.2f} GiB, "
            f"built in {build_s:.1f}s",
            file=sys.stderr,
        )
    else:
        jax.block_until_ready(field.cddt.starts)
        build_s = time.perf_counter() - t0
        print(
            f"# CDDT [{args.bins // 2}x{field.cddt.d}xK={field.cddt.k}] = "
            f"{field.cddt.nbytes / 2**20:.0f} MiB, built in {build_s:.1f}s",
            file=sys.stderr,
        )

    sx, sy = simulate.find_start(blocked_np)
    pose = Pose.create(sx, sy, 0.9)
    scan = fake_lidar.scan(blocked, pose, lidar, RaycastConfig(max_dist=500.0))
    odom = Odometry.create(0.05, 1.0, 0.05)
    alphas = jnp.asarray((5e-4, 5e-4, 1e-2, 1e-2))

    @jax.jit
    def step(state, field, scan):
        st = mcl_mod.predict(state, odom, alphas)
        return mcl_mod.update(st, scan, field, cfg, rc)

    state = mcl_mod.init(jax.random.key(0), args.particles, pose)
    for _ in range(3):
        state = step(state, field, scan)
    jax.block_until_ready(state.particles.log_weight)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state = step(state, field, scan)
    jax.block_until_ready(state.particles.log_weight)
    step_ms = (time.perf_counter() - t0) / args.iters * 1e3

    # Closed-loop quality: tight arc inside the corridor around the start.
    slam_cfg = SLAMConfig(
        mcl=cfg,
        lidar=lidar,
        motion=MotionConfig(alphas=(5e-4, 5e-4, 1e-2, 1e-2)),
        raycast=rc,
    )
    commands = simulate.forward_arc_commands(
        args.quality_steps, trans=1.2, rot=0.25
    )
    res = simulate.run_localization(
        blocked, slam_cfg, commands, pose, seed=1, field=field
    )
    ate = ate_rmse(res.est_xy, res.gt_xy)

    tag = "" if args.backend == "lut" else f"_{args.backend}"
    name = "maze" if args.map else f"synthmaze{h}x{w}"
    if device["platform"] == "cpu":
        name = f"cpu_functional_check_{name}"
    for metric, value, unit in (
        (f"{name}_mcl_step_ms_{args.particles // 1000}k{tag}", step_ms, "ms"),
        (f"{name}_localization_ate_px{tag}", float(ate), "px"),
        (f"{name}_{args.backend}_build_s", build_s, "s"),
    ):
        print(
            json.dumps(
                {"metric": metric, "value": round(value, 3), "unit": unit,
                 "device": device}
            )
        )


if __name__ == "__main__":
    main()
