#!/usr/bin/env python
"""Headline benchmark: MCL particle-filter step throughput on one GPU.

Reproduces the reference's MCL benchmark configuration
(reference `benchmark/mcl.cpp:11-64`: floor_plan map, 90 beams,
max_dist 500, scanner offset {0,30,0}, odometry {2.5,0.02,0.02}) at the
north-star particle count of 100k (BASELINE.md), on the shared-map
architecture, over the synthetic 599x1297 floor plan. Prints ONE JSON line:

    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
     "device": {"platform": ..., "kind": ..., "count": ...}}

vs_baseline compares against the measured C++ reference throughput on a
host CPU (BASELINE_MEASURED.json; the reference caps out near N=250 because
each particle owns a full map copy). Without a GPU the script exits
non-zero; ``--cpu`` runs a functional check whose metric says so.
"""

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed-block repeats; value = median (drift control)")
    ap.add_argument("--backend", default="lut", choices=["march", "sdf", "lut"])
    ap.add_argument(
        "--measurement", default="beam", choices=["beam", "likelihood_field"]
    )
    ap.add_argument("--cpu", action="store_true",
                    help="functional check off-chip (never a perf claim)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from slam_tpu.utils.runtime import enable_compile_cache, require_gpu

    device = require_gpu(args.cpu)
    enable_compile_cache()

    from slam_tpu.core.config import (
        LidarConfig,
        MCLConfig,
        RaycastConfig,
        beam_bin_stride,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.ops import rayfield

    blocked = jnp.asarray(synthetic_floor_plan())
    h, w = blocked.shape

    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    # Static map -> the one-gather-per-ray LUT backend (the fast path;
    # quality vs the exact march is covered by tests/test_rayfield.py).
    backend = args.backend
    if args.measurement == "likelihood_field" and backend == "lut":
        backend = "sdf"  # LF needs the EDT, not the beam LUT
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend=backend)
    cfg = MCLConfig(
        n_particles=args.particles,
        meas_stddev=5.0,
        scanner_offset=(0.0, 30.0, 0.0),
        measurement=args.measurement,
        # 90 beams over pi at 360 bins -> stride 2: enables the fused
        # panorama path (one row gather per particle per step).
        lut_beam_stride=beam_bin_stride(lidar, rc),
    )

    pose = Pose.create(400.0, 400.0, np.pi)
    sensor = mcl_mod.MCL.sensor_position(pose, cfg.scanner_offset)
    scan = fake_lidar.scan(blocked, sensor, lidar, RaycastConfig(max_dist=500.0))

    field = rayfield.make_ray_field(blocked, rc)  # one-off (map load time)
    odom = Odometry.create(2.5, 0.02, 0.02)
    alphas = jnp.asarray((0.0005, 0.0005, 0.01, 0.01))

    # field/scan go in as ARGUMENTS: closed-over arrays become jit constants,
    # and a constant-embedded LUT (hundreds of MB) blows up compile time.
    @jax.jit
    def step(state, field, scan):
        st = mcl_mod.predict(state, odom, alphas)
        return mcl_mod.update(st, scan, field, cfg, rc)

    # Per-phase probes. The weights probe dispatches on cfg.measurement
    # exactly like mcl.update, so the reported phase is the one the step
    # actually runs.
    from slam_tpu.ops import measurement, resample as resample_mod

    @jax.jit
    def phase_predict(state):
        return mcl_mod.predict(state, odom, alphas)

    if args.measurement == "likelihood_field":

        @jax.jit
        def phase_weights(state, field, scan):
            return measurement.particle_log_weights_likelihood_field(
                field,
                state.particles.pose,
                scan,
                rc=rc,
                scanner_offset=cfg.scanner_offset,
                stddev=cfg.meas_stddev,
                z_hit=cfg.lf_z_hit,
                z_rand=cfg.lf_z_rand,
            )

    else:

        @jax.jit
        def phase_weights(state, field, scan):
            return measurement.particle_log_weights(
                field,
                state.particles.pose,
                scan,
                rc=rc,
                scanner_offset=cfg.scanner_offset,
                stddev=cfg.meas_stddev,
                eps=cfg.meas_epsilon,
                lut_beam_stride=cfg.lut_beam_stride,
            )

    @jax.jit
    def phase_resample(key, particles):
        return resample_mod.resample(key, particles, cfg.resample)

    state = mcl_mod.init(jax.random.key(0), args.particles, pose)
    for _ in range(args.warmup):
        state = step(state, field, scan)
    jax.block_until_ready(state)

    # Repeat the timed block; report the MEDIAN with the min/max spread.
    block_secs = []
    for _ in range(max(1, args.repeats)):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state = step(state, field, scan)
        jax.block_until_ready(state)
        block_secs.append(time.perf_counter() - t0)
    med = float(np.median(block_secs))
    ms_per_step = [1e3 * s / args.iters for s in block_secs]

    def time_phase(fn, *a):
        # Same repeats/median as the headline block.
        out = fn(*a)
        jax.block_until_ready(out)
        reps = []
        for _ in range(max(1, args.repeats)):
            t0 = time.perf_counter()
            for _ in range(args.iters):
                out = fn(*a)
            jax.block_until_ready(out)
            reps.append(1e3 * (time.perf_counter() - t0) / args.iters)
        return float(np.median(reps))

    phases = {
        "predict_ms": round(time_phase(phase_predict, state), 3),
        "measurement_ms": round(time_phase(phase_weights, state, field, scan), 3),
        "resample_ms": round(
            time_phase(phase_resample, jax.random.key(1), state.particles), 3
        ),
    }

    value = args.particles * args.iters / med

    with open(os.path.join(os.path.dirname(__file__), "BASELINE_MEASURED.json")) as f:
        baseline = json.load(f)["ref_mcl_best_particle_updates_per_s"]

    on_cpu = device["platform"] == "cpu"
    print(
        json.dumps(
            {
                "metric": (
                    "cpu_functional_check_particle_updates_per_s" if on_cpu
                    else f"mcl_particle_updates_per_s_{args.particles // 1000}k"
                ),
                "value": round(value, 1),
                "unit": "particle-updates/s",
                "vs_baseline": None if on_cpu else round(value / baseline, 2),
                "device": device,
                "ms_per_step": {
                    "median": round(float(np.median(ms_per_step)), 2),
                    "min": round(min(ms_per_step), 2),
                    "max": round(max(ms_per_step), 2),
                    "repeats": len(ms_per_step),
                },
                "phases": phases,
            }
        )
    )
    print(
        f"# {args.particles} particles x {args.iters} iters x "
        f"{len(block_secs)} repeats; median {1e3 * med / args.iters:.1f} "
        f"ms/step (min {min(ms_per_step):.1f}, max {max(ms_per_step):.1f}) on "
        f"{device['kind']}; map {h}x{w}, 90 beams; phases {phases}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
