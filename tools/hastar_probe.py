#!/usr/bin/env python
"""Decompose the lattice HA* per-round cost on the device.

The work sweep (tools/hastar_ab.py --sweep work) showed query time tracks
rounds x batch x lanes, with a fixed per-round term. This probe separates,
by linear fit of time(solve(max_rounds=k)) over k:

  * batch-scaled work   (per-pop-lane scattered gathers/scatters)
  * ring-scan cost      (per-round argmin + cond over the [cap] open ring)
  * cuboid-size cost    (suspected XLA while_loop carry copies of the
                         [S] packed g|edge table: S = H*W*theta_res i32,
                         112 MB on the floor plan at theta_res=36)

by timing variants that change exactly one of batch / open_capacity /
theta_res. max_rounds is a traced arg (no recompile across k).

    python tools/hastar_probe.py           # GPU
    python tools/hastar_probe.py --cpu     # functional check
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


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import HybridAStarConfig, RaycastConfig
    from slam_tpu.core.types import Pose
    from slam_tpu.planners import HybridAStar

    blocked = synthetic_floor_plan()
    h, _w = blocked.shape
    free = jnp.asarray(~inflate(blocked, 7))
    a_pose = Pose.create(450.0, float(h - 150), 0.0)
    b_pose = Pose.create(750.0, float(h - 450), 0.0)
    rc = RaycastConfig(backend="lut", step=1.0, lut_bins=180)
    vel, steer = 10.0, 40 * math.pi / 180

    def planner(batch, theta_res=36, cap=None):
        kw = {} if cap is None else {"open_capacity": cap}
        cfg = HybridAStarConfig(
            velocity=vel,
            max_steering=steer,
            length=vel * math.tan(steer) / (10 * math.pi / 180),
            theta_res=theta_res,
            branching_factor=3,
            tol=5.0,
            batch=batch,
            mode="lattice",
            heuristic_weight=1.3,
            **kw,
        )
        return HybridAStar(free, a_pose, b_pose, cfg, rc)

    variants = {
        # name: (batch, theta_res, cap)
        "b2048": (2048, 36, None),
        "b256": (256, 36, None),
        "b256_cap64k": (256, 36, 1 << 16),
        "b256_th18": (256, 18, None),
        "b2048_cap64k": (2048, 36, 1 << 16),
    }
    ks = [4, 8, 16, 32, 64]

    out = {}
    for name, (batch, th, cap) in variants.items():
        p = planner(batch, th, cap)
        p.solve(max_rounds=8)  # warm/compile (fused query path)
        times = {}
        for k in ks:
            best = float("inf")
            for _ in range(args.reps):
                p.reset_query(a_pose, b_pose)
                t0 = time.perf_counter()
                p.solve(max_rounds=k)
                dt = time.perf_counter() - t0
                best = min(best, dt)
            times[k] = best * 1e3
        # least-squares slope over k
        xs = np.array(ks, float)
        ys = np.array([times[k] for k in ks])
        slope, intercept = np.polyfit(xs, ys, 1)
        out[name] = {
            "per_round_ms": round(float(slope), 4),
            "init_ms": round(float(intercept), 2),
            "times": {k: round(v, 1) for k, v in times.items()},
        }
        print(f"# {name}: {out[name]}", file=sys.stderr)

    # Init decomposition: the k-fit intercept is init + one synchronous
    # result fetch. Separate: the host round trip (fetch of a tiny resident
    # array), the fused init-only dispatch (solve(max_rounds=0)), and the
    # geodesic heuristic build alone.
    from slam_tpu.planners.hastar import _lattice_query_init_jit

    p = planner(2048)
    p.solve(max_rounds=2)  # warm both fused paths
    tiny = jnp.zeros((8,))

    def best_of(f, n=5):
        b = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            f()
            b = min(b, time.perf_counter() - t0)
        return b * 1e3

    rtt = best_of(lambda: np.asarray(jax.device_get(tiny[:1])))

    def init_only():
        # max_rounds=0 falls back to cfg.max_rounds; 1 -> one loop
        # iteration = 2 unrolled rounds on top of init.
        p.reset_query(a_pose, b_pose)
        p.solve(max_rounds=1)

    t_init = best_of(init_only)

    a_xyt = jnp.asarray([450.0, float(h - 150), 0.0])
    b_xyt = jnp.asarray([750.0, float(h - 450), 0.0])

    def heur_only():
        out = _lattice_query_init_jit(
            p._free, a_xyt, b_xyt, p.cfg, p.shape, p._ring_capacity()
        )
        np.asarray(jax.device_get(out[3].o_f[:1]))

    t_heur = best_of(heur_only)
    init_dec = {
        "rtt_ms": round(rtt, 2),
        "init_plus_fetch_ms": round(t_init, 2),
        "query_init_dispatch_ms": round(t_heur, 2),
    }
    print(f"# init decomposition: {init_dec}", file=sys.stderr)

    # Decomposition (floor plan, theta_res=36: S=27.97M, i32 gp = 112 MB)
    b2048, b256 = out["b2048"]["per_round_ms"], out["b256"]["per_round_ms"]
    ring = out["b256"]["per_round_ms"] - out["b256_cap64k"]["per_round_ms"]
    sdep = out["b256"]["per_round_ms"] - out["b256_th18"]["per_round_ms"]
    print(json.dumps({
        "metric": "hastar_lattice_round_decomposition",
        "per_round_ms": out,
        "batch_scaled_ms_per_1792_pops": round(b2048 - b256, 4),
        "ring_scan_ms_1m_vs_64k": round(ring, 4),
        "cuboid_size_ms_36_vs_18_bins": round(sdep, 4),
        "init": init_dec,
    }))


if __name__ == "__main__":
    main()
