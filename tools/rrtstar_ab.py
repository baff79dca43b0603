#!/usr/bin/env python
"""Same-process RRT* A/B on the reference benchmark query.

Every variant is interleaved round-robin in ONE process, the way
`tools/hastar_ab.py` compares HA* variants, with the continuous-mode Hybrid
A* query as a control in the same table, so the variant ratios hold within
the run.

Reference config (reference `benchmark/rrtstar.cpp:10-33`): floor plan,
start image (150,450) goal (450,750), reach 20, radius 50, seeds 1234+k per
query.

    python tools/rrtstar_ab.py            # GPU
    python tools/rrtstar_ab.py --cpu      # functional check
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=7, help="timed runs/variant")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import (
        HybridAStarConfig,
        RaycastConfig,
        RRTStarConfig,
    )
    from slam_tpu.core.types import Pose
    from slam_tpu.planners import HybridAStar, RRTStar

    blocked = synthetic_floor_plan()
    h, _w = blocked.shape
    free = jnp.asarray(~inflate(blocked, 7))
    # RRT* takes (x, y) tuples; the HA* drift control takes Poses.
    a_xy, b_xy = (450.0, float(h - 150)), (750.0, float(h - 450))
    a = Pose.create(*a_xy, 0.0)
    b = Pose.create(*b_xy, 0.0)

    # Control: the continuous-mode HA* query (~100 small dispatches, the
    # most sensitive to dispatch latency).
    vel, steer = 10.0, 40 * math.pi / 180
    hcfg = HybridAStarConfig(
        velocity=vel,
        max_steering=steer,
        length=vel * math.tan(steer) / (10 * math.pi / 180),
        theta_res=5,
        branching_factor=3,
        tol=5.0,
        batch=512,
        mode="continuous",
    )
    control = HybridAStar(
        free, a, b, hcfg, RaycastConfig(backend="lut", step=1.0, lut_bins=180)
    )
    assert control.solve(), "drift control failed to plan"

    variants = {
        "rrt_b512": RRTStarConfig(reach=20.0, radius=50.0, max_nodes=8192, batch=512),
        "rrt_b256": RRTStarConfig(reach=20.0, radius=50.0, max_nodes=8192, batch=256),
        # batch=1024 exhausts the 8192-node budget in 8 rounds and fails
        # on some seeds — not a valid benchmark config.
    }
    planners = {}
    for name, cfg in variants.items():
        p = RRTStar(free, a_xy, b_xy, cfg, seed=999)
        ok = p.solve(max_rounds=400)  # warm/compile
        print(f"# warm {name}: success={ok} cost={p.path_cost():.0f}",
              file=sys.stderr)
        planners[name] = p

    times = {name: [] for name in variants}
    times["control_hastar_cont_b512"] = []
    costs = {}
    for k in range(args.reps):
        control.reset_query(a, b)
        t0 = time.perf_counter()
        assert control.solve()
        times["control_hastar_cont_b512"].append(
            (time.perf_counter() - t0) * 1e3
        )
        for name, p in planners.items():
            p.reset_query(a_xy, b_xy, seed=1234 + k)  # the reference's per-query seeds
            t0 = time.perf_counter()
            ok = p.solve(max_rounds=400)
            dt = (time.perf_counter() - t0) * 1e3
            # RRT* is stochastic; count failures but keep the timing honest
            # (the C++ benchmark times every query, success or not).
            if not ok:
                print(f"# round {k} {name}: FAILED", file=sys.stderr)
            times[name].append(dt)
            costs[name] = p.path_cost()
            print(f"# round {k} {name}: {dt:.1f} ms cost {p.path_cost():.0f}",
                  file=sys.stderr)

    base = None
    try:
        with open(os.path.join(os.path.dirname(__file__), "..",
                               "BASELINE_MEASURED.json")) as f:
            base = json.load(f)["ref_rrtstar"]["pathfind_ms"]
    except Exception:
        pass
    for name, ts in times.items():
        rec = {
            "metric": f"rrtstar_ab_{name}_ms",
            "value": round(min(ts), 2),
            "unit": "ms",
            "mean_ms": round(sum(ts) / len(ts), 2),
            "median_ms": round(sorted(ts)[len(ts) // 2], 2),
        }
        if name in costs:
            rec["cost"] = round(costs[name], 0)
            if base:
                rec["vs_cpp_ms"] = base
                rec["speedup"] = round(base / min(ts), 2)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
