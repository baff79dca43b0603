#!/usr/bin/env python
"""Same-process Hybrid A* A/B on the reference benchmark query.

Dispatch-latency-bound workloads vary between runs and machines, so
absolute planner numbers from different runs are incomparable. This tool
interleaves all variants round-robin in ONE process (continuous mode
doubles as the control) and reports per-variant min/mean, so the variant
RATIOS hold within the run.

    python tools/hastar_ab.py            # GPU
    python tools/hastar_ab.py --cpu      # functional check
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_planner(
    free, a_pose, b_pose, rc, *, mode, reps, hweight, batch, cap=None, skip=None
):
    from slam_tpu.core.config import HybridAStarConfig
    from slam_tpu.planners import HybridAStar

    vel, steer = 10.0, 40 * math.pi / 180
    kw = {}
    if cap is not None:
        kw["open_capacity"] = cap
    if skip is not None:
        kw["lattice_skip_precheck"] = skip
    cfg = HybridAStarConfig(
        velocity=vel,
        max_steering=steer,
        length=vel * math.tan(steer) / (10 * math.pi / 180),
        theta_res=36 if mode == "lattice" else 5,
        branching_factor=3,
        tol=5.0,
        batch=batch,
        mode=mode,
        lattice_reps=reps,
        heuristic_weight=hweight,
        **kw,
    )
    return HybridAStar(free, a_pose, b_pose, cfg, rc)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=5, help="timed runs/variant")
    ap.add_argument(
        "--sweep",
        choices=["verdict", "work", "precheck", "batch"],
        default="verdict",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.apps.common import inflate
    from slam_tpu.core.config import RaycastConfig
    from slam_tpu.core.types import Pose

    blocked = synthetic_floor_plan()
    h, _w = blocked.shape
    free = jnp.asarray(~inflate(blocked, 7))
    a_pose = Pose.create(450.0, float(h - 150), 0.0)
    b_pose = Pose.create(750.0, float(h - 450), 0.0)
    rc = RaycastConfig(backend="lut", step=1.0, lut_bins=180)

    # CPU-verified honest round counts on this query (n_lost == 0):
    # r3/w1.25/b8192 = 28 (cost 750); r4/w1.3/b16384/cap4M = 19 (745);
    # r6/w1.3/b16384/cap4M = 14 (755). Per-round latency grows with
    # lanes x batch, so only the A/B on the device picks the winner.
    if args.sweep == "verdict":
        variants = {
            "continuous_b512": dict(mode="continuous", reps=1, hweight=1.0, batch=512),
            "lattice_r1_w1.0_b4096": dict(mode="lattice", reps=1, hweight=1.0, batch=4096),
            "lattice_r3_w1.25_b8192": dict(mode="lattice", reps=3, hweight=1.25, batch=8192),
            "lattice_r4_w1.3_b16384_cap4M": dict(
                mode="lattice", reps=4, hweight=1.3, batch=16384, cap=4_000_000
            ),
            "lattice_r6_w1.3_b16384_cap4M": dict(
                mode="lattice", reps=6, hweight=1.3, batch=16384, cap=4_000_000
            ),
        }
    elif args.sweep == "batch":
        # Find the batch floor (smaller batches = less per-round work but
        # more rounds).
        variants = {
            "continuous_b512": dict(mode="continuous", reps=1, hweight=1.0, batch=512),
            "lat_w1.3_b512": dict(mode="lattice", reps=1, hweight=1.3, batch=512),
            "lat_w1.3_b384": dict(mode="lattice", reps=1, hweight=1.3, batch=384),
            "lat_w1.3_b256": dict(mode="lattice", reps=1, hweight=1.3, batch=256),
            "lat_w1.35_b512": dict(mode="lattice", reps=1, hweight=1.35, batch=512),
            "lat_w1.3_b128": dict(mode="lattice", reps=1, hweight=1.3, batch=128),
        }
    elif args.sweep == "precheck":
        # Same-process A/B of the pre-scatter readback skip, plus the
        # batch-size frontier at w=1.3.
        variants = {
            "continuous_b512": dict(mode="continuous", reps=1, hweight=1.0, batch=512),
            "lat_w1.3_b2048_skipT": dict(
                mode="lattice", reps=1, hweight=1.3, batch=2048, skip=True
            ),
            "lat_w1.3_b2048_skipF": dict(
                mode="lattice", reps=1, hweight=1.3, batch=2048, skip=False
            ),
            "lat_w1.3_b1024_skipT": dict(
                mode="lattice", reps=1, hweight=1.3, batch=1024, skip=True
            ),
            "lat_w1.3_b1024_skipF": dict(
                mode="lattice", reps=1, hweight=1.3, batch=1024, skip=False
            ),
            "lat_w1.3_b3072_skipT": dict(
                mode="lattice", reps=1, hweight=1.3, batch=3072, skip=True
            ),
        }
    else:
        # If time tracks rounds x batch x lanes (per-pop work), NOT rounds,
        # macro lanes and fat batches lose. This sweep minimizes TOTAL POP
        # SLOTS:
        # reps=1 (no lanes), weighted A* to cut expansions, batch sized to
        # the actual frontier.
        variants = {
            "continuous_b512": dict(mode="continuous", reps=1, hweight=1.0, batch=512),
            "lattice_r1_w1.0_b4096": dict(mode="lattice", reps=1, hweight=1.0, batch=4096),
            "lattice_r1_w1.1_b4096": dict(mode="lattice", reps=1, hweight=1.1, batch=4096),
            "lattice_r1_w1.2_b4096": dict(mode="lattice", reps=1, hweight=1.2, batch=4096),
            "lattice_r1_w1.3_b4096": dict(mode="lattice", reps=1, hweight=1.3, batch=4096),
            "lattice_r1_w1.3_b2048": dict(mode="lattice", reps=1, hweight=1.3, batch=2048),
            "lattice_r1_w1.2_b2048": dict(mode="lattice", reps=1, hweight=1.2, batch=2048),
        }
    planners = {}
    for name, kw in variants.items():
        p = build_planner(free, a_pose, b_pose, rc, **kw)
        ok = p.solve()  # warm/compile
        print(f"# warm {name}: success={ok} cost={p.path_cost():.0f}", file=sys.stderr)
        planners[name] = p

    times = {name: [] for name in variants}
    for k in range(args.reps):
        for name, p in planners.items():
            p.reset_query(a_pose, b_pose)
            t0 = time.perf_counter()
            ok = p.solve()
            dt = time.perf_counter() - t0
            assert ok, name
            times[name].append(dt * 1e3)
            print(f"# round {k} {name}: {dt * 1e3:.1f} ms", file=sys.stderr)

    base = None
    try:
        with open(os.path.join(os.path.dirname(__file__), "..", "BASELINE_MEASURED.json")) as f:
            base = json.load(f)["ref_hastar"]["pathfind_ms"]
    except Exception:
        pass
    for name, ts in times.items():
        rec = {
            "metric": f"hastar_ab_{name}_ms",
            "value": round(min(ts), 2),
            "unit": "ms",
            "mean_ms": round(sum(ts) / len(ts), 2),
            "cost": round(planners[name].path_cost(), 0),
        }
        if base:
            rec["vs_cpp_ms"] = base
            rec["speedup"] = round(base / min(ts), 2)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
