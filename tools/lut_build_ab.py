#!/usr/bin/env python
"""Same-process A/B of the dense beam-LUT build: quad (4-fold symmetric,
one rotated canvas serves 4 bins) vs the direct per-bin construction.

The build is gather-bound (rotation resampling + back-sampling), so the
quad construction's 4x rotation-gather cut should show directly on the
device. Floor-plan-sized map by default; pass --maze for the big-map
build.

    python tools/lut_build_ab.py          # GPU, floor plan, 360 bins
    python tools/lut_build_ab.py --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--maze", action="store_true")
    ap.add_argument("--bins", type=int, default=360)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_tpu.ops import lut as lutlib

    if args.maze:
        from slam_tpu.utils.maps import load_binary_map

        blocked = jnp.asarray(
            load_binary_map("/root/reference/assets/maze.png") == 0
        )
        args.reps = 1
    else:
        from slam_tpu.models.simulate import synthetic_floor_plan

        blocked = jnp.asarray(synthetic_floor_plan())

    def fence(x):
        np.asarray(jax.device_get(x.ravel()[:1]))

    results = {}
    for name, force in (("quad", False), ("per_bin", True)):
        # Warm (compile) once, then time.
        lut = lutlib.build_beam_lut(
            blocked, n_bins=args.bins, dtype=jnp.uint8, _force_per_bin=force
        )
        fence(lut)
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            lut = lutlib.build_beam_lut(
                blocked, n_bins=args.bins, dtype=jnp.uint8,
                _force_per_bin=force,
            )
            fence(lut)
            ts.append(time.perf_counter() - t0)
        results[name] = min(ts)
        print(f"# {name}: {min(ts):.2f}s (reps {ts})", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "lut_build_quad_s",
                "value": round(results["quad"], 2),
                "unit": "s",
                "per_bin_s": round(results["per_bin"], 2),
                "speedup": round(results["per_bin"] / results["quad"], 2),
                "map": "maze" if args.maze else "floor_plan",
                "bins": args.bins,
            }
        )
    )


if __name__ == "__main__":
    main()
