"""A* grid planner demo.

The reference ships A* as library-only (no app drives it — SURVEY.md
section 3.5); this demo completes the set: wavefront distance field from
start, greedy-descent path recovery, PNG output.

    python -m slam_tpu.apps.astar_planner --map floor_plan.png \
        --start 450 250 --goal 250 650
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from slam_tpu.apps.common import inflate, load_blocked, measure_time
from slam_tpu.planners import AStar
from slam_tpu.utils import render
from slam_tpu.utils.runtime import enable_compile_cache, require_gpu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None)
    ap.add_argument("--start", type=int, nargs=2, default=None, metavar=("I", "J"))
    ap.add_argument("--goal", type=int, nargs=2, default=None, metavar=("I", "J"))
    ap.add_argument("--inflate", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="image to write (nothing is written when absent)")
    ap.add_argument("--animate", default=None, metavar="GIF",
                    help="write wavefront animation (uses the incremental API)")
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    print("device:", require_gpu(args.cpu))
    enable_compile_cache()

    blocked = load_blocked(args.map)
    h, w = blocked.shape
    free = jnp.asarray(~inflate(blocked, args.inflate))
    start = tuple(args.start or (h // 2, w // 4))
    goal = tuple(args.goal or (3 * h // 4 + h // 8, 3 * w // 4))

    planner = AStar(free, start, goal)
    if args.animate:
        import numpy as _np

        frames = []
        with measure_time("A* distance field (animated)"):
            while not planner.pathfind(rounds=16):
                img = render.blocked_to_rgb(blocked)
                reached = _np.isfinite(_np.asarray(planner.dist)) & (
                    _np.asarray(planner.dist) < 1e29
                )
                img[reached] = (img[reached] * 0.4 + _np.array(render.BLUE) * 0.6).astype(
                    _np.uint8
                )
                frames.append(img)
        ok = planner.success
        if frames:
            render.save_gif(frames, args.animate)
            print(f"animation -> {args.animate}")
    else:
        with measure_time("A* distance field"):
            ok = planner.solve()

    img = render.blocked_to_rgb(blocked)
    if ok:
        path = planner.recover_path()
        render.draw_path_cells(img, path, render.GREEN)
        print(f"path: {len(path)} cells, cost {planner.path_cost():.1f}")
    else:
        print("no path found")
    render.draw_disc(img, start[0], start[1], 4, render.BLUE)
    render.draw_disc(img, goal[0], goal[1], 4, render.RED)
    if args.out:
        render.save_png(img, args.out)
        print(f"-> {args.out}")
    return ok


if __name__ == "__main__":
    main()
