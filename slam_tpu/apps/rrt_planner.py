"""RRT* planner demo (headless rebuild of `apps/rrt_planner.cpp`).

The reference takes endpoints from mouse clicks on an eroded CV_64F map,
runs RRTStar(reach=20, radius=50) until a path exists AND at least n_points
nodes were added (`apps/rrt_planner.cpp:50`), then draws the tree + path.

    python -m slam_tpu.apps.rrt_planner --map floor_plan.png \
        --start 150 450 --goal 450 750 --n-points 2000 --out rrt.png
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from slam_tpu.apps.common import inflate, load_blocked, measure_time
from slam_tpu.core.config import RRTStarConfig, RaycastConfig
from slam_tpu.planners import RRTStar
from slam_tpu.utils import render
from slam_tpu.utils.runtime import enable_compile_cache, require_gpu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None)
    ap.add_argument("--start", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--goal", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--reach", type=float, default=20.0)
    ap.add_argument("--radius", type=float, default=50.0)
    ap.add_argument("--n-points", type=int, default=1000)
    ap.add_argument("--max-nodes", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--inflate", type=int, default=5)
    ap.add_argument("--seed", type=int, default=1234)  # `benchmark/rrtstar.cpp`
    ap.add_argument("--out", default=None,
                    help="image to write (nothing is written when absent)")
    ap.add_argument("--animate", default=None, metavar="GIF",
                    help="write tree-growth animation (round-by-round API)")
    ap.add_argument(
        "--interactive", action="store_true",
        help="read 'X1 Y1 X2 Y2' queries from stdin and replan on the warm "
        "planner (headless mouse loop, `apps/rrt_planner.cpp:44-68`)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    print("device:", require_gpu(args.cpu))
    enable_compile_cache()

    blocked = load_blocked(args.map)
    h, w = blocked.shape
    free = jnp.asarray(~inflate(blocked, args.inflate))

    start = tuple(args.start or (w * 0.25, h * 0.5))
    goal = tuple(args.goal or (w * 0.75, h * 0.25))
    cfg = RRTStarConfig(
        reach=args.reach,
        radius=args.radius,
        max_nodes=args.max_nodes,
        batch=args.batch,
    )
    planner = RRTStar(free, start, goal, cfg, seed=args.seed)

    def run_and_render(out):
        frames = []
        with measure_time("RRT* pathfind"):
            # Iterate until success AND enough nodes (`rrt_planner.cpp:50`).
            while True:
                done = planner.pathfind()
                if args.animate:
                    fr = render.blocked_to_rgb(blocked)
                    xs0 = np.asarray(planner.state.x)
                    ys0 = np.asarray(planner.state.y)
                    par0 = np.asarray(planner.state.parent)
                    for i in np.nonzero(np.asarray(planner.state.valid))[0]:
                        if par0[i] >= 0:
                            render.draw_path_world(
                                fr, [(xs0[i], ys0[i]), (xs0[par0[i]], ys0[par0[i]])],
                                render.BLUE,
                            )
                    frames.append(fr)
                if (done or planner.success) and planner.size >= args.n_points:
                    break
                if planner.used_up:
                    break
        if args.animate and frames:
            render.save_gif(frames, args.animate, fps=5)
            print(f"animation -> {args.animate}")

        img = render.blocked_to_rgb(blocked)
        # Tree edges (the reference draws each as it is added).
        xs = np.asarray(planner.state.x)
        ys = np.asarray(planner.state.y)
        par = np.asarray(planner.state.parent)
        val = np.asarray(planner.state.valid)
        for i in np.nonzero(val)[0]:
            p = par[i]
            if p >= 0:
                render.draw_path_world(img, [(xs[i], ys[i]), (xs[p], ys[p])], render.BLUE)
        if planner.success:
            render.draw_path_world(img, planner.recover_path(), render.GREEN)
            print(f"path cost {planner.path_cost():.1f}, {planner.size} nodes")
        else:
            print(f"no path ({planner.size} nodes)")
        if out:
            render.save_png(img, out)
            print(f"-> {out}")
        return planner.success

    ok = run_and_render(args.out)
    if args.interactive:
        from slam_tpu.apps.common import interactive_queries

        stem, dot, ext = (args.out or "").rpartition(".")
        for k, (s, g) in enumerate(interactive_queries(), start=1):
            planner.reset_query(s, g, seed=args.seed)  # warm replan
            ok = run_and_render(
                args.out and (f"{stem}_{k}{dot}{ext}" if dot else f"{args.out}_{k}")
            )
    return ok


if __name__ == "__main__":
    main()
