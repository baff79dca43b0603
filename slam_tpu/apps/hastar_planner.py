"""Hybrid A* planner demo (headless rebuild of `apps/hastar_planner.cpp`).

The reference takes start/goal from mouse clicks, erodes the map by an
ellipse kernel for vehicle inflation (`apps/hastar_planner.cpp:130-134`),
runs the stepping loop with optional animation, times it (`:29-48,101`), and
draws the recovered path (`:101-115`). Vehicle defaults VEL=10, steer=40deg,
derived length (`:21-25`).

    python -m slam_tpu.apps.hastar_planner --map floor_plan.png \
        --start 450 250 --goal 250 650 --out hastar.png
"""

from __future__ import annotations

import argparse
import math

import jax.numpy as jnp
import numpy as np

from slam_tpu.apps.common import inflate, load_blocked, measure_time
from slam_tpu.core.config import HybridAStarConfig, RaycastConfig
from slam_tpu.core.types import Pose
from slam_tpu.planners import HybridAStar
from slam_tpu.utils import render
from slam_tpu.utils.runtime import enable_compile_cache, require_gpu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--map", default=None)
    ap.add_argument("--start", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--goal", type=float, nargs=2, default=None, metavar=("X", "Y"))
    ap.add_argument("--velocity", type=float, default=10.0)
    ap.add_argument("--steering-deg", type=float, default=40.0)
    ap.add_argument("--theta-res", type=int, default=5)
    ap.add_argument("--branching", type=int, default=3)
    ap.add_argument("--tol", type=float, default=5.0)
    ap.add_argument("--inflate", type=int, default=5)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--backend", default="sdf", choices=["march", "sdf"])
    ap.add_argument("--out", default=None,
                    help="image to write (nothing is written when absent)")
    ap.add_argument("--animate", default=None, metavar="GIF",
                    help="write expansion animation via the incremental API "
                    "(the reference draws expansions on the canvas threaded "
                    "through pathfind, `slam/hastar.cpp:168-204`)")
    ap.add_argument("--animate-every", type=int, default=4,
                    help="rounds per animation frame")
    ap.add_argument(
        "--interactive", action="store_true",
        help="read 'X1 Y1 X2 Y2' queries from stdin and replan on the warm "
        "planner (headless mouse loop, `apps/hastar_planner.cpp:50-117`)",
    )
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    print("device:", require_gpu(args.cpu))
    enable_compile_cache()

    blocked = load_blocked(args.map)
    h, w = blocked.shape
    blocked_inf = inflate(blocked, args.inflate)
    free = jnp.asarray(~blocked_inf)

    start = args.start or (w * 0.25, h * 0.5)
    goal = args.goal or (w * 0.75, h * 0.5)
    steer = args.steering_deg * math.pi / 180.0
    cfg = HybridAStarConfig(
        velocity=args.velocity,
        max_steering=steer,
        length=args.velocity / math.tan(steer) * 2.0,  # `hastar_planner.cpp:21-25`
        theta_res=args.theta_res,
        branching_factor=args.branching,
        tol=args.tol,
        batch=args.batch,
    )

    a = Pose.create(start[0], start[1], 0.0)
    b = Pose.create(goal[0], goal[1], 0.0)
    planner = HybridAStar(free, a, b, cfg, RaycastConfig(backend=args.backend, step=1.0))

    def _reached_cells():
        """bool[H, W] cells touched by the search (any heading bin).

        The bin reduction happens ON DEVICE so each frame fetches the
        [H, W] bool (~0.8 MB on the floor plan), not the full
        [H*W*theta_res] cost table (~112 MB i32 at theta_res=36)."""
        import jax.numpy as jnp

        from slam_tpu.planners.hastar import INF, _INF_PACKED

        k = cfg.theta_res
        if cfg.mode == "lattice":
            touched = planner.state.gp != _INF_PACKED
        else:
            touched = planner.state.g < INF
        return np.asarray(
            jnp.any(touched.reshape(h * w, k), axis=1).reshape(h, w)
        )

    def run_and_render(a, b, out, gif=None):
        if gif:
            frames = []
            with measure_time("hybrid A* pathfind (animated)"):
                rounds, done = 0, False
                # Same round budget as solve() (cfg.max_rounds), so a hard
                # query terminates instead of accumulating frames forever.
                while not done and rounds < cfg.max_rounds:
                    done = planner.pathfind()
                    rounds += 1
                    if done or rounds % max(1, args.animate_every) == 0:
                        fr = render.blocked_to_rgb(blocked)
                        reach = _reached_cells()
                        fr[reach] = (
                            fr[reach] * 0.4 + np.array(render.BLUE) * 0.6
                        ).astype(np.uint8)
                        frames.append(fr)
            ok = planner.success
            if frames:
                render.save_gif(frames, gif, fps=5)
                print(f"animation -> {gif}")
        else:
            with measure_time("hybrid A* pathfind"):
                ok = planner.solve()
        img = render.blocked_to_rgb(blocked)
        if ok:
            path = planner.recover_path()
            render.draw_path_cells(img, path, render.GREEN)
            print(
                f"path found: {len(path)} cells, cost {planner.path_cost():.1f}, "
                f"{int(planner.state.n_expanded)} expansions"
            )
        else:
            print("no path found")
        render.draw_pose(img, a.x, a.y, a.theta, render.BLUE, 4)
        render.draw_pose(img, b.x, b.y, b.theta, render.RED, 4)
        if out:
            render.save_png(img, out)
            print(f"-> {out}")
        return ok

    ok = run_and_render(a, b, args.out, gif=args.animate)
    if args.interactive:
        from slam_tpu.apps.common import interactive_queries

        def _suffixed(path, k):
            if not path:
                return None
            stem, dot, ext = path.rpartition(".")
            return f"{stem}_{k}{dot}{ext}" if dot else f"{path}_{k}"

        for k, (s, g) in enumerate(interactive_queries(), start=1):
            a = Pose.create(s[0], s[1], 0.0)
            b = Pose.create(g[0], g[1], 0.0)
            planner.reset_query(a, b)  # warm: keeps map/ray-field/compilation
            ok = run_and_render(
                a, b, _suffixed(args.out, k),
                gif=_suffixed(args.animate, k),
            )
    return ok


if __name__ == "__main__":
    main()
