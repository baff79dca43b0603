"""Box range-query demo (headless rebuild of `apps/regions.cpp`).

The reference inserts N random points into a quadtree, takes two mouse
clicks as box corners (normalizing their order, `apps/regions.cpp:46-64`),
and highlights the points inside (`:71-79`). Here the batched dense range
op answers many boxes at once and the result is rendered to PNG; `--check`
cross-validates against numpy.

    python -m slam_tpu.apps.regions --n 2000 --boxes 3 --check
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from slam_tpu.apps.common import measure_time
from slam_tpu.ops import spatial
from slam_tpu.utils import render
from slam_tpu.utils.runtime import enable_compile_cache, require_gpu


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--boxes", type=int, default=3)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check", action="store_true")
    ap.add_argument(
        "--draw-tree", action="store_true",
        help="overlay the adaptive quadrant decomposition of the point set "
        "(what the reference draws as quadtree node boxes, "
        "`slam/quadtree.cpp:141-161`; here a host-side visualization — the "
        "production range query is dense)",
    )
    ap.add_argument("--out", default=None,
                    help="image to write (nothing is written when absent)")
    ap.add_argument("--cpu", action="store_true",
                    help="functional check on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    print("device:", require_gpu(args.cpu))
    enable_compile_cache()

    rng = np.random.default_rng(args.seed)
    px = rng.uniform(0, args.size, args.n).astype(np.float32)
    py = rng.uniform(0, args.size, args.n).astype(np.float32)
    valid = np.ones(args.n, bool)
    corners = rng.uniform(0, args.size, (args.boxes, 2, 2)).astype(np.float32)
    lo = corners.min(axis=1)  # corner-order normalization (`regions.cpp:46-64`)
    hi = corners.max(axis=1)
    boxes = np.concatenate([lo, hi], axis=1)  # x0, y0, x1, y1

    with measure_time(f"range query {args.boxes} boxes over {args.n} points"):
        mask = spatial.range_query_boxes(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid), jnp.asarray(boxes)
        )
    mask = np.asarray(mask)

    if args.check:
        for k in range(args.boxes):
            x0, y0, x1, y1 = boxes[k]
            want = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
            assert np.array_equal(mask[k], want)
        print("brute-force check OK")

    img = np.full((args.size, args.size, 3), 255, np.uint8)
    if args.draw_tree:
        gray = (210, 210, 210)

        def subdivide(x0, y0, x1, y1, sel, depth):
            # Point-region split: recurse while a quadrant holds >1 point
            # (the reference's quadtree splits on point insertion).
            i0, i1 = args.size - int(y1) - 1, args.size - int(y0) - 1
            render.draw_line(img, max(i0, 0), int(x0), max(i0, 0), int(x1) - 1, gray)
            render.draw_line(img, min(i1, args.size - 1), int(x0),
                             min(i1, args.size - 1), int(x1) - 1, gray)
            render.draw_line(img, max(i0, 0), int(x0), min(i1, args.size - 1),
                             int(x0), gray)
            render.draw_line(img, max(i0, 0), int(x1) - 1, min(i1, args.size - 1),
                             int(x1) - 1, gray)
            if sel.sum() <= 1 or depth >= 8:
                return
            mx, my = (x0 + x1) / 2, (y0 + y1) / 2
            for qx0, qy0, qx1, qy1 in (
                (x0, y0, mx, my), (mx, y0, x1, my),
                (x0, my, mx, y1), (mx, my, x1, y1),
            ):
                q = sel & (px >= qx0) & (px < qx1) & (py >= qy0) & (py < qy1)
                if q.any():
                    subdivide(qx0, qy0, qx1, qy1, q, depth + 1)

        subdivide(0.0, 0.0, float(args.size), float(args.size),
                  np.ones(args.n, bool), 0)
    inside_any = mask.any(axis=0)
    for x, y, hit in zip(px, py, inside_any):
        render.draw_disc(
            img, int(args.size - y - 1), int(x), 1,
            render.GREEN if hit else render.BLACK,
        )
    for k in range(args.boxes):
        x0, y0, x1, y1 = (int(v) for v in boxes[k])
        i0, i1 = args.size - y1 - 1, args.size - y0 - 1
        render.draw_line(img, i0, x0, i0, x1, render.RED)
        render.draw_line(img, i1, x0, i1, x1, render.RED)
        render.draw_line(img, i0, x0, i1, x0, render.RED)
        render.draw_line(img, i0, x1, i1, x1, render.RED)
        print(f"box {k}: {int(mask[k].sum())} points inside")
    if args.out:
        render.save_png(img, args.out)
        print(f"-> {args.out}")


if __name__ == "__main__":
    main()
