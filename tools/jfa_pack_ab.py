#!/usr/bin/env python
"""Capped-JFA inner-loop A/B: seed-index packing variants (round 5).

The capped JFA can be ALU-bound rather than bandwidth-bound, and the prime
suspect is the per-candidate seed unpack: the flat index costs an i32
DIVISION and a MODULO per cell per direction (8 per pass), and integer
division is many vector ops. Variants:

  divmod   the shipped form: idx = i * w + j; unpack by // and %
  shift    idx = (i << 16) | j; unpack by >> and & (single-cycle ops)
  carry2   seed coords carried as TWO i32 planes (no unpack at all;
           doubles the rolled traffic)

All variants produce IDENTICAL distances (packing never enters the
compare — candidates order and tie-breaks are unchanged).

    nohup setsid python -u tools/jfa_pack_ab.py > /tmp/jfa_ab.log 2>&1 &
    python tools/jfa_pack_ab.py --cpu --size 512
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


def _steps(max_dim, max_dist):
    from slam_tpu.ops.edt import _jfa_steps

    return _jfa_steps(max_dim, max_dist)


def make_variant(kind, h, w, max_dist):
    import jax
    import jax.numpy as jnp

    steps = _steps(max(h, w), max_dist)
    big = jnp.float32(h + w)
    inf = jnp.float32(1e9)

    def valid_mask(ii, jj, di, dj, hh, ww):
        v = jnp.ones(ii.shape, bool)
        if di > 0:
            v = v & (ii >= di)
        elif di < 0:
            v = v & (ii < hh + di)
        if dj > 0:
            v = v & (jj >= dj)
        elif dj < 0:
            v = v & (jj < ww + dj)
        return v

    if kind == "sep":
        # Separable capped EXACT transform: vertical clamped column
        # distance (cummax/cummin, no gathers) then a (2C+1)-candidate
        # shifted-min horizontal pass with precomputed k^2 constants —
        # ~2 ALU ops per candidate vs the JFA's ~13 (no seed unpack, no
        # converts), and exact rather than JFA+1-approximate.
        C = int(math.ceil(max_dist))

        def run(blocked):
            ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
            up = ii - jax.lax.cummax(
                jnp.where(blocked, ii, -(1 << 30)), axis=0
            )
            down = (
                jax.lax.cummin(
                    jnp.where(blocked, ii, 1 << 30), axis=0, reverse=True
                )
                - ii
            )
            g = jnp.minimum(jnp.minimum(up, down), C + 1).astype(
                jnp.float32
            )
            g2 = g * g
            pad = jnp.full((h, C), jnp.float32(1e9))
            lpad = jnp.concatenate([pad, g2, pad], axis=1)
            d2 = g2
            for k in range(-C, C + 1):
                if k == 0:
                    continue
                d2 = jnp.minimum(
                    d2, lpad[:, C + k : C + k + w] + jnp.float32(k * k)
                )
            return jnp.sqrt(jnp.minimum(d2, big * big))

        return jax.jit(run)

    if kind in ("divmod", "shift"):

        def run(blocked):
            ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
            jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
            iif = ii.astype(jnp.float32)
            jjf = jj.astype(jnp.float32)
            if kind == "divmod":
                idx = jnp.where(blocked, ii * w + jj, -1)

                def d2_of(x):
                    si = (x // w).astype(jnp.float32)
                    sj = (x % w).astype(jnp.float32)
                    return jnp.where(
                        x < 0, inf, (iif - si) ** 2 + (jjf - sj) ** 2
                    )

            else:
                idx = jnp.where(blocked, (ii << 16) | jj, -1)

                def d2_of(x):
                    si = (x >> 16).astype(jnp.float32)
                    sj = (x & 0xFFFF).astype(jnp.float32)
                    return jnp.where(
                        x < 0, inf, (iif - si) ** 2 + (jjf - sj) ** 2
                    )

            d2 = d2_of(idx)
            for s in steps:
                src = idx
                for di in (-s, 0, s):
                    for dj in (-s, 0, s):
                        if di == 0 and dj == 0:
                            continue
                        idx_r = jnp.roll(src, (di, dj), (0, 1))
                        v = valid_mask(ii, jj, di, dj, h, w)
                        cand = jnp.where(v, d2_of(idx_r), inf)
                        better = cand < d2
                        idx = jnp.where(better, idx_r, idx)
                        d2 = jnp.where(better, cand, d2)
            return jnp.sqrt(jnp.minimum(d2, big * big))

    else:  # carry2

        def run(blocked):
            ii = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
            jj = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
            iif = ii.astype(jnp.float32)
            jjf = jj.astype(jnp.float32)
            si = jnp.where(blocked, ii, -1)
            sj = jnp.where(blocked, jj, -1)

            def d2_of(a, b):
                return jnp.where(
                    a < 0,
                    inf,
                    (iif - a.astype(jnp.float32)) ** 2
                    + (jjf - b.astype(jnp.float32)) ** 2,
                )

            d2 = d2_of(si, sj)
            for s in steps:
                src_i, src_j = si, sj
                for di in (-s, 0, s):
                    for dj in (-s, 0, s):
                        if di == 0 and dj == 0:
                            continue
                        ri = jnp.roll(src_i, (di, dj), (0, 1))
                        rj = jnp.roll(src_j, (di, dj), (0, 1))
                        v = valid_mask(ii, jj, di, dj, h, w)
                        cand = jnp.where(v, d2_of(ri, rj), inf)
                        better = cand < d2
                        si = jnp.where(better, ri, si)
                        sj = jnp.where(better, rj, sj)
                        d2 = jnp.where(better, cand, d2)
            return jnp.sqrt(jnp.minimum(d2, big * big))

    return jax.jit(run)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", default="/root/reference/assets/maze.png")
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--max-dist", type=float, default=27.0)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from slam_tpu.utils.maps import load_binary_map

    if os.path.exists(args.map) and not args.cpu:
        blocked_np = np.asarray(load_binary_map(args.map) == 0)
    else:
        rng = np.random.default_rng(0)
        s = args.size
        blocked_np = rng.random((s, s)) < 0.03
    blocked = jnp.asarray(blocked_np)
    h, w = blocked.shape

    outs, res = {}, {}
    # Interleave variants round-robin so window drift cancels.
    fns = {k: make_variant(k, h, w, args.max_dist) for k in
           ("divmod", "shift", "carry2", "sep")}
    for k, f in fns.items():
        outs[k] = f(blocked)
        jax.block_until_ready(outs[k])
        res[k] = 0.0
    reps = 5  # pipelined chain per sample: one fence RTT per reps calls
    for _ in range(args.iters):
        for k, f in fns.items():
            t0 = time.perf_counter()
            for _r in range(reps):
                o = f(blocked)
            jax.block_until_ready(o)
            res[k] += time.perf_counter() - t0
    for k in res:
        res[k] = res[k] / (args.iters * reps) * 1e3
        print(f"# {k:8s} {res[k]:8.3f} ms", file=sys.stderr, flush=True)
    # JFA packings must agree bitwise; the separable variant is EXACT, so
    # within the cap it lower-bounds the (overestimating) JFA and matches
    # it closely.
    a = np.asarray(outs["divmod"])
    for k in ("shift", "carry2"):
        np.testing.assert_array_equal(a, np.asarray(outs[k]))
    sep = np.asarray(outs["sep"])
    near = sep <= args.max_dist
    assert np.all(sep[near] <= a[near] + 1e-4)
    assert np.max(a[near] - sep[near]) < 1.0
    print(json.dumps({
        "metric": "jfa_pack_ab_ms",
        "map": f"{h}x{w}", "max_dist": args.max_dist,
        "results": {k: round(v, 3) for k, v in res.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
