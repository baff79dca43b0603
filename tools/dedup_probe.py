#!/usr/bin/env python
"""Unique-key dedup probe for the gather-bound measurement paths.

"One row per particle is the panorama's algorithmic minimum" has a hole:
the minimum is one row per DISTINCT key, and converged clouds cluster on
few map cells. Both hot paths' per-particle values
are pure functions of a small discrete key:

  * panorama/fused (`ops/measurement.py:particle_log_weights_lut_fused`):
    the weight depends only on (sensor cell, heading bin s) — the scan is
    shared, so particles sharing (cell, s) share the weight bit-for-bit.
  * LF table lookup (`ops/measurement.py:particle_log_weights_lf_table`):
    the 2-element gather depends only on (sensor cell, t0); the per-particle
    lerp fraction stays per-particle.

This probe measures, in one process on the device, baseline vs a sort-dedup variant
(lax.sort_key_val -> segment ids -> gather K unique rows/pairs -> route back
through the sort permutation), on BOTH a converged cloud (the bench's real
post-warmup particle state) and a dispersed one (uniform over free space —
global localization), plus the component costs (sort, route-back) so a
negative is attributable. Correctness is asserted against the baseline
weights before any timing.

    python tools/dedup_probe.py --path pano --particles 100000
    python tools/dedup_probe.py --path table --particles 1000000
    python tools/dedup_probe.py --path pano --particles 4096 --cpu  # check
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def unique_compact(key, k_cap: int):
    """Sort-based exact dedup: returns (ukey[k_cap], seg[N], order[N], U).

    `ukey` holds the distinct keys compacted into the first U slots (overflow
    beyond k_cap is dropped — callers must check U <= k_cap for validity),
    `seg` maps each SORTED position to its unique slot, `order` is the sort
    permutation (original index of sorted position p)."""
    import jax
    import jax.numpy as jnp

    n = key.shape[0]
    sk, order = jax.lax.sort_key_val(key, jnp.arange(n, dtype=jnp.int32))
    newseg = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]]
    )
    seg = jnp.cumsum(newseg.astype(jnp.int32)) - 1  # [N], 0..U-1
    slot = jnp.where(newseg, seg, k_cap)  # non-heads scatter off the end
    ukey = jnp.zeros((k_cap,), sk.dtype).at[slot].set(sk, mode="drop")
    return ukey, seg, order, seg[-1] + 1


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--path", choices=["pano", "table"], default="pano")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=8192, help="unique-slot cap")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup-steps", type=int, default=5,
                    help="MCL steps to converge the realistic cloud")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from slam_tpu.models.simulate import synthetic_floor_plan
    from slam_tpu.core import grid as gridlib
    from slam_tpu.core.config import (
        LidarConfig,
        MCLConfig,
        RaycastConfig,
        beam_bin_stride,
    )
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.ops import lut as lutlib, measurement, rayfield

    blocked = jnp.asarray(synthetic_floor_plan())
    h, w = blocked.shape
    lidar = LidarConfig(start=0.0, stop=np.pi, max_dist=500.0, n_rays=90)
    backend = "lut" if args.path == "pano" else "sdf"
    rc = RaycastConfig(step=0.5, max_dist=500.0, backend=backend)
    cfg = MCLConfig(
        n_particles=args.particles,
        meas_stddev=5.0,
        scanner_offset=(0.0, 30.0, 0.0),
        measurement="beam" if args.path == "pano" else "likelihood_field_table",
        lut_beam_stride=beam_bin_stride(lidar, rc) if args.path == "pano" else 0,
    )
    pose = Pose.create(400.0, 400.0, np.pi)
    sensor = mcl_mod.MCL.sensor_position(pose, cfg.scanner_offset)
    scan = fake_lidar.scan(blocked, sensor, lidar, RaycastConfig(max_dist=500.0))
    field = rayfield.make_ray_field(blocked, rc)
    odom = Odometry.create(2.5, 0.02, 0.02)
    alphas = jnp.asarray((0.0005, 0.0005, 0.01, 0.01))

    # --- clouds -----------------------------------------------------------
    # Converged: the bench's REAL post-warmup state (motion noise + resample
    # equilibrium — the clustered-but-not-degenerate distribution the
    # headline number is measured on).
    @jax.jit
    def step(state, field, scan):
        st = mcl_mod.predict(state, odom, alphas)
        return mcl_mod.update(st, scan, field, cfg, rc)

    state = mcl_mod.init(jax.random.key(0), args.particles, pose)
    for _ in range(args.warmup_steps):
        state = step(state, field, scan)
    jax.block_until_ready(state)
    converged = state.particles.pose

    # Dispersed: uniform over free cells, uniform heading (global
    # localization's worst case for dedup — nearly every key distinct).
    free_i, free_j = np.nonzero(~np.asarray(blocked))
    ksel = jax.random.randint(
        jax.random.key(1), (args.particles,), 0, free_i.shape[0]
    )
    dispersed = Pose(
        x=jnp.asarray(free_j)[ksel] + 0.5,
        y=(h - jnp.asarray(free_i)[ksel] - 0.5),
        theta=jax.random.uniform(
            jax.random.key(2), (args.particles,), minval=-np.pi, maxval=np.pi
        ),
    )

    sp_off = cfg.scanner_offset
    results = {}

    if args.path == "pano":
        lut = field.lut
        n_bins = field.lut_bins or lut.shape[-1]
        stride = lut.shape[-1]
        g = int(cfg.lut_beam_stride)
        m = n_bins // g
        b_beams = scan.angles.shape[0]
        binw = 2.0 * jnp.pi / n_bins

        def baseline(poses, fld):
            return measurement.particle_log_weights_lut_fused(
                fld,
                poses,
                scan,
                rc=rc,
                beam_stride=g,
                scanner_offset=sp_off,
                stddev=cfg.meas_stddev,
                eps=cfg.meas_epsilon,
            )

        def keys_of(poses):
            sp = measurement.sensor_pose(poses, sp_off)
            s = jnp.round((sp.theta + scan.angles[0]) / binw).astype(
                jnp.int32
            ) % n_bins
            i, j = gridlib.world_to_cell((h, w), sp.x, sp.y)
            inb = gridlib.in_bounds((h, w), i, j)
            ic, jc = gridlib.clamp_cell((h, w), i, j)
            flat = ic * w + jc
            return ((flat * n_bins + s) << 1) | inb.astype(jnp.int32)

        def score_unique(ukey, lut):
            """The fused path's exact algebra on K unique (cell, s) keys
            (mirrors particle_log_weights_lut_fused steps 2-3)."""
            uinb = (ukey & 1).astype(bool)
            t = ukey >> 1
            us = t % n_bins
            uflat = t // n_bins
            q = us // g
            r = us % g
            pano = lut.reshape(h * w, stride)[uflat][:, :n_bins]  # [K, bins]
            cdt = (
                jnp.bfloat16
                if jnp.issubdtype(lut.dtype, jnp.integer)
                else lut.dtype
            )
            oh_r = jax.nn.one_hot(r, g, dtype=cdt)
            raw = jnp.einsum(
                "kpg,kg->kp", pano.reshape(-1, m, g).astype(cdt), oh_r
            )
            pred = lutlib.dequantize(raw, lut.dtype, rc.max_dist)
            pad = (0, m - b_beams)
            ztab = jnp.pad(jnp.asarray(scan.dists, jnp.float32), pad)
            vtab = jnp.pad(jnp.ones((b_beams,), jnp.float32), pad)
            mm = jnp.arange(m)
            roll_idx = (mm[None, :] - mm[:, None]) % m
            zv_rolls = jnp.concatenate(
                [ztab[roll_idx], vtab[roll_idx]], axis=1
            )
            oh_q = jax.nn.one_hot(q, m, dtype=jnp.float32)
            zv = jnp.dot(oh_q, zv_rolls, preferred_element_type=jnp.float32)
            z_at, valid = zv[:, :m], zv[:, m:]
            hit = (pred < rc.max_dist) & uinb[:, None]
            err = jnp.where(hit, pred - z_at, z_at - rc.max_dist)
            lw = measurement.log_pdf_normal_clamp_eps(
                cfg.meas_stddev, err, cfg.meas_epsilon
            ) * valid
            return jnp.sum(lw, axis=-1)

        def dedup(poses, lut):
            key = keys_of(poses)
            ukey, seg, order, n_u = unique_compact(key, args.k)
            lw_u = score_unique(ukey, lut)
            lw = (
                jnp.zeros((args.particles,), lw_u.dtype)
                .at[order]
                .set(lw_u[jnp.minimum(seg, args.k - 1)])
            )
            return lw, n_u

        def sort_only(poses):
            key = keys_of(poses)
            return jax.lax.sort_key_val(
                key, jnp.arange(args.particles, dtype=jnp.int32)
            )[0]

        # The big table goes in as an ARGUMENT (a closed-over LUT becomes a
        # jit constant and stalls compilation — CLAUDE.md).
        big = field

        def unique_score_only(poses, fld):
            key = keys_of(poses)
            ukey, _, _, _ = unique_compact(key, args.k)
            return score_unique(ukey, fld.lut)

        def routeback_only(poses, fld):
            # Route-back in isolation: N-gather from the K-array through the
            # segment map + inverse-permutation scatter (the part an
            # integrated design would need to amortize or eliminate).
            key = keys_of(poses)
            _, seg, order, _ = unique_compact(key, args.k)
            lw_u = jnp.arange(args.k, dtype=jnp.float32)
            return (
                jnp.zeros((args.particles,), jnp.float32)
                .at[order]
                .set(lw_u[jnp.minimum(seg, args.k - 1)])
            )

        def permuted_filter(poses, fld):
            # Round-4 follow-up: a particle SET is order-free, so a filter
            # may PERMUTE its whole state into key order instead of routing
            # weights back — the inverse-permutation scatter (one of the two
            # N-index ops that made dedup neutral) disappears. Honest cost:
            # sort keys + apply the permutation to the full particle state
            # (one packed 4-field gather, like the resampler's) + the
            # N-gather of unique scores through the segment map. Returns the
            # permuted state WITH the weights so nothing dead-code-eliminates.
            from slam_tpu.ops.resample import gather_pose_packed

            key = keys_of(poses)
            ukey, seg, order, _ = unique_compact(key, args.k)
            lw_u = score_unique(ukey, fld.lut)
            lw_sorted = lw_u[jnp.minimum(seg, args.k - 1)]
            poses_sorted = gather_pose_packed(poses, order)
            return lw_sorted, poses_sorted

        variants = {
            "baseline_fused": jax.jit(baseline),
            "dedup": jax.jit(lambda p, fld: dedup(p, fld.lut)[0]),
            "permuted_filter": jax.jit(permuted_filter),
            "sort_component": jax.jit(lambda p, fld: sort_only(p)),
            "sort_unique_score_component": jax.jit(unique_score_only),
            "sort_routeback_component": jax.jit(routeback_only),
        }
        count_unique = jax.jit(
            lambda p: unique_compact(keys_of(p), args.k)[3]
        )

    else:  # table
        edt = field.edt
        t_bins = 36
        sp_probe = measurement.sensor_pose(converged, sp_off)
        c = jnp.mean(jnp.cos(sp_probe.theta))
        s_ = jnp.mean(jnp.sin(sp_probe.theta))
        mu = jnp.arctan2(s_, c)
        rbar = jnp.clip(jnp.sqrt(c * c + s_ * s_), 1e-7, 1.0 - 1e-7)
        cstd = jnp.sqrt(-2.0 * jnp.log(rbar))
        halfwidth = jnp.clip(4.0 * cstd + 0.02, 0.02, jnp.pi)
        binw_t = 2.0 * halfwidth / (t_bins - 1)
        headings = (
            mu
            + (jnp.arange(t_bins, dtype=jnp.float32) - (t_bins - 1) / 2.0)
            * binw_t
        )
        table = measurement.lf_score_table(
            edt, scan, headings, rc=rc, stddev=cfg.meas_stddev,
            z_hit=cfg.lf_z_hit, z_rand=cfg.lf_z_rand,
        )
        tbl = jnp.moveaxis(table, 0, -1)  # [H, W, T] bins-last
        tbl = jax.device_put(tbl)
        jax.block_until_ready(tbl)
        mu_c, binw_c, halfwidth_c = (
            float(mu), float(binw_t), float(halfwidth),
        )
        n_valid = float(np.sum(np.asarray(scan.dists) < rc.max_dist))
        floor_lw = n_valid * float(
            math.log(max(cfg.lf_z_rand / rc.max_dist, 1e-30))
        )

        def lookup_parts(poses):
            sp = measurement.sensor_pose(poses, sp_off)
            i, j = gridlib.world_to_cell((h, w), sp.x, sp.y)
            ic, jc = gridlib.clamp_cell((h, w), i, j)
            d = jnp.arctan2(
                jnp.sin(sp.theta - mu_c), jnp.cos(sp.theta - mu_c)
            )
            u = jnp.clip(d / binw_c + (t_bins - 1) / 2.0, 0.0, t_bins - 1.0)
            t0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, t_bins - 2)
            frac = u - t0.astype(u.dtype)
            out = jnp.abs(d) > halfwidth_c + 0.5 * binw_c
            return ic, jc, t0, frac, out

        def baseline(poses, tbl):
            # The lookup phase of particle_log_weights_lf_table
            # (ops/measurement.py:399-423), table build excluded (shared).
            ic, jc, t0, frac, out = lookup_parts(poses)
            pair = jax.vmap(
                lambda a, b, k: jax.lax.dynamic_slice(
                    tbl, (a, b, k), (1, 1, 2)
                )[0, 0]
            )(ic, jc, t0)
            score = (1.0 - frac) * pair[:, 0] + frac * pair[:, 1]
            return jnp.where(out, floor_lw, score)

        def keys_of(poses):
            ic, jc, t0, _, _ = lookup_parts(poses)
            return (ic * w + jc) * t_bins + t0

        def dedup(poses, tbl):
            ic, jc, t0, frac, out = lookup_parts(poses)
            key = (ic * w + jc) * t_bins + t0
            ukey, seg, order, n_u = unique_compact(key, args.k)
            ut0 = ukey % t_bins
            uflat = ukey // t_bins
            ui = uflat // w
            uj = uflat % w
            pair_u = jax.vmap(
                lambda a, b, k: jax.lax.dynamic_slice(
                    tbl, (a, b, k), (1, 1, 2)
                )[0, 0]
            )(ui, uj, ut0)  # [K, 2]
            pair = (
                jnp.zeros((args.particles, 2), pair_u.dtype)
                .at[order]
                .set(pair_u[jnp.minimum(seg, args.k - 1)])
            )
            score = (1.0 - frac) * pair[:, 0] + frac * pair[:, 1]
            return jnp.where(out, floor_lw, score), n_u

        def sort_only(poses):
            key = keys_of(poses)
            return jax.lax.sort_key_val(
                key, jnp.arange(args.particles, dtype=jnp.int32)
            )[0]

        big = tbl
        variants = {
            "baseline_table_lookup": jax.jit(baseline),
            "dedup": jax.jit(lambda p, t: dedup(p, t)[0]),
            "sort_component": jax.jit(lambda p, t: sort_only(p)),
        }
        count_unique = jax.jit(
            lambda p: unique_compact(keys_of(p), args.k)[3]
        )

    # --- correctness, then timing ----------------------------------------
    for cloud_name, poses in (("converged", converged),
                              ("dispersed", dispersed)):
        n_u = int(count_unique(poses))
        overflow = n_u > args.k
        base_name = [k for k in variants if k.startswith("baseline")][0]
        wb = np.asarray(variants[base_name](poses, big))
        ok = None
        if not overflow:
            wd = np.asarray(variants["dedup"](poses, big))
            ok = bool(np.allclose(wb, wd, rtol=2e-3, atol=2e-3))
            assert ok, (
                f"dedup weights mismatch on {cloud_name}: "
                f"max abs diff {np.max(np.abs(wb - wd))}"
            )
            if "permuted_filter" in variants:
                lw_s, _ = variants["permuted_filter"](poses, big)
                key = jax.jit(keys_of)(poses)
                order = np.asarray(
                    jax.lax.sort_key_val(
                        key, jnp.arange(key.shape[0], dtype=jnp.int32)
                    )[1]
                )
                assert np.allclose(
                    np.asarray(lw_s), wb[order], rtol=2e-3, atol=2e-3
                ), f"permuted weights mismatch on {cloud_name}"
        timings = {}
        for name, fn in variants.items():
            if overflow and name == "dedup":
                continue
            out = fn(poses, big)
            jax.block_until_ready(out)
            reps = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    out = fn(poses, big)
                jax.block_until_ready(out)
                reps.append(
                    1e3 * (time.perf_counter() - t0) / args.iters
                )
            timings[name] = round(float(np.median(reps)), 3)
        results[cloud_name] = {
            "n_unique": n_u,
            "k_cap": args.k,
            "overflow": overflow,
            "weights_match": ok,
            "ms": timings,
        }
        print(f"# {cloud_name}: U={n_u} {timings}", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": f"dedup_probe_{args.path}_{args.particles}",
                "unit": "ms",
                "value": results["converged"]["ms"].get("dedup"),
                "results": results,
            }
        )
    )


if __name__ == "__main__":
    main()
