"""Distributed systematic resampling without a full-state all-gather.

The single-device resampler (`slam_tpu.ops.resample.systematic_indices`)
computes a global cumsum and gathers `state[idx]`; under GSPMD on a sharded
particle axis that gather materializes every shard's particle state on every
device (an [N]-sized all-gather — the analogue of the reference's
core-pinned cross-thread map deep-copies, `slam/mcl.cpp:205-227`). This
module is the SURVEY section 7 item 4 design: an explicit `shard_map`
resampler whose only [N]-sized collective is a **reduce-scatter**
(`psum_scatter`), which moves (D-1)/D of the data an all-gather would and
leaves every array shard-local.

How it stays exact:

  * Systematic resampling assigns particle i (global cumsum c_i) the output
    slot range [ceil(N*c_{i-1} - u0), ceil(N*c_i - u0)); the ranges
    partition [0, N), so every output slot has EXACTLY ONE writer — either a
    particle whose range starts at it, or (for a shard's first slot) the one
    particle whose range covers the shard boundary.
  * One-writer-per-slot means max-combine across source shards equals
    sum-combine with an empty sentinel of 0 — which is what lets the
    cross-shard seed routing be a single `psum_scatter` over [D, L] buffers
    instead of an all-gather + scatter.
  * Particle STATE (x, y, theta) rides in the same reduce-scatter, so slots
    that begin a range receive their source state directly; the remaining
    slots (copies) are filled by a local forward-fill `associative_scan`.
    No gather of remote particle state ever happens.

The global cumsum itself needs only an all-gather of D per-shard partial
sums (a [D]-sized array, bytes not proportional to N).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_tpu.core.types import Particles, Pose


def _resample_local(lw, x, y, th, u0, *, axis: str, n_global: int):
    """shard_map body: [L]-local arrays in, resampled [L]-local pose out."""
    d = jax.lax.axis_size(axis)
    s = jax.lax.axis_index(axis)
    l = lw.shape[0]

    # Global softmax weights + global cumsum, shard-locally: exp-normalize
    # against the global max, then offset the local cumsum by the exclusive
    # prefix of per-shard sums ([D]-sized all-gather only).
    m = jax.lax.pmax(jnp.max(lw), axis)
    e = jnp.exp(lw - m)
    local_sum = jnp.sum(e)
    sums = jax.lax.all_gather(local_sum, axis)  # [D]
    total = jnp.sum(sums)
    prefix = jnp.sum(jnp.where(jnp.arange(d) < s, sums, 0.0))
    cs = jnp.cumsum(e)
    c = (prefix + cs) / total
    c_prev = (prefix + cs - e) / total

    # Output slot ranges [start_i, end_i): they partition [0, N).
    ends = jnp.ceil(n_global * c - u0).astype(jnp.int32)
    starts = jnp.ceil(n_global * c_prev - u0).astype(jnp.int32)
    starts = jnp.clip(starts, 0, n_global)
    ends = jnp.clip(ends, 0, n_global)
    occupied = ends > starts

    # Seed routing buffers: destination shard t owns slots [t*L, (t+1)*L).
    # Writer 1: range starts — scatter at the global start slot.
    # Writer 2: per-destination carry-in — the unique particle whose range
    # strictly covers slot t*L lands at that destination's slot 0.
    # One writer per slot => sum-combine with sentinel 0 is exact.
    flat_pos = jnp.where(occupied, starts, n_global)  # drop the empty
    seed = jnp.zeros((d * l,), jnp.int32).at[flat_pos].add(
        1 + s * l + jnp.arange(l, dtype=jnp.int32), mode="drop"
    )
    sx = jnp.zeros((d * l,), x.dtype).at[flat_pos].add(x, mode="drop")
    sy = jnp.zeros((d * l,), y.dtype).at[flat_pos].add(y, mode="drop")
    sth = jnp.zeros((d * l,), th.dtype).at[flat_pos].add(th, mode="drop")

    bounds = jnp.arange(d, dtype=jnp.int32) * l  # [D] first slot per dest
    covers = (starts[:, None] < bounds[None, :]) & (
        ends[:, None] > bounds[None, :]
    )  # [L, D]; at most one true per column globally
    carry_pos = jnp.where(jnp.any(covers, axis=0), bounds, n_global)
    carry_src = jnp.argmax(covers, axis=0)  # local particle index
    seed = seed.at[carry_pos].add(
        jnp.where(
            jnp.any(covers, axis=0),
            1 + s * l + carry_src.astype(jnp.int32),
            0,
        ),
        mode="drop",
    )
    sx = sx.at[carry_pos].add(
        jnp.where(jnp.any(covers, axis=0), x[carry_src], 0.0), mode="drop"
    )
    sy = sy.at[carry_pos].add(
        jnp.where(jnp.any(covers, axis=0), y[carry_src], 0.0), mode="drop"
    )
    sth = sth.at[carry_pos].add(
        jnp.where(jnp.any(covers, axis=0), th[carry_src], 0.0), mode="drop"
    )

    # The one [N]-scale collective: reduce-scatter, not all-gather.
    def rscat(a):
        return jax.lax.psum_scatter(
            a.reshape(d, l), axis, scatter_dimension=0, tiled=False
        )

    seed, sx, sy, sth = rscat(seed), rscat(sx), rscat(sy), rscat(sth)

    # Local forward-fill: every slot takes the nearest seeded slot at or
    # before it (the shard's slot 0 is always seeded, by the carry-in).
    valid = seed > 0

    def combine(a, b):
        av, ax_, ay_, at_ = a
        bv, bx, by, bt = b
        keep_b = bv
        return (
            av | bv,
            jnp.where(keep_b, bx, ax_),
            jnp.where(keep_b, by, ay_),
            jnp.where(keep_b, bt, at_),
        )

    _, fx, fy, fth = jax.lax.associative_scan(
        combine, (valid, sx, sy, sth)
    )
    return fx, fy, fth


@functools.partial(jax.jit, static_argnames=("mesh", "axis"))
def _resample_sharded_jit(mesh, key, lw, x, y, th, *, axis):
    # Jitted as a whole: an EAGER shard_map would dispatch the body
    # primitive-by-primitive (associative_scan's recursive pjits each
    # compile separately on the mesh — minutes on an 8-device host mesh).
    n = lw.shape[0]
    u0 = jax.random.uniform(key, ())
    spec = P(axis)
    body = functools.partial(_resample_local, axis=axis, n_global=n)
    return jax.shard_map(
        lambda lw, x, y, th, u: body(lw, x, y, th, u),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec, P()),
        out_specs=spec,
        check_vma=False,
    )(lw, x, y, th, u0)


def systematic_resample_sharded(
    mesh: Mesh,
    key,
    particles: Particles,
    *,
    axis: str = "p",
) -> Particles:
    """Drop-in sharded replacement for `ops.resample.resample(...,
    'systematic')`: identical selection given the same key (same u0, same
    cumsum up to f32 association), state exchanged via reduce-scatter."""
    n = particles.n
    # Normalize weak types so jnp.zeros / jnp.full literals share one trace.
    lw = jnp.asarray(particles.log_weight)
    lw = jax.lax.convert_element_type(lw, lw.dtype)
    fx, fy, fth = _resample_sharded_jit(
        mesh,
        key,
        lw,
        particles.pose.x,
        particles.pose.y,
        particles.pose.theta,
        axis=axis,
    )
    return Particles(
        pose=Pose(x=fx, y=fy, theta=fth),
        log_weight=jnp.full((n,), -jnp.log(n), particles.log_weight.dtype),
    )
