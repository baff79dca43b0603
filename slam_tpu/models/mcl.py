"""Monte-Carlo localization: the particle filter core.

Accelerator-native rebuild of `slam/mcl.{h,cpp}`. Phase mapping:

  MCL::predict (`slam/mcl.cpp:41-47`, per-particle loop)
      -> one vectorized odometry-model sample over the SoA particle state.
  MCL::update_inner (`slam/mcl.cpp:49-77`, pthread fan-out over ranges)
      -> one batched [N, B] raycast + fused log-weight reduction.
  probabilistic_fitness_selection (`slam/mcl.cpp:157-230`, serial cumsum +
      binary searches + core-pinned map clones)
      -> prefix-sum + searchsorted gather (slam_tpu.ops.resample).

Everything is a pure function of `MCLState`; the `MCL` wrapper class jits the
step functions with the config held static. Weights live in log space —
the reference's `exp(sum log w)` (`slam/mcl.cpp:73-75`) underflows float32
at realistic beam counts, so normalization happens via softmax instead.

Augmented MCL (random-particle injection driven by fast/slow likelihood
averages) comes from the reference's notebook prototype (cell 9), which the
C++ dropped; enable with `MCLConfig.adaptive`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from slam_tpu.core import struct

from slam_tpu.core import stats
from slam_tpu.core.config import MCLConfig, RaycastConfig
from slam_tpu.core.types import Odometry, Particles, Pose, Scan
from slam_tpu.ops import measurement, motion, rayfield, resample


@struct.dataclass
class MCLState:
    particles: Particles
    key: jax.Array
    # Best particle (by pre-resample weight) after the latest update.
    best_pose: Pose
    # Temperature-sharpened weighted circular mean (softmax(tau * log_w),
    # PRE-resample): interpolates between the weighted mean (tau=1) and the
    # best particle (tau -> inf). The mean suffers ridge-shrinkage bias when
    # the posterior curves (it averages OFF the ridge); the argmax suffers
    # selection noise at small N (and is ARBITRARY under uniform weights —
    # the empty-map first SLAM update). The sharpened mean has neither
    # failure: under uniform weights it is the prior mean, converged it is
    # a local average over the mode. `MCLConfig.mode_tau` sets tau.
    mode_pose: Pose
    # Augmented-MCL likelihood EMAs, in log space.
    log_w_slow: jax.Array
    log_w_fast: jax.Array
    # Predict-frame counter (one per motion prediction).
    step: jax.Array
    # Update counter (one per measurement update): the every-k throttles
    # (`MCLConfig.resample_every`, `SLAMConfig.map_every`) count UPDATES,
    # not frames — under `update_every > 1` a frame counter would silently
    # change (or nullify) their period because every update lands on a
    # multiple of update_every.
    updates: jax.Array


def starting_pose(h: int, w: int) -> Pose:
    """Canvas-center start (`slam/mcl.cpp:22-25`: {w/2, h/2, pi/2})."""
    return Pose.create(w / 2.0, h / 2.0, jnp.pi / 2.0)


def init(key, n_particles: int, pose: Pose) -> MCLState:
    """All particles at `pose` with uniform weights (`slam/mcl.cpp:27-39`)."""
    return MCLState(
        particles=Particles.uniform_at(pose, n_particles),
        key=key,
        best_pose=pose,
        mode_pose=pose,
        # NaN = "no update seen yet": the adaptive-injection EMAs warm-start
        # from the first observed average likelihood (see `update`).
        log_w_slow=jnp.float32(jnp.nan),
        log_w_fast=jnp.float32(jnp.nan),
        step=jnp.int32(0),
        updates=jnp.int32(0),
    )


def init_uniform(key, n_particles: int, blocked: jax.Array) -> MCLState:
    """Global-localization init: particles uniform over free space (the
    notebook's grid+random initialization, cell 9)."""
    state = init(key, n_particles, starting_pose(*blocked.shape))
    k_inj, k_next = jax.random.split(key)
    particles = resample.inject_random_particles(
        k_inj, state.particles, blocked, 1.0
    )
    return state.replace(particles=particles, key=k_next)


def predict(state: MCLState, odom: Odometry, alphas) -> MCLState:
    """Diffuse every particle through the odometry motion model."""
    key, sub = jax.random.split(state.key)
    pose = motion.sample_motion_model_odometry(
        sub, odom, state.particles.pose, alphas
    )
    return state.replace(
        particles=state.particles.replace(pose=pose),
        key=key,
        step=state.step + 1,
    )


def update(
    state: MCLState,
    scan: Scan,
    field,
    cfg: MCLConfig,
    rc: RaycastConfig,
    ray_sharding=None,
    resample_fn=None,
    measurement_fn=None,
) -> MCLState:
    """Weight against one scan, then (conditionally) resample.

    `field` is the map the beams raycast against — a prebuilt `RayField`
    (static map, localization mode) or a raw bool[H, W] mask (wrapped on the
    fly; SLAM mode passes thresholded log-odds). `ray_sharding` optionally
    pins the [N, B] ray batch to a device mesh (see slam_tpu.parallel).
    `resample_fn(key, particles) -> particles` overrides the selection step
    (the sharded engines pass the reduce-scatter resampler from
    slam_tpu.parallel.resample). `measurement_fn(poses, scan) -> log_w[N]`
    replaces the measurement model entirely (the map-block-sharded engine
    computes weights against a distributed grid).
    """
    if measurement_fn is not None:
        if cfg.adaptive is not None:
            raise ValueError(
                "adaptive injection needs the map; it is not supported with "
                "a custom measurement_fn"
            )
        field = None
        lw = measurement_fn(state.particles.pose, scan)
    elif cfg.measurement in (
        "likelihood_field", "likelihood_field_table", "likelihood_field_auto"
    ):
        if not isinstance(field, rayfield.RayField):
            # Per-step rebuild (SLAM mode): the LF pdf only resolves ~5
            # sigma of distance (beyond that the z_rand floor dominates),
            # so build the range-capped separable transform — work scales
            # with the MODEL's cap, not the map (big-map SLAM), and it is
            # exact within the cap (ops.edt.edt_capped).
            from slam_tpu.ops import edt as edtlib

            blocked_mask = jnp.asarray(field, bool)
            field = rayfield.RayField(
                blocked=blocked_mask,
                edt=edtlib.edt_capped(
                    blocked_mask, 5.0 * cfg.meas_stddev + 2.0
                ),
            )
        if field.edt is None:
            raise ValueError(
                f"measurement={cfg.measurement!r} needs a distance transform: "
                "use RaycastConfig(backend='sdf') or build the RayField with "
                f"an EDT (got backend={rc.backend!r})"
            )
        def _table(f):
            return measurement.particle_log_weights_lf_table(
                f,
                state.particles.pose,
                scan,
                rc=rc,
                scanner_offset=cfg.scanner_offset,
                stddev=cfg.meas_stddev,
                z_hit=cfg.lf_z_hit,
                z_rand=cfg.lf_z_rand,
                table_bins=cfg.lf_table_bins,
                spread_mult=cfg.lf_table_spread,
                min_halfwidth=cfg.lf_table_min_halfwidth,
                table_dtype=cfg.lf_table_dtype,
                box_size=cfg.lf_table_box,
                ray_sharding=ray_sharding,
            )

        def _direct(f):
            return measurement.particle_log_weights_likelihood_field(
                f,
                state.particles.pose,
                scan,
                rc=rc,
                scanner_offset=cfg.scanner_offset,
                stddev=cfg.meas_stddev,
                z_hit=cfg.lf_z_hit,
                z_rand=cfg.lf_z_rand,
                ray_sharding=ray_sharding,
            )

        if cfg.measurement == "likelihood_field_table":
            lw = _table(field)
        elif cfg.measurement == "likelihood_field_auto":
            # Auto tier: the boxed table is the tracking fast path but
            # coarsens (heading bins widen, out-of-box flooring) on a
            # DISPERSED cloud — global-localization init, kidnap recovery
            # under adaptive injection. Pick per step from the cloud's own
            # statistics (reductions — psum-clean when sharded): table when
            # both the 4-sigma heading window and the k-sigma spatial
            # extent are tight, direct likelihood field otherwise. Both
            # branches compile once; each step executes only the taken one.
            converged = measurement.lf_auto_converged(
                state.particles.pose, cfg, field.edt.shape,
                scanner_offset=cfg.scanner_offset,
            )

            # Gate only the PARTICLE-COUNT-INDEPENDENT halves in the cond:
            # lowering the N-particle pair gather inside a cond branch
            # de-optimizes it (measured 30 -> 231 ms at 1M). The lookup
            # runs unconditionally in the main computation (reads a zeros
            # placeholder when dispersed, ~the gather floor in cost); the
            # direct model runs in the other cond, and where() selects.
            def _prep(f):
                return measurement.lf_table_prepare(
                    f,
                    state.particles.pose,
                    scan,
                    rc=rc,
                    scanner_offset=cfg.scanner_offset,
                    stddev=cfg.meas_stddev,
                    z_hit=cfg.lf_z_hit,
                    z_rand=cfg.lf_z_rand,
                    table_bins=cfg.lf_table_bins,
                    spread_mult=cfg.lf_table_spread,
                    min_halfwidth=cfg.lf_table_min_halfwidth,
                    table_dtype=cfg.lf_table_dtype,
                    box_size=cfg.lf_table_box,
                    ray_sharding=ray_sharding,
                )

            prep_shape = jax.eval_shape(_prep, field)
            prep = jax.lax.cond(
                converged,
                _prep,
                lambda f: jax.tree.map(
                    lambda sd: jnp.zeros(sd.shape, sd.dtype), prep_shape
                ),
                field,
            )
            lw_t = measurement.lf_table_lookup(
                prep,
                state.particles.pose,
                scan,
                rc=rc,
                scanner_offset=cfg.scanner_offset,
                z_rand=cfg.lf_z_rand,
                grid_shape=field.edt.shape,
            )
            lw_d = jax.lax.cond(
                converged, lambda f: jnp.zeros_like(lw_t), _direct, field
            )
            lw = jnp.where(converged, lw_t, lw_d)
        else:
            lw = _direct(field)
    else:
        field = rayfield.as_ray_field(field, rc)
        lw = measurement.particle_log_weights(
            field,
            state.particles.pose,
            scan,
            rc=rc,
            scanner_offset=cfg.scanner_offset,
            stddev=cfg.meas_stddev,
            eps=cfg.meas_epsilon,
            ray_sharding=ray_sharding,
            lut_beam_stride=cfg.lut_beam_stride,
        )
    log_weight = state.particles.log_weight + lw
    # Best particle via a one-hot masked sum, NOT a dynamic index: a[argmax]
    # on a sharded particle axis makes GSPMD all-gather the whole array to
    # slice one element; the masked sum lowers to a psum.
    best_sel = jnp.arange(log_weight.shape[0]) == jnp.argmax(log_weight)
    best_pose = jax.tree.map(
        lambda a: jnp.sum(jnp.where(best_sel, a, 0.0)), state.particles.pose
    )
    # Sharpened weighted circular mean (see MCLState.mode_pose). Reductions
    # only — psum-friendly on a sharded particle axis like best_pose above.
    wm = jax.nn.softmax(log_weight * cfg.mode_tau)
    pp = state.particles.pose
    mode_pose = Pose(
        x=jnp.sum(wm * pp.x),
        y=jnp.sum(wm * pp.y),
        theta=jnp.arctan2(
            jnp.sum(wm * jnp.sin(pp.theta)), jnp.sum(wm * jnp.cos(pp.theta))
        ),
    )
    # Under an UNINFORMATIVE measurement (all beams score identically — the
    # SLAM-mode first update against an empty grid, where every endpoint
    # reads the z_rand floor) the argmax is an arbitrary particle; mapping
    # from it bakes one random motion-noise draw (~0.05-0.1 rad of heading)
    # into the shared map's gauge permanently (measured: the 120-step
    # deterministic arc's worst seeds). Fall back to the
    # sharpened mean, which under uniform weights is the prior mean
    # (error ~noise/sqrt(N)). "Uninformative" = the top score is a majority
    # tie, NOT ptp(lw) == 0: with lf_table_box (or any outlier-flooring
    # path) a few out-of-window particles score the z_rand floor even when
    # the in-window majority ties, and a ptp test would then crown an
    # arbitrary tied particle — the exact gauge rotation this guards
    # against. The tie tolerance is RELATIVE to |max|: these are f32 log
    # likelihoods with magnitudes in the hundreds (ULP at 400 ~ 3e-5), so
    # an absolute 1e-6 catches only bit-exact ties and any summation-order
    # jitter (bf16 table store, sharded reduction order) silently defeats
    # the guard. Reductions only (psum-friendly on a sharded particle axis).
    max_lw = jnp.max(lw)
    tie_tol = jnp.maximum(jnp.float32(1e-6), 1e-6 * jnp.abs(max_lw))
    top_tie_frac = jnp.mean((max_lw - lw) < tie_tol)
    informative = top_tie_frac < 0.5
    best_pose = jax.tree.map(
        lambda b, m: jnp.where(informative, b, m), best_pose, mode_pose
    )
    particles = state.particles.replace(log_weight=log_weight)

    key, k_rs, k_inj = jax.random.split(state.key, 3)

    # Conditional resample on effective sample size (threshold 1.0 == always,
    # the reference's behavior `slam/mcl.cpp:232-239`) AND the every-k
    # throttle (cfg.resample_every; weights accumulate across skipped steps).
    ess = resample.effective_sample_size(log_weight)
    n = particles.n

    def do_resample(p):
        if resample_fn is not None:
            return resample_fn(k_rs, p)
        return resample.resample(k_rs, p, cfg.resample)

    do_it = ess <= cfg.ess_threshold * n
    if cfg.resample_every > 1:
        do_it = do_it & (state.updates % cfg.resample_every == 0)
    particles = jax.lax.cond(do_it, do_resample, lambda p: p, particles)

    log_w_slow, log_w_fast = state.log_w_slow, state.log_w_fast
    if cfg.adaptive is not None:
        # EMAs of the mean unnormalized likelihood, tracked in log space.
        # WARM START on the first update: the EMAs initialize to log(1) = 0
        # while a realistic multi-beam log likelihood is hugely negative
        # (~-400 at 90 beams), so cold EMAs would leave w_fast << w_slow —
        # injection ratio saturated at ~1 — for dozens of steps (measured:
        # global localization that converges in 2 steps without injection
        # never converges with cold-started injection). Seeding both EMAs
        # with the first observed average makes the ratio start at 0 and
        # respond only to CHANGES in likelihood, the notebook's intent.
        log_w_avg = jax.nn.logsumexp(lw) - jnp.log(n)
        first = jnp.isnan(log_w_slow)
        a_s, a_f = cfg.adaptive.alpha_slow, cfg.adaptive.alpha_fast
        log_w_slow = jnp.where(
            first,
            log_w_avg,
            jnp.logaddexp(
                jnp.log1p(-a_s) + log_w_slow, jnp.log(a_s) + log_w_avg
            ),
        )
        log_w_fast = jnp.where(
            first,
            log_w_avg,
            jnp.logaddexp(
                jnp.log1p(-a_f) + log_w_fast, jnp.log(a_f) + log_w_avg
            ),
        )
        # Capped (AdaptiveConfig.max_ratio): the raw ratio spikes on
        # ordinary 1-2 nat likelihood fluctuations and the injected junk
        # feeds the next average — an uncapped self-sustaining flood
        # (measured: spread 35 px during perfect tracking). See the config
        # docstring for the measured kidnap-recovery setting.
        ratio = jnp.clip(
            1.0 - jnp.exp(log_w_fast - log_w_slow),
            0.0,
            cfg.adaptive.max_ratio,
        )
        particles = resample.inject_random_particles(
            k_inj, particles, field.blocked, ratio
        )

    return state.replace(
        particles=particles,
        key=key,
        best_pose=best_pose,
        mode_pose=mode_pose,
        log_w_slow=log_w_slow,
        log_w_fast=log_w_fast,
        updates=state.updates + 1,
    )


def mean_pose(state: MCLState) -> Pose:
    """Circular-mean pose over particles (`slam/util.cpp:66-85`; unweighted,
    as the reference renders it post-resample)."""
    x, y, th = stats.average_pose(
        state.particles.pose.x, state.particles.pose.y, state.particles.pose.theta
    )
    return Pose(x=x, y=y, theta=th)


class MCL:
    """Convenience wrapper mirroring the reference's class API
    (`slam/mcl.h:12-46`) with jitted internals and explicit state."""

    def __init__(
        self,
        cfg: MCLConfig,
        rc: RaycastConfig = RaycastConfig(),
        seed: int = 0,
    ):
        self.cfg = cfg
        self.rc = rc
        self._seed = seed
        self._predict = jax.jit(predict)
        self._update = jax.jit(
            lambda s, scan, blocked: update(s, scan, blocked, cfg, rc)
        )

    def init(self, h: int, w: int) -> MCLState:
        return init(
            jax.random.key(self._seed), self.cfg.n_particles,
            starting_pose(h, w),
        )

    def predict(self, state, odom: Odometry, alphas) -> MCLState:
        return self._predict(state, odom, jnp.asarray(alphas))

    def update(self, state, scan: Scan, blocked) -> MCLState:
        return self._update(state, scan, blocked)

    @staticmethod
    def sensor_position(pose: Pose, scanner_offset) -> Pose:
        return measurement.sensor_pose(pose, scanner_offset)
