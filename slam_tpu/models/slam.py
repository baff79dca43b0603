"""Full grid SLAM: MCL localization + shared-map log-odds occupancy mapping.

The reference's RBPF-style design gives every particle its own uint8 map and
fuses mapping into weighting (`slam/mcl.cpp:49-77` -> `slam/raycast.cpp:
143-223`), which costs N x H x W bytes and N map deep-copies per resample
(`slam/mcl.cpp:205-227`). The shared-map architecture (SURVEY.md section 7) keeps
ONE shared log-odds grid: all particles weight against the frozen grid, then
the grid updates once from the estimated pose. A small-N exact per-particle
mode for A/B fidelity lives in `slam_tpu.ops.mapping.
fidelity_measurement_and_mapping`.

One SLAM step = predict(odometry) -> weight(scan) -> estimate -> map update
-> resample; the whole step is one jitted program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from slam_tpu.core import struct

from slam_tpu.core import grid as gridlib
from slam_tpu.core.config import SLAMConfig
from slam_tpu.core.types import Odometry, Pose, Scan
from slam_tpu.models import mcl as mcl_mod
from slam_tpu.ops import mapping


@struct.dataclass
class SLAMState:
    mcl: mcl_mod.MCLState
    grid: jax.Array  # f32[H, W] log-odds of occupancy
    # The engine's output pose estimate after the latest update: the
    # correlative scan-matched pose when `SLAMConfig.scanmatch` is set
    # (slam_tpu.ops.scanmatch), otherwise the best particle.
    est_pose: Pose
    # DERIVED cache (round 5, `SLAMConfig.edt_box`): the capped JFA EDT of
    # `blocked_from_logodds(grid)`, refreshed incrementally per step
    # (`ops.edt.edt_refresh`, bitwise-exact vs a full rebuild). None
    # when edt_box is unset (the prior rebuild-per-step behavior). If the
    # grid is modified outside `step` (e.g. a migrated old-format
    # checkpoint), re-derive with `rebuild_edt(state, cfg)`.
    edt: jax.Array | None = None


def _lf_cap(cfg: SLAMConfig) -> float:
    """JFA propagation cap: the LF pdf only resolves ~5 sigma of distance
    (beyond that the z_rand floor dominates)."""
    return 5.0 * cfg.mcl.meas_stddev + 2.0


def _needs_field(cfg: SLAMConfig) -> bool:
    return cfg.mcl.measurement in (
        "likelihood_field",
        "likelihood_field_table",
        "likelihood_field_auto",
    ) or cfg.scanmatch is not None


def rebuild_edt(state: SLAMState, cfg: SLAMConfig) -> SLAMState:
    """(Re)derive the cached EDT from the grid (init, or after any
    out-of-band grid edit such as checkpoint migration)."""
    if cfg.edt_box is None or not _needs_field(cfg):
        return state.replace(edt=None)
    from slam_tpu.ops import edt as edtlib

    blocked = gridlib.blocked_from_logodds(state.grid)
    return state.replace(edt=edtlib.edt_capped(blocked, _lf_cap(cfg)))


def init(key, cfg: SLAMConfig, pose: Pose | None = None) -> SLAMState:
    h, w = cfg.map.shape
    if pose is None:
        pose = mcl_mod.starting_pose(h, w)
    state = SLAMState(
        mcl=mcl_mod.init(key, cfg.mcl.n_particles, pose),
        grid=gridlib.uniform_logodds((h, w)),
        est_pose=pose,
    )
    return rebuild_edt(state, cfg)


def resolve_map_pose(cfg: SLAMConfig) -> str:
    """Resolve ``SLAMConfig.map_pose`` to a concrete estimator.

    ``"auto"`` encodes the measured regime rule (the shared-map estimator
    study and the 1M aligned-ATE table), resolved at
    trace time from the static config — the analog of
    ``measurement="likelihood_field_auto"`` for the mapping estimator:

      * small N -> ``"best"``: the argmax-with-uninformative-fallback is
        the most robust on long low-N arcs (200-particle 120-step arc:
        mean-of-seeds 9.0 px vs mode 10.2, mean 11.7) and the reference's
        own estimator (`slam/mcl.cpp:236-238`).
      * large N, resampling every update -> ``"mean"``: deterministic map
        gauge across filter seeds and the best SE(2)-aligned ATE
        (1M k=1: 0.75-0.80 px aligned).
      * large N, ``resample_every > 1`` -> ``"mode"``: the unweighted mean
        ignores weights accumulated across skipped resamples and degrades
        (4.3-4.8 px aligned); the tau-sharpened weighted mode stays at
        1.2-1.5 px (the production config).

    The small/large boundary is set at 10k particles: measured anchors are
    200 (best wins) and 100k/1M (mean/mode win); between them the argmax's
    selection noise ~1/N is already negligible, so the gauge-determinism
    argument dominates. Unmeasured in (200, 100k) — documented, not tuned.
    """
    if cfg.map_pose != "auto":
        return cfg.map_pose
    if cfg.mcl.n_particles < 10_000:
        return "best"
    if cfg.mcl.resample_every > 1:
        return "mode"
    return "mean"


def step(
    state: SLAMState,
    odom: Odometry,
    scan: Scan,
    cfg: SLAMConfig,
    ray_sharding=None,
    resample_fn=None,
) -> SLAMState:
    """One full SLAM step (predict + update + [refine] + map + resample)."""
    st = mcl_mod.predict(state.mcl, odom, cfg.motion.alphas)
    blocked = gridlib.blocked_from_logodds(state.grid)

    # The likelihood-field measurement paths and the scan-matching
    # refinement share one capped JFA EDT, built here so it isn't computed
    # twice (mcl.update builds its own only when handed a raw mask). With
    # `cfg.edt_box` the field comes from the state's incremental cache
    # instead of a per-step full-map rebuild.
    lf_meas = cfg.mcl.measurement in (
        "likelihood_field",
        "likelihood_field_table",
        "likelihood_field_auto",
    )
    lf_field = None
    if lf_meas or cfg.scanmatch is not None:
        from slam_tpu.ops import edt as edtlib, rayfield

        if cfg.edt_box is not None:
            if state.edt is None:
                raise ValueError(
                    "SLAMConfig.edt_box is set but the state carries no "
                    "EDT cache — initialize with slam.init(cfg) or call "
                    "slam.rebuild_edt(state, cfg) after out-of-band grid "
                    "edits (e.g. a migrated checkpoint)"
                )
            edt = state.edt
        else:
            edt = edtlib.edt_capped(blocked, _lf_cap(cfg))
        lf_field = rayfield.RayField(blocked=blocked, edt=edt)

    st = mcl_mod.update(
        st,
        scan,
        lf_field if lf_meas else blocked,
        cfg.mcl,
        cfg.raycast,
        ray_sharding=ray_sharding,
        resample_fn=resample_fn,
    )

    # `SLAMConfig.map_pose` selects the estimator that drives the map
    # update; the shipped default is "best" — the reference keeps the best
    # PARTICLE's map (`slam/mcl.cpp:236-238`, `apps/grid_slam.cpp:112`) and
    # at large N / short arcs the argmax measures best.
    # In the shared-map redesign the first update's weights are uniform
    # (empty grid scores the z_rand floor everywhere) so a raw argmax would
    # bake a random heading draw into the map gauge; `best_pose` itself
    # falls back to the sharpened mean on uninformative updates (see
    # mcl.update), and "mean"/"mode"/"auto" are available where they
    # measure better (long low-N arcs; 1M aligned-ATE study). The OUTPUT
    # estimate stays the best particle (refined below when configured) for
    # reference parity.
    est_pose = st.best_pose
    mp = resolve_map_pose(cfg)
    if mp == "mean":
        map_pose = mcl_mod.mean_pose(st)
    elif mp == "mode":
        map_pose = st.mode_pose
    else:
        map_pose = st.best_pose
    if cfg.scanmatch is not None:
        from slam_tpu.ops import scanmatch

        est_pose, _ = scanmatch.refine_pose(
            lf_field,
            st.best_pose,
            scan,
            rc=cfg.raycast,
            cfg=cfg.scanmatch,
            scanner_offset=cfg.mcl.scanner_offset,
            stddev=cfg.mcl.meas_stddev,
            z_hit=cfg.mcl.lf_z_hit,
            z_rand=cfg.mcl.lf_z_rand,
        )
        if cfg.scanmatch.mapping:
            map_pose = est_pose

    new_grid = mapping.scan_logodds_update(
        state.grid,
        map_pose,
        scan,
        scanner_offset=cfg.mcl.scanner_offset,
        step=cfg.raycast.step,
        max_dist=cfg.raycast.max_dist,
        l_occ=cfg.map.l_occ,
        l_free=cfg.map.l_free,
        l_min=cfg.map.l_min,
        l_max=cfg.map.l_max,
    )
    # `st.updates` is POST-increment here (1 after the first update) while
    # mcl.update's resample_every gate reads the PRE-increment counter
    # (fires on the first update); subtract 1 so both every-k throttles
    # share one phase and the FIRST scan — the bootstrap against the empty
    # grid — always maps (with map_every=k>1 the raw modulo skipped it).
    do_map = ((st.updates - 1) % cfg.map_every) == 0
    new_grid = jnp.where(do_map, new_grid, state.grid)
    new_edt = state.edt
    if cfg.edt_box is not None and lf_field is not None:
        from slam_tpu.ops import edt as edtlib

        # Incremental cache refresh: bitwise-equal to a full rebuild of
        # the NEW grid's EDT (exactness by the JFA reach bound, unit- and
        # e2e-tested); skipped map updates diff empty and keep the cache.
        new_edt = edtlib.edt_refresh(
            state.edt,
            blocked,
            gridlib.blocked_from_logodds(new_grid),
            max_dist=_lf_cap(cfg),
            box=cfg.edt_box,
        )
    return SLAMState(mcl=st, grid=new_grid, est_pose=est_pose, edt=new_edt)


def predict_only(state: SLAMState, odom: Odometry, cfg: SLAMConfig) -> SLAMState:
    """Motion-only step for frames without a scan (`apps/grid_slam.cpp:130-142`
    predicts every frame but updates every k-th)."""
    return state.replace(mcl=mcl_mod.predict(state.mcl, odom, cfg.motion.alphas))


class AutoTierDispatcher:
    """Host-lagged tier dispatch for ``measurement="likelihood_field_auto"``.

    Instead of the in-program `lax.cond` (correct, but chained dispatch of
    a program with data-dependent conditionals was seen to de-pipeline on
    the first target's remote runtime; not measured on the H100), host
    wrappers keep TWO conditional-free jitted steps (boxed table / direct
    LF) plus a tiny predicate program. The predicate of a previous state
    is prefetched to host (`copy_to_host_async`) during the step gap and
    re-checked every ``check_every`` steps, so the per-step fetch cost is
    one host round trip amortized over ``check_every``. The lag is
    acceptable for SLOW tier
    transitions (gradual spread growth, convergence after global
    localization); for the FAST transition — kidnap recovery, where
    `MCLConfig.adaptive` injection disperses the cloud in one step and
    lagged table steps would floor the injected particles out of the box
    for up to check_every+1 updates — ``check_every`` defaults to 1
    whenever ``cfg.mcl.adaptive`` is set, trading one fetch round trip
    per step for prompt switching. KNOWN LAG RISK at the non-adaptive
    default (check_every=4): a cloud dispersed by something other than
    injection — a featureless corridor, sensor dropout — is scored by
    the boxed table (flooring most particles to the z_rand floor, which
    can itself sustain the dispersal) for up to check_every+1 updates
    before the direct tier engages. If the environment has such
    stretches, pass ``check_every=1`` (one prefetched fetch per
    step) or use the pure-jit `lax.cond` auto path (no lag at all),
    which remains for single-program contexts.

    ``make_step(cfg) -> fn(state, odom, scan)`` builds the engine's jitted
    step for a forced-measurement config (the sharded engine closes its
    shardings and resampler over it).
    """

    def __init__(self, cfg: SLAMConfig, make_step, check_every: int | None = None):
        import dataclasses as _dc

        self._step_table = make_step(_dc.replace(
            cfg, mcl=_dc.replace(cfg.mcl, measurement="likelihood_field_table")
        ))
        self._step_direct = make_step(_dc.replace(
            cfg, mcl=_dc.replace(cfg.mcl, measurement="likelihood_field")
        ))
        if check_every is None:
            check_every = 1 if cfg.mcl.adaptive is not None else 4

        def _pred(s):
            from slam_tpu.ops.measurement import lf_auto_converged

            return lf_auto_converged(
                s.mcl.particles.pose, cfg.mcl, cfg.map.shape,
                scanner_offset=cfg.mcl.scanner_offset,
            )

        self._predicate = jax.jit(_pred)
        self.check_every = check_every
        self.reset()

    def reset(self):
        self._pending = None
        self._tick = 0
        self.converged = None

    def step(self, state, odom, scan):
        if self.converged is None:
            self.converged = bool(self._predicate(state))
        elif self._pending is not None:
            self.converged = bool(self._pending)
            self._pending = None
        fn = self._step_table if self.converged else self._step_direct
        out = fn(state, odom, scan)
        self._tick += 1
        if self._tick % self.check_every == 0:
            p = self._predicate(out)
            try:
                p.copy_to_host_async()
            except AttributeError:
                pass
            self._pending = p
        return out


class GridSLAM:
    """Jitted wrapper; cfg held static. ``likelihood_field_auto`` uses the
    host-lagged `AutoTierDispatcher` (see its docstring)."""

    def __init__(self, cfg: SLAMConfig, seed: int = 0):
        self.cfg = cfg
        self._auto = None
        if cfg.mcl.measurement == "likelihood_field_auto":
            self._auto = AutoTierDispatcher(
                cfg, lambda c: jax.jit(lambda s, o, z: step(s, o, z, c))
            )
        else:
            self._step = jax.jit(lambda s, o, z: step(s, o, z, cfg))
        self._predict = jax.jit(lambda s, o: predict_only(s, o, cfg))
        self._key = jax.random.key(seed)

    def init(self, pose: Pose | None = None) -> SLAMState:
        if self._auto is not None:
            self._auto.reset()
        return init(self._key, self.cfg, pose)

    def step(self, state, odom: Odometry, scan: Scan) -> SLAMState:
        if self._auto is not None:
            return self._auto.step(state, odom, scan)
        return self._step(state, odom, scan)

    def predict(self, state, odom: Odometry) -> SLAMState:
        return self._predict(state, odom)

    def prob_map(self, state) -> jax.Array:
        """P(occupied) in [0, 1] from the log-odds grid."""
        return gridlib.log_odds_inv(state.grid)
