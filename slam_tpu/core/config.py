"""Configuration system.

The reference has no config layer: ~20 knobs live as constexprs and argv
positionals scattered through the apps (SURVEY.md section 5). Here every
tunable is a frozen dataclass so configs are hashable (usable as jit static
arguments) and serializable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Ray-march parameters (`slam/raycast.h:13-28` defaults step=0.5)."""

    step: float = 0.5
    max_dist: float = 500.0
    # Backend: "march" = exact fixed-step DDA (reference semantics oracle);
    # "sdf" = sphere tracing over a Euclidean distance transform (fast,
    # map may change every step); "lut" = precomputed directional distance
    # table, one gather per ray (fastest, static maps only); "cddt" =
    # compressed directional table, log2(K)-gather binary search per ray
    # (static maps whose dense LUT outgrows device memory —
    # slam_tpu.ops.cddt).
    backend: str = "march"
    # Steps marched per early-exit chunk in the "march" backend.
    chunk: int = 64
    # Angular bins for the "lut"/"cddt" backends.
    lut_bins: int = 360
    # Max obstacle runs per rotated row in the "cddt" backend (None = the
    # build measures the true maximum with an extra counting pass).
    cddt_k: Optional[int] = None
    # Table element type: "bf16" (default) or "u8" (fixed-point, half the
    # device memory — the dense-table answer to CDDT compression for huge maps; adds
    # +-max_dist*1.25/510 quantization error, ~1.2px at max_dist=500).
    lut_dtype: str = "bf16"
    # Safety margin subtracted from EDT steps in the "sdf" backend (>= 1.5
    # when the EDT comes from JFA, 1.0 for the exact transform).
    sdf_margin: float = 1.5

    @property
    def max_steps(self) -> int:
        return int(math.ceil(self.max_dist / self.step))


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Simulated lidar (`slam/fake_lidar.h:10-23`, app config
    `apps/grid_slam.cpp:88-97`)."""

    start: float = 0.0
    stop: float = 2.0 * math.pi
    max_dist: float = 500.0
    stddev: float = 5.0
    n_rays: int = 90
    # The reference never applies its stddev to simulated ranges
    # (`slam/fake_lidar.cpp:15-33`); the notebook prototype did (cell 8).
    # 0.0 reproduces the C++; >0 adds Gaussian range noise.
    noise_stddev: float = 0.0

    @property
    def angles(self) -> Tuple[float, ...]:
        rng = self.stop - self.start
        step = rng / self.n_rays
        return tuple(k * step - rng / 2.0 for k in range(self.n_rays))


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Thrun odometry motion-model noise (`slam/motion.cpp:9-32`); defaults
    from `apps/grid_slam.cpp:132`."""

    alphas: Tuple[float, float, float, float] = (0.001, 0.001, 0.001, 0.001)


@dataclasses.dataclass(frozen=True)
class VelocityMotionConfig:
    """Velocity motion-model noise (`slam/motion.cpp:34-56`)."""

    alphas: Tuple[float, float, float, float, float, float] = (
        0.001,
        0.001,
        0.001,
        0.001,
        0.001,
        0.001,
    )


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Shared log-odds occupancy grid.

    Additive log-odds (textbook, `slam/util.h:72-73` semantics) replaces the
    reference's multiplicative clamped updates (`slam/raycast.cpp:178-213`);
    SURVEY.md section 5 quirk 4 records this as a deliberate fix.
    """

    height: int = 1000
    width: int = 1000
    # Log-odds increments per observation. Softer increments (these halved
    # defaults, round 4) keep the map PLASTIC: early scans mapped from a
    # slightly-wrong estimate can be re-carved by later better-anchored
    # ones instead of locking the gauge in. Measured on the 120-step
    # deterministic arc at 200 particles (3 seeds): 0.85/-0.4 ->
    # 12.6/12.9/1.6 px (mean 9.0); 0.42/-0.2 -> 3.2/13.9/2.9 (mean 6.6);
    # 0.21/-0.1 -> 11.8/15.3/2.1 (worse — too slow to commit walls).
    # Short-arc / large-N closed-loop ATE is unchanged by the halving
    # (100k own-arc table: 3.94/3.65 vs 3.96/3.65).
    l_occ: float = 0.42  # log-odds increment for an occupied observation
    l_free: float = -0.2  # log-odds increment for a free observation
    l_min: float = -6.0
    l_max: float = 6.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Augmented MCL random-particle injection (notebook cell 9:
    alpha_slow=0.1, alpha_fast=0.9, inject ratio 1 - w_fast/w_slow).

    The raw ratio is a DEATH SPIRAL risk (measured):
    ordinary per-scan likelihood fluctuations of 1-2 nats make
    1 - exp(w_fast - w_slow) spike to 0.6-0.97, the injected junk lowers
    the next average, and the filter floods itself with random particles
    during PERFECT tracking (spread 35 px, never re-converges).
    ``max_ratio`` caps the per-step injection; 0.1 is the measured
    kidnap-recovery setting (all seeds re-localize in 13-29 steps on the
    synthetic-room scenario, estimator = the weight-aware
    ``MCLState.mode_pose`` — the unweighted mean is polluted by the
    injected uniform particles). Default 1.0 = notebook fidelity."""

    alpha_slow: float = 0.1
    alpha_fast: float = 0.9
    max_ratio: float = 1.0


@dataclasses.dataclass(frozen=True)
class MCLConfig:
    n_particles: int = 1000
    # Measurement model: "beam" = raycast the predicted range per beam (the
    # reference's model, `slam/raycast.cpp:225-242`); "likelihood_field" =
    # score each scan endpoint by its distance to the nearest obstacle
    # (Thrun et al. table 6.3) — no raycasting in the update at all, one
    # EDT gather per beam (the natural choice when the map changes every
    # step).
    measurement: str = "beam"
    # Beam-model noise (`apps/grid_slam.cpp:88` FAKE_LIDAR_STDDEV=5).
    meas_stddev: float = 5.0
    # Additive weight floor per beam (`slam/raycast.cpp:233` EPSILON=0.1).
    meas_epsilon: float = 0.1
    # Likelihood-field mixture weights: z_hit * N(0, sigma) + z_rand/z_max.
    lf_z_hit: float = 0.95
    lf_z_rand: float = 0.05
    # "likelihood_field_table" (the large-N tracking/SLAM fast path): score
    # via a windowed correlative table (Olson 2009) — a per-step dense build
    # over lf_table_bins heading bins spanning the cloud's circular spread,
    # then TWO gathers per particle instead of one per beam. Build cost is
    # N-independent; accuracy notes in
    # `ops.measurement.particle_log_weights_lf_table`.
    lf_table_bins: int = 32
    lf_table_spread: float = 4.0
    lf_table_min_halfwidth: float = 0.02
    # Spatial analog of the heading window: when set, build the table only
    # over an lf_table_box^2 cell box centered on the cloud's mean sensor
    # cell (out-of-box particles score the z_rand floor, like out-of-window
    # headings). Build traffic drops from T*H*W to T*box^2 — negligible vs
    # the map-sized dense build — and the "build scales with map area" term
    # that made the dense table lose on big maps disappears. None = dense
    # full-map build. Tracking/SLAM mode only (a dispersed global-
    # localization cloud outruns any static box; use the direct model there,
    # as with the heading window — or measurement="likelihood_field_auto").
    lf_table_box: int | None = None
    # measurement="likelihood_field_auto" picks per step between the boxed
    # table (tracking fast path) and the direct likelihood field (dispersed
    # clouds: global localization, kidnap recovery under adaptive
    # injection) from the cloud's own statistics: table iff the 4-sigma
    # heading window half-width is at most lf_auto_max_halfwidth AND the
    # lf_auto_sigma-sigma spatial extent fits the half-box. Both branches
    # compile once (lax.cond); each step pays only the taken one. GridSLAM
    # dispatches the tier on the HOST with a lagged, prefetched predicate
    # instead (models.slam.AutoTierDispatcher) — same results, no cond in
    # the program.
    lf_auto_max_halfwidth: float = 0.6
    lf_auto_sigma: float = 4.0

    def __post_init__(self):
        if self.lf_table_box is not None and self.lf_table_box < 1:
            raise ValueError(
                f"lf_table_box must be >= 1 cells or None (dense build), "
                f"got {self.lf_table_box} — a degenerate box floors every "
                "particle"
            )
        if self.resample_every < 1:
            raise ValueError(
                f"resample_every must be >= 1, got {self.resample_every}"
            )
    # Storage dtype of the padded per-cell score field the build slides
    # windows over. Keep "f32": the ~0.2% per-cell score quantization of
    # "bf16" degrades 1M closed-loop ATE 3.51 -> 12.9 px
    # (tools/slam_1m_quality.py --table-dtype bf16) — at 1M particles the
    # winning weights differ by less than the bf16 error.
    lf_table_dtype: str = "f32"
    # "systematic" (low-variance, the upgrade SURVEY section 5 quirk 2 names)
    # or "multinomial" (reference fidelity, `slam/mcl.cpp:157-203`).
    resample: str = "systematic"
    # Resample only when effective sample size falls below this fraction of N;
    # 1.0 resamples every update like the reference (`slam/mcl.cpp:232-239`).
    ess_threshold: float = 1.0
    # Resample only on every k-th update (log weights accumulate across the
    # skipped updates; the reference resamples every update). Unlike the ESS
    # gate — which at 90 beams fires on ~every step anyway (measured,
    # tools/slam_ess_throttle.py) — this skips the resample WORK
    # unconditionally on the other k-1 steps. Composes with ess_threshold
    # (resample when BOTH the modulo and the ESS condition hold).
    resample_every: int = 1
    # Temperature of the sharpened weighted-mean estimate
    # (`MCLState.mode_pose`: softmax(tau * log_w) weights, pre-resample).
    # tau=1 is the plain weighted mean, tau -> inf approaches the best
    # particle; intermediate tau averages over the posterior mode only —
    # immune both to the argmax's selection noise at small N (and its
    # arbitrariness under uniform weights) and to the mean's ridge-shrinkage
    # bias on curved posteriors.
    mode_tau: float = 8.0
    # Lidar mounting offset in the robot frame (`apps/grid_slam.cpp:99`
    # SCANNER_OFFSET = {0, 30, 0}).
    scanner_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    adaptive: Optional[AdaptiveConfig] = None
    # STATIC promise that scan beam angles are evenly spaced by exactly this
    # many LUT bins (derive with `beam_bin_stride(lidar, rc)`). Unlocks the
    # fused panorama measurement path on the lut backend: one contiguous row
    # gather per particle + a gathered bin alignment instead of one scalar
    # gather per ray. None = general per-ray path.
    lut_beam_stride: Optional[int] = None


def beam_bin_stride(lidar: "LidarConfig", rc: "RaycastConfig") -> Optional[int]:
    """Beam angular spacing measured in LUT bins, when it is an exact
    positive integer (the precondition of the fused panorama measurement
    path); None otherwise."""
    spacing = (lidar.stop - lidar.start) / lidar.n_rays
    g = spacing * rc.lut_bins / (2.0 * math.pi)
    gi = round(g)
    if gi >= 1 and abs(g - gi) < 1e-9 and lidar.n_rays * gi <= rc.lut_bins:
        return gi
    return None


@dataclasses.dataclass(frozen=True)
class ScanMatchConfig:
    """Correlative scan-matching pose refinement (slam_tpu.ops.scanmatch).

    A beyond-parity component: the reference's pose estimate is the
    highest-weight particle (`slam/mcl.cpp:236-238`); this refines that
    seed by a local correlative search over the likelihood field (the
    single-level form of Olson, ICRA 2009) with sub-cell quadratic peak
    interpolation. ~theta_bins * (2*window+1)^2 * beams gathers — latency
    is negligible next to the filter update at any particle count."""

    # Integer-cell translation search radius around the seed (candidates
    # span [-window, +window] in both world axes).
    window: int = 5
    # Heading search half-width (rad) and candidate count across it.
    theta_halfwidth: float = 0.06
    theta_bins: int = 13
    # Quadratic sub-cell / sub-bin peak interpolation.
    subcell: bool = True
    # Drive the log-odds map update with the refined pose (GMapping-style
    # match-before-map) instead of the raw best particle. The refined
    # OUTPUT estimate (`SLAMState.est_pose`) is produced either way.
    # Default False: measured neutral-to-worse closed-loop (the map-pose
    # feedback amplifies the refinement's residual bias).
    mapping: bool = False
    # Expected EDT value at a true beam endpoint, in cells. Beam endpoints
    # land on wall FACES (plus ~step/2 march penetration) while the EDT
    # zeroes at wall cell CENTERS, so the likelihood peak sits ~half a
    # cell inside walls; scoring |edt - edt_offset| recenters it.
    # Calibrated on the floor plan: mean refined-from-truth error
    # 0.68 px at 0.0, 0.42 px at 0.5, worse beyond (tools probe in
    # tests/test_scanmatch.py covers the bias bound).
    edt_offset: float = 0.5
    # Coarse-to-fine (multi-resolution, the full Olson ICRA-2009 shape):
    # when coarse_window > 0 a COARSE level first searches translations in
    # [-coarse_window, +coarse_window] at stride coarse_stride (and
    # headings over +-coarse_theta_halfwidth in coarse_theta_bins) against
    # a stride-max-pooled score field (the pooling guarantees a block
    # containing the true peak scores at least as high as the peak, so the
    # strided argmax cannot skip it); the existing fine level then searches
    # its full window around the coarse peak. Extends the capture range
    # from `window` cells to coarse_window + window cells at ~2x, not
    # (coarse_window/window)^2 x, the cost. 0 = single-level (default).
    coarse_window: int = 0
    coarse_stride: int = 4
    coarse_theta_halfwidth: float = 0.25
    coarse_theta_bins: int = 11

    def __post_init__(self):
        if self.coarse_window > 0:
            # The cannot-skip guarantee needs the fine window to cover a
            # coarse block: the coarse argmax returns a block CENTER whose
            # residual from the true peak can be up to (stride-1)/2 cells
            # (and half a coarse heading step), so the fine search must
            # reach at least that far.
            if self.coarse_stride > 2 * self.window + 1:
                raise ValueError(
                    f"coarse_stride {self.coarse_stride} exceeds the fine "
                    f"window's reach 2*window+1 = {2 * self.window + 1}: "
                    "the fine level could not reach the true peak inside "
                    "the winning coarse block"
                )
            coarse_step = (
                2.0 * self.coarse_theta_halfwidth
                / max(1, self.coarse_theta_bins - 1)
            )
            if coarse_step > 2.0 * self.theta_halfwidth:
                raise ValueError(
                    f"coarse heading step {coarse_step:.4f} exceeds the "
                    f"fine level's span 2*theta_halfwidth = "
                    f"{2 * self.theta_halfwidth:.4f}: raise "
                    "coarse_theta_bins or theta_halfwidth"
                )


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Full grid-SLAM: MCL + shared-map log-odds occupancy mapping."""

    mcl: MCLConfig = MCLConfig()
    map: MapConfig = MapConfig()
    lidar: LidarConfig = LidarConfig()
    motion: MotionConfig = MotionConfig()
    raycast: RaycastConfig = RaycastConfig()
    # Map update throttling: update the map from the estimated pose every
    # k-th scan (1 = every scan).
    map_every: int = 1
    # Which pose estimate drives the shared-map update: "best" (default —
    # the reference keeps the best particle's map, `slam/mcl.cpp:236-238`;
    # since round 4 the argmax falls back to the sharpened mean whenever the
    # measurement is uninformative, fixing the empty-map first update's
    # arbitrary-particle gauge error), "mean" (post-resample circular mean),
    # "mode" (`MCLState.mode_pose`, the tau-sharpened pre-resample weighted
    # mean), or "auto" (resolve the measured regime rule at trace time —
    # see `models.slam.resolve_map_pose`). Measured closed-loop quality:
    # "best" is the most robust at small N (the 200-particle 120-step arc:
    # best-with-fallback mean-of-seeds 9.0 px vs mode 10.2, mean 11.7);
    # at large N "mean" makes the map gauge deterministic across filter
    # seeds and records the best SE(2)-aligned ATE when resampling every
    # update (1M k=1: 0.75-0.80 px aligned), while with resample_every>1
    # "mode" wins (the unweighted mean ignores the weights accumulated
    # across skipped resamples and degrades to 4.3-4.8 px aligned; mode
    # 1.2-1.5 px — the production config).
    map_pose: str = "best"
    # Optional correlative scan-matching refinement of the output pose
    # estimate (`SLAMState.est_pose` carries it). The refined pose drives
    # the map update only when `ScanMatchConfig.mapping` is True (default
    # False — measured worse closed-loop; see ScanMatchConfig.mapping).
    scanmatch: Optional[ScanMatchConfig] = None
    # Incremental likelihood-field EDT (round 5): carry the capped
    # distance field in SLAMState and refresh it per step only over an
    # edt_box^2 window around the cells whose BLOCKED status actually
    # flipped (bitwise-exact vs the full rebuild by the locality reach
    # bound — `ops.edt.edt_refresh`; wide-area edits fall back to the
    # full rebuild, no-flip steps are free). Turns the per-step full-map
    # transform — the dominant phase of big-map SLAM — into
    # O(edt_box^2). Constraints: 4 * edt_capped_reach(5*meas_stddev + 2)
    # < edt_box <= min(H, W); reach = ceil(cap) + 1, so at the default
    # meas_stddev=5 (cap 27, reach 28) edt_box >= 113. NOTE the flip set
    # of a long-range 360-degree scan lives on the beam-ENDPOINT ring —
    # up to 2*max_dist across — so small boxes constantly fall back;
    # 1024 is the maze setting. None = rebuild
    # per step. Only meaningful for the likelihood-field measurement
    # tiers and/or scanmatch (the march/lut beam models build no EDT);
    # MapShardedGridSLAM rejects it (replicated cache).
    edt_box: Optional[int] = None

    def __post_init__(self):
        if self.map_pose not in ("best", "mean", "mode", "auto"):
            # A typo'd estimator name would silently fall through to the
            # "best" branch and record a sweep under the wrong label.
            raise ValueError(
                f"map_pose must be 'best', 'mean', 'mode', or 'auto', got "
                f"{self.map_pose!r}"
            )


@dataclasses.dataclass(frozen=True)
class HybridAStarConfig:
    """Kinematic planner parameters (`slam/hastar.h:14-119`; app defaults
    `apps/hastar_planner.cpp:21-25`)."""

    velocity: float = 10.0
    max_steering: float = 40.0 * math.pi / 180.0
    length: float = 10.0 / math.tan(40.0 * math.pi / 180.0) * 2.0
    theta_res: int = 5
    branching_factor: int = 3
    tol: float = 5.0
    diff_drive: bool = True
    reverse_factor: float = 10.0  # `slam/hastar.cpp:95`
    # Frontier nodes expanded per device step (batched A* round size).
    batch: int = 256
    max_rounds: int = 4096
    # Frontier selection: "grouped" pops the best open node of each of
    # `batch` strided index groups (one O(S) pass); "topk" pops the exact
    # global best `batch` (a ~10x costlier full top-k per round, for
    # strict best-first expansion order).
    selection: str = "grouped"
    # Heuristic: "geodesic" precomputes an obstacle-aware distance-to-goal
    # field with the A* wavefront on a `coarse`-downsampled grid (the
    # holonomic-with-obstacles heuristic of Dolgov et al.; far stronger
    # pruning than the reference's Euclidean distance, `slam/hastar.cpp:62`);
    # "euclid" keeps reference behavior.
    heuristic: str = "geodesic"
    coarse: int = 4
    # Expansion mode: "continuous" tracks the exact entrant pose per cuboid
    # cell (the reference's semantics, `slam/hastar.cpp:168-204`);
    # "lattice" snaps every state to its cell/bin center, which makes the
    # steering adjacency a fixed per-bin index/cost table and turns edge
    # collision checks into precomputed shifted-AND feasibility maps — the
    # search state drops to (g, parent, open) and each round is pure
    # gather/scatter-min with no raycasts.
    mode: str = "continuous"
    # Lattice open-list ring capacity. The frontier lives in a compact
    # [capacity] buffer (no full-cuboid pass per round); slots recycle
    # round-robin, so an entry not popped within `capacity` subsequent
    # insertions is overwritten. The search counts such live-entry
    # overwrites (`LatticeState.n_lost`) and an exhaustion verdict with
    # n_lost > 0 is reported as unsound (logged by `solve`). None = 1M
    # entries (8 MB, one per-round argmin pass over 4 MB) clamped to ~4x
    # the cuboid on small maps; an EXPLICIT capacity is honored verbatim
    # (the n_lost warning tells users to raise it — that must never be a
    # silent no-op).
    open_capacity: Optional[int] = None
    # Lattice expansion depth: 2 adds the E^2 two-edge macro successors
    # per pop (pair feasibility precomputed as shifted-ANDs), advancing
    # the frontier two steps per round. The 7x-wider candidate fan
    # scatters mostly-duplicate targets and floods the open ring, which can
    # cost more than the saved rounds (not measured on the H100). Kept for
    # maps where rounds dominate (long corridors, sparse frontiers).
    lattice_depth: int = 1
    # Same-edge macro lanes: R >= 2 adds, for each single edge e and each
    # r in 2..R, the constant-steer repetition e^r (straight runs and
    # fixed-radius arcs) as one expansion lane. Unlike lattice_depth=2's
    # E^2 pair fan, this adds only (R-1)*E lanes with DISTINCT targets
    # along each primitive, and every prefix e^(r-1) is also a lane, so
    # reachable costs (and recovered paths) are exactly unchanged — the
    # frontier just advances up to R steps down corridors per round: the
    # lever when the search is bound by per-round latency.
    lattice_reps: int = 1
    # Heuristic inflation (weighted A* / bounded suboptimality): f = g +
    # weight * h. 1.0 = admissible (default); > 1.0 greedily cuts
    # expansions and rounds at a path cost penalty bounded by the factor.
    heuristic_weight: float = 1.0
    # EXPERIMENT (keep False): skip the pre-scatter st.gp[tgt] improvement
    # readback in the lattice round and rely on the post-scatter winner
    # check alone. XLA fuses the readback into the scatter-min, and the skip
    # admits equal-packed re-insert duplicates — catastrophic at w == 1.0
    # or with macro lanes, a path cost penalty at small batches. See
    # planners/hastar.py.
    lattice_skip_precheck: bool = False


@dataclasses.dataclass(frozen=True)
class RRTStarConfig:
    """RRT* parameters (`slam/rrtstar.h:12-64`; app defaults
    `apps/rrt_planner.cpp`: reach=20, radius=50)."""

    reach: float = 20.0
    radius: float = 50.0
    max_nodes: int = 4096
    # Candidate samples drawn per batched round.
    batch: int = 64
