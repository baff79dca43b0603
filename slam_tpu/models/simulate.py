"""Closed-loop simulation harness: scripted odometry + fake lidar + filter.

Re-creates the `apps/grid_slam.cpp` main loop headlessly: ground truth is
advanced through the same noisy motion model the filter predicts with
(`apps/grid_slam.cpp:134-135`), the fake lidar scans the ground-truth map
from the sensor pose (`:144-146`), and the filter consumes (odometry, scan)
pairs. Used by the e2e tests, the benchmark harness, and the demo apps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.core import grid as gridlib
from slam_tpu.core.config import SLAMConfig
from slam_tpu.core.types import Odometry, Pose
from slam_tpu.models import fake_lidar
from slam_tpu.models import mcl as mcl_mod
from slam_tpu.models import slam as slam_mod
from slam_tpu.ops import motion, rayfield
from slam_tpu.ops.measurement import sensor_pose


def forward_arc_commands(n_steps: int, trans: float = 2.5, rot: float = 0.0):
    """Constant forward(+turn) odometry commands, the benchmark's fixed
    odometry pattern (`benchmark/mcl.cpp:58-64` uses {2.5, 0.02, 0.02})."""
    return [Odometry.create(rot / 2, trans, rot / 2) for _ in range(n_steps)]


@dataclasses.dataclass
class SimResult:
    est_xy: np.ndarray  # [T, 2] estimated (mean pose) trajectory
    best_xy: np.ndarray  # [T, 2] best-particle trajectory
    gt_xy: np.ndarray  # [T, 2] ground-truth trajectory
    final_state: object
    # [T, 2] engine output-estimate trajectory (SLAMState.est_pose: the
    # correlative scan-matched pose when SLAMConfig.scanmatch is set);
    # None for localization runs.
    sm_xy: np.ndarray | None = None


def run_localization(
    gt_blocked: jax.Array,
    cfg: SLAMConfig,
    commands: List[Odometry],
    start_pose: Pose,
    seed: int = 0,
    update_every: int = 1,
    field=None,
) -> SimResult:
    """MCL against the known (static) map. Pass a prebuilt `field` to reuse
    an existing LUT/EDT (big-map tables take seconds to build)."""
    key = jax.random.key(seed)
    k_init, k_gt, key = jax.random.split(key, 3)

    m = mcl_mod.MCL(cfg.mcl, cfg.raycast)
    state = mcl_mod.init(k_init, cfg.mcl.n_particles, start_pose)
    # Static map: build the raycast backend structure (EDT / LUT) once.
    if field is None:
        field = rayfield.make_ray_field(gt_blocked, cfg.raycast)

    # Optional correlative refinement of the output estimate
    # (SLAMConfig.scanmatch; slam_tpu.ops.scanmatch): the serving mode
    # where few particles + the refined mean match a much larger filter.
    refine_fn = None
    if cfg.scanmatch is not None:
        from slam_tpu.ops import edt as edtlib, scanmatch

        sm_field = field
        if sm_field.edt is None:
            sm_field = rayfield.RayField(
                blocked=jnp.asarray(gt_blocked, bool),
                edt=edtlib.edt_capped(
                    jnp.asarray(gt_blocked, bool),
                    5.0 * cfg.mcl.meas_stddev + 2.0,
                ),
            )
        refine_fn = jax.jit(
            lambda p, z: scanmatch.refine_pose(
                sm_field,
                p,
                z,
                rc=cfg.raycast,
                cfg=cfg.scanmatch,
                scanner_offset=cfg.mcl.scanner_offset,
                stddev=cfg.mcl.meas_stddev,
                z_hit=cfg.mcl.lf_z_hit,
                z_rand=cfg.mcl.lf_z_rand,
            )[0]
        )

    gt_pose = start_pose
    est_xy, best_xy, gt_xy, sm_xy = [], [], [], []
    scan_fn = jax.jit(
        lambda pose, k: fake_lidar.scan(
            gt_blocked, pose, cfg.lidar, cfg.raycast, key=k
        )
        if cfg.lidar.noise_stddev > 0
        else fake_lidar.scan(gt_blocked, pose, cfg.lidar, cfg.raycast)
    )

    scan = None
    for t, odom in enumerate(commands):
        k_gt, k_scan = jax.random.split(jax.random.fold_in(k_gt, t))
        state = m.predict(state, odom, cfg.motion.alphas)
        gt_pose = motion.sample_motion_model_odometry(
            k_gt, odom, gt_pose, cfg.motion.alphas
        )
        updated = (t + 1) % update_every == 0
        if updated:
            sp = sensor_pose(gt_pose, cfg.mcl.scanner_offset)
            scan = scan_fn(sp, k_scan)
            state = m.update(state, scan, field)

        mp = mcl_mod.mean_pose(state)
        est_xy.append([float(mp.x), float(mp.y)])
        best_xy.append([float(state.best_pose.x), float(state.best_pose.y)])
        gt_xy.append([float(gt_pose.x), float(gt_pose.y)])
        # Refine only on UPDATE frames: between updates the latest scan is
        # stale, and scoring the advanced mean pose against it drags the
        # estimate back toward the old scan pose (advisor finding, round 3).
        if refine_fn is not None and updated and scan is not None:
            r = refine_fn(mp, scan)
            sm_xy.append([float(r.x), float(r.y)])
        else:
            sm_xy.append(est_xy[-1])

    return SimResult(
        est_xy=np.array(est_xy),
        best_xy=np.array(best_xy),
        gt_xy=np.array(gt_xy),
        final_state=state,
        sm_xy=np.array(sm_xy) if refine_fn is not None else None,
    )


def run_slam(
    gt_blocked: jax.Array,
    cfg: SLAMConfig,
    commands: List[Odometry],
    start_pose: Pose,
    seed: int = 0,
    update_every: int = 1,
) -> SimResult:
    """Full SLAM: unknown map, scans against ground truth, mapping from the
    estimated pose."""
    engine = slam_mod.GridSLAM(cfg, seed=seed)
    state = engine.init(start_pose)

    key = jax.random.key(seed + 1)
    gt_pose = start_pose
    est_xy, best_xy, gt_xy, sm_xy = [], [], [], []
    scan_fn = jax.jit(
        lambda pose, k: fake_lidar.scan(
            gt_blocked, pose, cfg.lidar, cfg.raycast, key=k
        )
        if cfg.lidar.noise_stddev > 0
        else fake_lidar.scan(gt_blocked, pose, cfg.lidar, cfg.raycast)
    )

    for t, odom in enumerate(commands):
        k_gt, k_scan = jax.random.split(jax.random.fold_in(key, t))
        gt_pose = motion.sample_motion_model_odometry(
            k_gt, odom, gt_pose, cfg.motion.alphas
        )
        if (t + 1) % update_every == 0:
            sp = sensor_pose(gt_pose, cfg.mcl.scanner_offset)
            scan = scan_fn(sp, k_scan)
            state = engine.step(state, odom, scan)
        else:
            state = engine.predict(state, odom)

        mp = mcl_mod.mean_pose(state.mcl)
        est_xy.append([float(mp.x), float(mp.y)])
        best_xy.append(
            [float(state.mcl.best_pose.x), float(state.mcl.best_pose.y)]
        )
        sm_xy.append([float(state.est_pose.x), float(state.est_pose.y)])
        gt_xy.append([float(gt_pose.x), float(gt_pose.y)])

    return SimResult(
        est_xy=np.array(est_xy),
        best_xy=np.array(best_xy),
        gt_xy=np.array(gt_xy),
        final_state=state,
        sm_xy=np.array(sm_xy),
    )


def run_slam_deterministic(
    gt_blocked: jax.Array,
    cfg: SLAMConfig,
    n_steps: int,
    trans: float = 2.5,
    rot: float = 0.02,
    seed: int = 0,
) -> SimResult:
    """Grid SLAM along the C++ head-to-head harness's DETERMINISTIC arc
    (`tools/refbench/ref_mcl_traj.cpp`): ground truth integrates
    theta += rot/2; x += trans*cos(theta); theta += rot/2 with no noise, so
    the trajectory (and hence the exact-DDA scans) matches the reference
    binary bit-for-bit and ATEs are directly comparable."""
    engine = slam_mod.GridSLAM(cfg, seed=seed)
    h, w = gt_blocked.shape
    start = Pose.create(w / 2.0, h / 2.0, np.pi / 2)
    state = engine.init(start)
    gt = start
    odom = Odometry.create(rot / 2, trans, rot / 2)
    est_mean, best_xy, gts, sm_xy = [], [], [], []
    scan_fn = jax.jit(
        lambda pose: fake_lidar.scan(gt_blocked, pose, cfg.lidar, cfg.raycast)
    )
    for _ in range(n_steps):
        th1 = gt.theta + rot / 2
        gt = Pose.create(
            gt.x + trans * jnp.cos(th1), gt.y + trans * jnp.sin(th1),
            th1 + rot / 2,
        )
        sp = sensor_pose(gt, cfg.mcl.scanner_offset)
        state = engine.step(state, odom, scan_fn(sp))
        mp = mcl_mod.mean_pose(state.mcl)
        est_mean.append([float(mp.x), float(mp.y)])
        best_xy.append(
            [float(state.mcl.best_pose.x), float(state.mcl.best_pose.y)]
        )
        sm_xy.append([float(state.est_pose.x), float(state.est_pose.y)])
        gts.append([float(gt.x), float(gt.y)])
    return SimResult(
        est_xy=np.array(est_mean),
        best_xy=np.array(best_xy),
        gt_xy=np.array(gts),
        final_state=state,
        sm_xy=np.array(sm_xy),
    )


def synthetic_room(h: int = 128, w: int = 128) -> np.ndarray:
    """A walled room with interior obstacles; bool[h, w] blocked mask."""
    blocked = np.zeros((h, w), bool)
    blocked[:2, :] = blocked[-2:, :] = True
    blocked[:, :2] = blocked[:, -2:] = True
    blocked[h // 4 : h // 4 + 6, w // 3 : 2 * w // 3] = True
    blocked[2 * h // 3 : 2 * h // 3 + 8, w // 5 : w // 5 + 8] = True
    blocked[h // 2 : h // 2 + 4, 3 * w // 4 : 3 * w // 4 + 10] = True
    return blocked


def synthetic_floor_plan(h: int = 599, w: int = 1297) -> np.ndarray:
    """bool[h, w] office-like floor plan at the reference floor plan's size
    (599x1297): border walls, a grid of rooms, doors in every wall. The
    reference benchmarks' cells stay free: the planner query (150, 450) ->
    (450, 750) (connected through doors) and the MCL pose at world
    (400, 400)."""
    blocked = np.zeros((h, w), bool)
    blocked[:4, :] = blocked[-4:, :] = True
    blocked[:, :4] = blocked[:, -4:] = True
    for x in range(300, w - 100, 200):  # vertical walls with door gaps
        blocked[:, x : x + 4] = True
        blocked[h // 2 - 40 : h // 2 + 40, x : x + 4] = False
    for y in range(100, h - 40, 150):  # horizontal walls with door gaps
        blocked[y : y + 4, :] = True
        blocked[y : y + 4, w // 3 - 40 : w // 3 + 40] = False
        blocked[y : y + 4, 2 * w // 3 - 40 : 2 * w // 3 + 40] = False
    return blocked


def synthetic_maze(
    h: int = 2354, w: int = 2464, pitch: int = 40, seed: int = 0
) -> np.ndarray:
    """bool[h, w] seeded maze-like map, by default at the reference maze's
    size (2354x2464): one-pixel walls on a ``pitch`` grid, each wall segment
    opened by a door with probability 0.7, closed outer border."""
    lo, hi = pitch // 5, pitch - pitch // 5  # door span within a segment
    rng = np.random.default_rng(seed)
    blocked = np.zeros((h, w), bool)
    blocked[::pitch, :] = True
    blocked[:, ::pitch] = True
    for i in range(0, h, pitch):  # knock doors
        for j in range(0, w, pitch):
            if rng.random() < 0.7:
                blocked[i, j + lo : j + hi] = False
            if rng.random() < 0.7:
                blocked[i + lo : i + hi, j] = False
    blocked[[0, -1], :] = True
    blocked[:, [0, -1]] = True
    return blocked


def find_start(blocked: np.ndarray) -> tuple[float, float]:
    """World (x, y) of a free cell with the most clearance, nearest the map
    center among near-ties (maze corridors are narrow)."""
    from slam_tpu.ops import edt as edtlib

    # Out-of-map counts as blocked, so clearance at the border is distance
    # to the border.
    bpad = np.pad(np.asarray(blocked), 1, constant_values=True)
    e = np.array(edtlib.edt_capped(jnp.asarray(bpad), 64.0))[1:-1, 1:-1]
    # Cells clearer than the cap saturate to one plateau value, which just
    # widens the near-max tie set; the center-distance pick breaks the tie.
    free = ~np.asarray(blocked)
    e[~free] = 0.0
    # Near-max clearance (1 px slack absorbs the JFA's metric quantization),
    # then closest to the map center among those.
    ii, jj = np.nonzero(free & (e >= e[free].max() - 1.0))
    h, w = blocked.shape
    k = np.argmin((ii - h / 2) ** 2 + (jj - w / 2) ** 2)
    i, j = int(ii[k]), int(jj[k])
    return float(j) + 0.5, float(h - i) - 0.5
