"""App smoke tests: each CLI demo runs headlessly end-to-end on tiny
configs (``--cpu``: without it an app refuses to run off the GPU)."""

import numpy as np
import pytest

from slam_tpu.apps import (
    astar_planner,
    grid_slam,
    hastar_planner,
    nearest_neighbor,
    regions,
    rrt_planner,
)


def test_grid_slam_app(tmp_path):
    out = str(tmp_path / "s.gif")
    ate = grid_slam.main(
        [
            "--cpu", "--particles", "64", "--steps", "20", "--n-rays", "12",
            "--max-dist", "60", "--frame-every", "5", "--out", out,
        ]
    )
    assert ate < 30.0
    assert (tmp_path / "s.gif").exists()


def test_grid_slam_app_loc_mode(tmp_path):
    out = str(tmp_path / "l.gif")
    ate = grid_slam.main(
        [
            "--cpu", "--mode", "loc", "--particles", "64", "--steps", "15",
            "--n-rays", "12", "--max-dist", "60", "--out", out,
        ]
    )
    assert ate < 20.0


def test_astar_app(tmp_path):
    ok = astar_planner.main(["--cpu", "--out", str(tmp_path / "a.png")])
    assert ok


def test_hastar_app(tmp_path):
    ok = hastar_planner.main(
        [
            "--cpu", "--out", str(tmp_path / "h.png"), "--velocity", "5",
            "--batch", "64", "--inflate", "2",
            "--start", "40", "64", "--goal", "200", "64",
        ]
    )
    assert ok


def test_rrt_app(tmp_path):
    ok = rrt_planner.main(
        [
            "--cpu", "--out", str(tmp_path / "r.png"), "--n-points", "100",
            "--reach", "8", "--radius", "16", "--max-nodes", "1024",
            "--batch", "64", "--inflate", "2",
        ]
    )
    assert ok


def test_planner_progress_animations(tmp_path):
    """Per-round search-progress GIFs — the headless form of the reference's
    live planner animation (A* frontier `slam/astar.cpp:73-79`, HA*
    expansions `slam/hastar.cpp:168-204`, RRT* tree growth
    `slam/rrtstar.cpp:107-144`)."""
    ok = astar_planner.main(
        ["--cpu", "--out", str(tmp_path / "a.png"), "--animate", str(tmp_path / "a.gif")]
    )
    assert ok and (tmp_path / "a.gif").exists()
    ok = hastar_planner.main(
        [
            "--cpu", "--out", str(tmp_path / "h.png"), "--velocity", "5",
            "--batch", "64", "--inflate", "2",
            "--start", "40", "64", "--goal", "200", "64",
            "--animate", str(tmp_path / "h.gif"), "--animate-every", "8",
        ]
    )
    assert ok and (tmp_path / "h.gif").exists()
    ok = rrt_planner.main(
        [
            "--cpu", "--out", str(tmp_path / "r.png"), "--n-points", "100",
            "--reach", "8", "--radius", "16", "--max-nodes", "1024",
            "--batch", "64", "--inflate", "2",
            "--animate", str(tmp_path / "r.gif"),
        ]
    )
    assert ok and (tmp_path / "r.gif").exists()


def test_nn_and_regions_apps(tmp_path):
    nearest_neighbor.main(
        ["--cpu", "--n", "200", "--queries", "3", "--check", "--out", str(tmp_path / "n.png")]
    )
    regions.main(
        ["--cpu", "--n", "300", "--boxes", "2", "--check", "--out", str(tmp_path / "g.png")]
    )


def test_index_structure_visualizations(tmp_path):
    """The dense-index analogs of the reference's kd-tree split-line and
    quadtree node-box rendering (`slam/kdtree.cpp:201-223`,
    `slam/quadtree.cpp:141-161`)."""
    nearest_neighbor.main(
        ["--cpu", "--n", "50", "--queries", "2", "--size", "64", "--check",
         "--draw-partition", "--out", str(tmp_path / "nv.png")]
    )
    regions.main(
        ["--cpu", "--n", "60", "--boxes", "1", "--size", "64", "--check",
         "--draw-tree", "--out", str(tmp_path / "gv.png")]
    )
    assert (tmp_path / "nv.png").exists()
    assert (tmp_path / "gv.png").exists()


def test_interactive_replanning(tmp_path, monkeypatch):
    """Warm repeated-query replanning — the headless form of the reference's
    mouse-driven event loops (`apps/hastar_planner.cpp:50-117`,
    `apps/rrt_planner.cpp:44-68`)."""
    import io

    monkeypatch.setattr("sys.stdin", io.StringIO("40 40 100 100\nquit\n"))
    ok = rrt_planner.main(
        ["--cpu", "--out", str(tmp_path / "r.png"), "--n-points", "50",
         "--reach", "16", "--radius", "32", "--max-nodes", "1024",
         "--batch", "64", "--inflate", "2", "--interactive"]
    )
    assert ok
    assert (tmp_path / "r_1.png").exists()

    monkeypatch.setattr(
        "sys.stdin", io.StringIO("start 40 40\ngoal 100 100\nq\n")
    )
    ok = hastar_planner.main(
        ["--cpu", "--out", str(tmp_path / "h.png"), "--velocity", "5",
         "--batch", "64", "--inflate", "2",
         "--start", "40", "64", "--goal", "200", "64", "--interactive"]
    )
    assert ok
    assert (tmp_path / "h_1.png").exists()


def test_fleet_localization_app(tmp_path):
    from slam_tpu.apps import fleet_localization

    out = str(tmp_path / "fleet.png")
    mean_ate = fleet_localization.main(
        ["--cpu", "--map", "", "--robots", "2", "--particles", "256", "--steps", "8",
         "--beams", "16", "--backend", "sdf", "--out", out]
    )
    assert mean_ate < 10.0
    assert (tmp_path / "fleet.png").exists()


def test_slam_replan_app(tmp_path):
    """The round-5 capstone: lattice HA* replanning ON the evolving SLAM
    grid, closed loop until the goal (erode -> plan -> follow). Tiny
    config: a 96-cell room, short horizon — asserts the loop runs, plans
    at least twice, and makes real progress toward the goal."""
    import json as _json

    from slam_tpu.apps import slam_replan

    out = str(tmp_path / "nav.png")
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = slam_replan.main(
            [
                "--cpu", "--size", "96", "--particles", "128", "--steps", "220",
                "--n-rays", "16", "--max-dist", "50", "--table-box", "32",
                "--replan-every", "25", "--speed", "2.0",
                "--planner-batch", "64", "--max-rounds", "600",
                "--tol", "8", "--out", out,
            ]
        )
    rec = _json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rec["n_replans"] >= 2
    assert rec["steps"] > 10
    # Reached, or at least closed most of the start-goal gap (~80 cells).
    assert rec["reached"] or rec["final_gt_err"] < 40.0, rec
    import os

    assert os.path.getsize(out) > 0


def test_replan_waypoint_search_skips_passed_cells():
    """Regression for the round-5 pursuit fix: the waypoint search must
    start at the path point NEAREST the robot, not the path head — the
    head falls behind between replans, and a behind-cell >= lookahead
    away would steer the robot backward into a limit-cycle wiggle."""
    from slam_tpu.apps.slam_replan import cell_to_world, pick_waypoint

    h = 64
    # Straight east-bound corridor path along row i=32 (world y = 31.5).
    path = [(32, j) for j in range(2, 60)]
    # Robot mid-path at x ~= 30; cells near the head are ~25 units BEHIND
    # and would match a naive >= lookahead scan from the start.
    wx, wy = pick_waypoint(path, h, 30.0, 31.5, lookahead=8.0)
    assert wx > 30.0, (wx, wy)  # ahead, not behind
    assert abs(wx - 30.0 - 8.0) <= 1.0  # first cell past the lookahead
    assert wy == 31.5
    # Past the last cell: returns the path end (never an earlier cell).
    ex, ey = cell_to_world(h, *path[-1])
    wx, wy = pick_waypoint(path, h, ex + 3.0, ey, lookahead=8.0)
    assert (wx, wy) == (ex, ey)
