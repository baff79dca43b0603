"""chip_smoke.py's phases at tiny sizes on the CPU: every phase's checks
hold, and the script itself refuses to run without a GPU."""

import math

import pytest

import chip_smoke as cs

ROOM = (120, 160)
QUERY = ((20, 20), (100, 140))

PHASES = {
    "mcl": lambda: cs.phase_mcl(
        particles=512, steps=2, warmup=1, cpu_slice=128, loc_particles=256,
        loc_steps=5, shape=ROOM, pose=(80.0, 60.0, math.pi)),
    "slam": lambda: cs.phase_slam(
        particles=512, steps=6, timed=2, table_box=32, shape=(96, 128)),
    "maze": lambda: cs.phase_maze(
        particles=256, steps=3, edt_box=128, table_box=32, shape=(240, 256)),
    "planners": lambda: cs.phase_planners(
        shape=ROOM, query=QUERY, inflate_r=2, hastar_batch=64,
        rrt_nodes=1024, rrt_batch=64, rrt_rounds=100, n_points=4096,
        n_boxes=16, n_queries=32, max_val=1000, repeats=1),
    "fleet": lambda: cs.phase_fleet(
        robots=4, particles=128, ticks=2, shape=ROOM),
    # The four-device phases, on four of conftest's virtual CPU devices.
    "multi_sharded_slam": lambda: cs.phase_multi_sharded_slam(
        particles=256, steps=2, timed=1, table_box=32, shape=(96, 128)),
    "multi_mapshard": lambda: cs.phase_multi_mapshard(
        particles=256, steps=2, table_box=32, shape=(240, 256)),
    "multi_fleet": lambda: cs.phase_multi_fleet(
        robots=8, particles=64, ticks=2, shape=ROOM),
    "multi_hastar": lambda: cs.phase_multi_hastar(
        queries=8, shape=ROOM, query=QUERY, inflate_r=2, batch=64),
}


@pytest.mark.parametrize("name", list(PHASES))
def test_phase_checks_hold(name):
    rec = PHASES[name]()
    assert rec["phase"] == name
    assert rec["checks"]
    assert [c for c in rec["checks"] if not c["ok"]] == []


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
