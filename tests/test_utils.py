"""Checkpoint round-trip, logging, rendering, and profiling utils tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from slam_tpu.core.config import MapConfig, MCLConfig, SLAMConfig
from slam_tpu.core.types import Pose
from slam_tpu.models import slam as slam_mod
from slam_tpu.utils import checkpoint, render
from slam_tpu.utils.logging import add_file_sink, get_logger, set_level


def test_checkpoint_roundtrip_slam_state(tmp_path):
    cfg = SLAMConfig(mcl=MCLConfig(n_particles=32), map=MapConfig(height=32, width=32))
    state = slam_mod.init(jax.random.key(7), cfg, Pose.create(16.0, 16.0, 0.5))
    state = state.replace(grid=state.grid.at[3, 4].set(1.5))

    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state)
    template = slam_mod.init(jax.random.key(0), cfg, Pose.create(0.0, 0.0, 0.0))
    restored = checkpoint.restore(path, template)

    np.testing.assert_array_equal(np.asarray(restored.grid), np.asarray(state.grid))
    np.testing.assert_array_equal(
        np.asarray(restored.mcl.particles.pose.x),
        np.asarray(state.mcl.particles.pose.x),
    )
    # The PRNG key round-trips usably.
    k1 = jax.random.uniform(restored.mcl.key)
    k2 = jax.random.uniform(state.mcl.key)
    assert float(k1) == float(k2)


def test_checkpoint_manager_rolls(tmp_path):
    cfg = SLAMConfig(mcl=MCLConfig(n_particles=8), map=MapConfig(height=16, width=16))
    state = slam_mod.init(jax.random.key(0), cfg, Pose.create(8.0, 8.0, 0.0))
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    for step in range(3):
        mgr.save(step, state.replace(grid=state.grid + step))
    assert mgr.latest_step() == 2
    restored = mgr.restore(state)
    assert float(restored.grid[0, 0]) == 2.0
    mgr.close()


def test_logger_file_sink(tmp_path):
    log = get_logger("slam_tpu.test")
    set_level(10, "slam_tpu.test")
    sink = str(tmp_path / "log.txt")
    add_file_sink(sink, name="slam_tpu.test")
    log.info("hello %d", 42)
    for h in log.handlers:
        h.flush()
    assert "hello 42" in open(sink).read()


def test_render_primitives(tmp_path):
    img = render.blocked_to_rgb(np.zeros((32, 32), bool))
    render.draw_disc(img, 5, 5, 2, render.RED)
    render.draw_line(img, 0, 0, 31, 31, render.BLUE)
    render.draw_pose(img, 16.0, 16.0, 0.5, render.GREEN)
    render.draw_particles(img, np.array([3.0, 4.0]), np.array([3.0, 4.0]))
    assert (img != 255).any()
    p = str(tmp_path / "x.png")
    render.save_png(img, p)
    render.save_gif([img, img], str(tmp_path / "x.gif"))
    assert os.path.getsize(p) > 0


def test_diagnostics_and_recovery():
    import jax.numpy as jnp

    from slam_tpu.core.types import Pose as P
    from slam_tpu.models import mcl as mcl_mod
    from slam_tpu.models.simulate import synthetic_room
    from slam_tpu.utils import diagnostics

    blocked = jnp.asarray(synthetic_room(64, 64))
    state = mcl_mod.init(jax.random.key(0), 128, P.create(32.0, 32.0, 0.0))
    h = diagnostics.filter_health(state)
    assert abs(float(h["ess_frac"]) - 1.0) < 1e-5  # uniform weights
    assert not bool(h["any_nan"])
    assert not diagnostics.needs_recovery(h)

    # Degenerate weights -> recovery trigger; recovery restores health.
    lw = jnp.full((128,), -100.0).at[0].set(0.0)
    bad = state.replace(particles=state.particles.replace(log_weight=lw))
    hb = diagnostics.filter_health(bad)
    assert float(hb["ess_frac"]) < 0.02
    assert diagnostics.needs_recovery(hb)

    rec = diagnostics.recover(jax.random.key(1), bad, blocked)
    hr = diagnostics.filter_health(rec)
    assert abs(float(hr["ess_frac"]) - 1.0) < 1e-5
    assert float(hr["spread_x"]) > 5.0  # spread over the map

    # NaN detection.
    nan_state = state.replace(
        particles=state.particles.replace(
            pose=state.particles.pose.replace(x=state.particles.pose.x.at[3].set(jnp.nan))
        )
    )
    assert bool(diagnostics.filter_health(nan_state)["any_nan"])


def test_checkpoint_migrates_old_format(tmp_path):
    """Round-5: restoring a pre-round-3-shaped checkpoint (no est_pose, no
    mode_pose, no updates counter, no adaptive EMAs) FILLS the missing
    fields with documented defaults instead of raising — est_pose and
    mode_pose from the saved best particle, updates from the saved frame
    counter, EMAs from the NaN warm-start sentinel."""
    from slam_tpu.core import struct

    from slam_tpu.core.types import Particles

    @struct.dataclass
    class OldMCLState:  # the round-2 state shape
        particles: object
        key: object
        best_pose: object
        step: object

    @struct.dataclass
    class OldSLAMState:
        mcl: OldMCLState
        grid: object

    cfg = SLAMConfig(mcl=MCLConfig(n_particles=8), map=MapConfig(height=16, width=16))
    pose = Pose.create(8.0, 8.0, 0.5)
    best = Pose.create(9.0, 7.0, 0.25)
    old = OldSLAMState(
        mcl=OldMCLState(
            particles=Particles.uniform_at(pose, 8),
            key=jax.random.key(7),
            best_pose=best,
            step=jnp.int32(42),
        ),
        grid=jnp.full((16, 16), 0.75),
    )
    path = str(tmp_path / "old_ckpt")
    checkpoint.save(path, old)

    template = slam_mod.init(jax.random.key(0), cfg, Pose.create(0.0, 0.0, 0.0))
    restored = checkpoint.restore(path, template)

    np.testing.assert_array_equal(np.asarray(restored.grid), np.asarray(old.grid))
    for leaf, src in (
        (restored.est_pose.x, 9.0),
        (restored.est_pose.theta, 0.25),
        (restored.mcl.mode_pose.y, 7.0),
    ):
        assert float(leaf) == src
    assert int(restored.mcl.updates) == 42
    assert int(restored.mcl.step) == 42
    assert bool(jnp.isnan(restored.mcl.log_w_slow))
    assert bool(jnp.isnan(restored.mcl.log_w_fast))
    # The PRNG key round-trips usably.
    assert float(jax.random.uniform(restored.mcl.key)) == float(
        jax.random.uniform(old.mcl.key)
    )
    # ...and the migrated state RESUMES: one SLAM step runs.
    from slam_tpu.core.types import Odometry
    from slam_tpu.models import fake_lidar

    blocked = jnp.zeros((16, 16), bool).at[2, :].set(True)
    scan = fake_lidar.scan(blocked, pose, cfg.lidar, cfg.raycast)
    out = slam_mod.step(restored, Odometry.create(0.0, 0.5, 0.0), scan, cfg)
    assert int(out.mcl.updates) == 43


def test_checkpoint_migration_rejects_real_mismatch(tmp_path):
    """A shape mismatch (different particle count) is a config error, not a
    format change — migration must refuse with an actionable message."""
    import pytest

    cfg8 = SLAMConfig(mcl=MCLConfig(n_particles=8), map=MapConfig(height=16, width=16))
    cfg16 = SLAMConfig(mcl=MCLConfig(n_particles=16), map=MapConfig(height=16, width=16))
    state = slam_mod.init(jax.random.key(0), cfg8, Pose.create(8.0, 8.0, 0.0))
    path = str(tmp_path / "ck")
    checkpoint.save(path, state)
    template = slam_mod.init(jax.random.key(0), cfg16, Pose.create(0.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="particle count|shape"):
        checkpoint.restore(path, template)


def test_checkpoint_manager_migrates_old_format(tmp_path):
    """CheckpointManager.restore migrates old formats the same way."""
    from slam_tpu.core import struct

    from slam_tpu.core.types import Particles

    @struct.dataclass
    class OldMCLState:
        particles: object
        key: object
        best_pose: object
        step: object

    @struct.dataclass
    class OldSLAMState:
        mcl: OldMCLState
        grid: object

    cfg = SLAMConfig(mcl=MCLConfig(n_particles=8), map=MapConfig(height=16, width=16))
    pose = Pose.create(8.0, 8.0, 0.5)
    old = OldSLAMState(
        mcl=OldMCLState(
            particles=Particles.uniform_at(pose, 8),
            key=jax.random.key(3),
            best_pose=pose,
            step=jnp.int32(5),
        ),
        grid=jnp.zeros((16, 16)),
    )
    mgr = checkpoint.CheckpointManager(str(tmp_path / "run"))
    mgr.save(0, old)
    mgr.close()

    mgr2 = checkpoint.CheckpointManager(str(tmp_path / "run"))
    template = slam_mod.init(jax.random.key(0), cfg, Pose.create(0.0, 0.0, 0.0))
    restored = mgr2.restore(template)
    assert int(restored.mcl.updates) == 5
    assert float(restored.est_pose.x) == 8.0
    mgr2.close()
