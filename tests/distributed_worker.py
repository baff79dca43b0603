"""Worker program for the real multi-process `jax.distributed` test.

Launched by tests/test_distributed.py as N separate CPU processes (gloo
collectives), each owning `--local-devices` virtual CPU devices, so the
global mesh spans processes the way a multi-host cluster spans hosts. Exercises:

  * `slam_tpu.parallel.distributed.initialize` with explicit coordinator
    (the manual-cluster path, `parallel/distributed.py:24-39`),
  * `host_local_slice` process topology,
  * `replicate_to_all_hosts` (broadcast from process 0),
  * a cross-process ShardedMCL predict+update step (GSPMD collectives over
    the process boundary), numerically checked on every process against the
    single-device reference path computed locally.

Prints "RESULT-OK <process_id>" on success; any assertion/exception makes
the parent test fail on a nonzero exit.
"""

import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from slam_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from slam_tpu.core.config import LidarConfig, MCLConfig, RaycastConfig
    from slam_tpu.core.types import Odometry, Pose
    from slam_tpu.models import fake_lidar, mcl as mcl_mod
    from slam_tpu.models.simulate import synthetic_room
    from slam_tpu.parallel import make_mesh, sharded

    n_devices = args.num_processes * args.local_devices
    assert jax.process_count() == args.num_processes, jax.process_count()
    assert len(jax.devices()) == n_devices, jax.devices()
    assert distributed.is_multihost() == (args.num_processes > 1)

    n = 64
    sl = distributed.host_local_slice(n)
    per = n // args.num_processes
    assert sl == slice(args.process_id * per, (args.process_id + 1) * per), sl

    # Broadcast: every process must end up with process 0's value.
    probe = jnp.asarray([args.process_id * 100.0, 7.0])
    out = distributed.replicate_to_all_hosts({"probe": probe})
    np.testing.assert_array_equal(np.asarray(out["probe"]), [0.0, 7.0])

    # --- Cross-process sharded MCL step vs local single-device reference ---
    h = w = 64
    blocked = jnp.asarray(synthetic_room(h, w))
    pose = Pose.create(w / 2.0, h / 2.0, np.pi / 2)
    lidar = LidarConfig(n_rays=16, max_dist=100.0)
    rc = RaycastConfig(max_dist=100.0, chunk=32)
    scan = fake_lidar.scan(blocked, pose, lidar, rc)
    cfg = MCLConfig(n_particles=n, ess_threshold=0.0)  # no resample: exact cmp
    odom = Odometry.create(0.1, 2.0, 0.1)
    alphas = jnp.asarray((1e-3, 1e-3, 1e-3, 1e-3))

    # Single-device reference, computed process-locally. Raw uint32 keys
    # (not typed key arrays) so every leaf survives np.asarray below.
    st0 = mcl_mod.init(jax.random.PRNGKey(0), n, pose)
    ref = mcl_mod.predict(st0, odom, alphas)
    ref = mcl_mod.update(ref, scan, blocked, cfg, rc)

    # Global mesh spanning both processes; state placed shard-by-shard (a
    # multiprocess device_put of host data to non-addressable devices is
    # not allowed, so feed each addressable shard from the local replica).
    mesh = make_mesh(n_devices, beam_axis=1)
    shardings = sharded.state_shardings(st0, mesh, n)

    def to_global(local, shard):
        arr = np.asarray(local)
        return jax.make_array_from_callback(
            arr.shape, shard, lambda idx: arr[idx]
        )

    st = jax.tree.map(to_global, st0, shardings)

    rs = sharded.ray_sharding(mesh)
    step = jax.jit(
        lambda s, scan, blocked: mcl_mod.update(
            mcl_mod.predict(s, odom, alphas), scan, blocked, cfg, rc,
            ray_sharding=rs,
        )
    )
    out_state = step(st, scan, blocked)

    # Every process sees the full result via allgather; must match the
    # local reference bit-for-bit up to f32 collective reduction order.
    got_x = multihost_utils.process_allgather(
        out_state.particles.pose.x, tiled=True
    )
    got_lw = multihost_utils.process_allgather(
        out_state.particles.log_weight, tiled=True
    )
    np.testing.assert_allclose(got_x, np.asarray(ref.particles.pose.x), rtol=1e-5)
    np.testing.assert_allclose(
        got_lw, np.asarray(ref.particles.log_weight), rtol=1e-4, atol=1e-4
    )

    # The particle axis really is sharded across processes: this process
    # addresses only its slice of the global array.
    local_rows = sum(
        s.data.shape[0] for s in out_state.particles.pose.x.addressable_shards
    )
    assert local_rows == n // args.num_processes, local_rows

    # --- Cross-process FULL SLAM step ------------------------------------
    # The complete ShardedGridSLAM step — boxed-table measurement (psum
    # window stats over 'p'), reduce-scatter resampler, shared-map update
    # — across the 2-process gloo boundary, vs the single-device engine.
    import dataclasses as dc

    from slam_tpu.core.config import MapConfig, MotionConfig, SLAMConfig
    from slam_tpu.models import slam as slam_mod
    from slam_tpu.parallel import ShardedGridSLAM
    from slam_tpu.parallel.mapshard import MapShardedGridSLAM, grid_sharding

    def slam_cfg(measurement, box, hh):
        return SLAMConfig(
            mcl=MCLConfig(
                n_particles=n,
                meas_stddev=3.0,
                measurement=measurement,
                lf_table_box=box,
            ),
            map=MapConfig(height=hh, width=hh),
            lidar=LidarConfig(n_rays=16, max_dist=60.0),
            motion=MotionConfig(alphas=(1e-3,) * 4),
            raycast=RaycastConfig(
                step=1.0, max_dist=60.0, chunk=16, backend="sdf"
            ),
        )

    def run_cross_process_slam(engine_cls, mesh_, cfg_, grid_spec=None):
        hh = cfg_.map.height
        room = jnp.asarray(synthetic_room(hh, hh))
        p0 = Pose.create(hh / 2.0, hh / 2.0, np.pi / 2)
        z = fake_lidar.scan(room, p0, cfg_.lidar, cfg_.raycast)
        od = Odometry.create(0.05, 1.5, 0.05)

        # Single-device reference, computed process-locally.
        ref_st = slam_mod.init(jax.random.PRNGKey(0), cfg_, p0)
        for _ in range(2):
            ref_st = slam_mod.step(ref_st, od, z, cfg_)

        engine = engine_cls(mesh_, cfg_)
        st0 = slam_mod.init(jax.random.PRNGKey(0), cfg_, p0)
        shardings = sharded.state_shardings(st0, mesh_, n)
        if grid_spec is not None:
            shardings = shardings.replace(grid=grid_spec)
        gst = jax.tree.map(to_global, st0, shardings)
        for _ in range(2):
            gst = engine.step(gst, od, z)

        # The grid's output sharding is compiler-chosen (may be sharded
        # over either axis), so compare it by a jitted GLOBAL reduction
        # against the replicated local reference — the collectives of the
        # comparison itself cross the process boundary too.
        ref_grid = np.asarray(ref_st.grid)
        grid_err = float(
            jax.jit(lambda g: jnp.max(jnp.abs(g - jnp.asarray(ref_grid))))(
                gst.grid
            )
        )
        assert grid_err <= 1e-5, f"grid mismatch: max abs err {grid_err}"
        got_x = multihost_utils.process_allgather(
            gst.mcl.particles.pose.x, tiled=True
        )
        got_lw = multihost_utils.process_allgather(
            gst.mcl.particles.log_weight, tiled=True
        )
        np.testing.assert_allclose(
            got_x, np.asarray(ref_st.mcl.particles.pose.x), rtol=1e-4
        )
        np.testing.assert_allclose(
            got_lw,
            np.asarray(ref_st.mcl.particles.log_weight),
            rtol=1e-4,
            atol=1e-4,
        )

    # Particle-sharded engine: boxed table + the reduce-scatter resampler
    # (mesh 'p' spans both processes).
    run_cross_process_slam(
        ShardedGridSLAM,
        mesh,
        slam_cfg("likelihood_field_table", 24, 64),
    )

    # Map-block-sharded engine: the grid itself (and its distributed JFA
    # halo exchanges + window psums) crosses the process boundary. 'b'=2
    # splits the 128-row map into 64-row blocks (>= the capped transform's
    # C+1 = 18-row halo at cap 17).
    mesh2 = make_mesh(n_devices, beam_axis=2)
    cfg2 = slam_cfg("likelihood_field_table", 24, 128)
    run_cross_process_slam(
        MapShardedGridSLAM,
        mesh2,
        cfg2,
        grid_spec=grid_sharding(mesh2),
    )

    print(f"RESULT-OK {args.process_id}", flush=True)


if __name__ == "__main__":
    main()
