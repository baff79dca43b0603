"""Real multi-process `jax.distributed` test.

Launches 2 separate CPU processes (gloo collectives, 4 virtual devices
each -> an 8-device global mesh spanning a process boundary, the moral
equivalent of a 2-host cluster) running tests/distributed_worker.py:
distributed.initialize + host_local_slice + broadcast + a cross-process
ShardedMCL step numerically checked against the single-device path.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mcl_step(tmp_path):
    num_processes = 2
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    # The parent test session may hold backend state; workers are clean.
    env.pop("JAX_PLATFORM_NAME", None)

    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    procs = []
    logs = []
    for pid in range(num_processes):
        log = open(tmp_path / f"worker{pid}.log", "w+")
        logs.append(log)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    worker,
                    "--coordinator",
                    f"127.0.0.1:{port}",
                    "--num-processes",
                    str(num_processes),
                    "--process-id",
                    str(pid),
                ],
                env=env,
                stdout=log,
                stderr=subprocess.STDOUT,
            )
        )

    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    outputs = []
    for pid, log in enumerate(logs):
        log.seek(0)
        outputs.append(log.read())
        log.close()
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"RESULT-OK {pid}" in out, f"worker {pid} no OK:\n{out}"
