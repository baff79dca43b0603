"""Device-mesh construction for the particle/beam parallel axes.

The reference's only parallelism is a pthread fan-out over contiguous
particle ranges plus core-pinned map-copy threads (`slam/mcl.cpp:108-144,
205-227`). The equivalent here is a `jax.sharding.Mesh` with two axes:

  * ``'p'`` — the particle axis (the data-parallel axis; scales N).
  * ``'b'`` — the beam axis (splits each particle's scan across devices; the
    per-particle log-weight reduction becomes a psum over 'b').

The GPUs of one host are joined all to all by NVLink, so within a host the
mesh shape follows the algorithm alone. Across hosts the 'p' axis should
span hosts and 'b' should stay within a host, so the per-update beam
reduction rides NVLink; `make_mesh` orders the axes that way.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None,
    beam_axis: int = 1,
    axis_names: Tuple[str, str] = ("p", "b"),
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a 2D ('p', 'b') mesh over the first `n_devices` devices.

    `beam_axis` devices are dedicated to splitting beams (1 = pure particle
    data-parallelism); the rest shard particles.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % beam_axis != 0:
        raise ValueError(
            f"n_devices={n_devices} not divisible by beam_axis={beam_axis}"
        )
    grid = np.asarray(devices[:n_devices]).reshape(
        n_devices // beam_axis, beam_axis
    )
    return Mesh(grid, axis_names)
