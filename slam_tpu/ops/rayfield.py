"""Raycast backend dispatch: one map representation, three engines.

  * ``march`` — exact fixed-step DDA (reference semantics oracle,
    `slam/raycast.cpp:8-141`); gather-heavy, best for tests / small batches.
  * ``sdf``  — sphere tracing over a Euclidean distance transform; ~25x fewer
    probes, works when the map changes every step (SLAM mode; the EDT is
    rebuilt gather-free with JFA).
  * ``lut``  — precomputed directional distance table; ONE gather per ray,
    static maps only (localization mode).
  * ``cddt`` — COMPRESSED directional table (obstacle-run intervals + a
    log2(K)-gather binary search per ray); static maps whose dense LUT
    outgrows device memory (slam_tpu.ops.cddt).

`RayField` carries the map plus whichever precomputed structure the backend
needs; `make_ray_field` builds it (host-side, once per static map) and
`dynamic_ray_field` is the jit-friendly per-step rebuild for SLAM.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from slam_tpu.core import struct

from slam_tpu.core.config import RaycastConfig
from slam_tpu.ops import cddt as cddtlib
from slam_tpu.ops import edt as edtlib
from slam_tpu.ops import lut as lutlib
from slam_tpu.ops.raycast import raycast_march, raycast_sdf


@struct.dataclass
class RayField:
    blocked: jax.Array  # bool[H, W]
    edt: Optional[jax.Array] = None  # f32[H, W] (sdf backend)
    # [H, W, P] bins-last table; P >= lut_bins is the STORAGE width. Rows
    # are stored UNPADDED (see lut.padded_bins): converged particles
    # cluster on few cells, where aligned rows can make the hot set
    # collide and the odd 720 B stride spreads them.
    lut: Optional[jax.Array] = None
    # Semantic angular bin count (static: part of the jit cache key).
    lut_bins: Optional[int] = struct.field(pytree_node=False, default=None)
    # Compressed directional table (cddt backend).
    cddt: Optional["cddtlib.CDDTTable"] = None

    @property
    def shape(self):
        return self.blocked.shape


def make_ray_field(
    blocked: jax.Array, rc: RaycastConfig, cache_dir: Optional[str] = None
) -> RayField:
    """Build the backend structure for a static map (host-side, one-off).

    `cache_dir` caches the LUT on disk keyed by (map contents, bins,
    max_dist, dtype) — big-map tables (maze: ~2 GiB, minutes of gather-bound
    rotation resampling) then build once per map ever, not once per run.
    """
    blocked = jnp.asarray(blocked, bool)
    if rc.backend == "march":
        return RayField(blocked=blocked)
    if rc.backend == "sdf":
        return RayField(blocked=blocked, edt=edtlib.edt_exact(blocked))
    if rc.backend == "lut":
        dtype = {"bf16": jnp.bfloat16, "u8": jnp.uint8}[rc.lut_dtype]
        path = None
        if cache_dir is not None:
            import hashlib
            import os

            import numpy as np

            host = np.asarray(blocked)
            key = hashlib.sha1(
                host.tobytes()
                # v2: the quad build changed derived-axis-bin values
                # (blocked-origin fix) — v1 tables must not be reused.
                + f"{host.shape}|{rc.lut_bins}|{rc.max_dist}|{rc.lut_dtype}|v2".encode()
            ).hexdigest()[:16]
            os.makedirs(cache_dir, exist_ok=True)
            path = os.path.join(cache_dir, f"beam_lut_{key}.npy")
            if os.path.exists(path):
                lut_np = np.load(path)
                lut = jnp.asarray(
                    lut_np.view(jnp.bfloat16)
                    if rc.lut_dtype == "bf16"
                    else lut_np
                )
                return RayField(blocked=blocked, lut=lut, lut_bins=rc.lut_bins)
        lut = lutlib.build_beam_lut(
            blocked, n_bins=rc.lut_bins, max_dist=rc.max_dist, dtype=dtype
        )
        if path is not None:
            import numpy as np

            host_lut = np.asarray(jax.device_get(lut))
            if host_lut.dtype == jnp.bfloat16:
                host_lut = host_lut.view(np.uint16)
            np.save(path, host_lut)
        return RayField(blocked=blocked, lut=lut, lut_bins=rc.lut_bins)
    if rc.backend == "cddt":
        path = None
        table = None
        if cache_dir is not None:
            import hashlib
            import os

            import numpy as np

            host = np.asarray(blocked)
            key = hashlib.sha1(
                host.tobytes()
                + f"{host.shape}|{rc.lut_bins}|{rc.cddt_k}|cddt-v1".encode()
            ).hexdigest()[:16]
            os.makedirs(cache_dir, exist_ok=True)
            path = os.path.join(cache_dir, f"cddt_{key}.npz")
            if os.path.exists(path):
                z = np.load(path)
                table = cddtlib.CDDTTable(
                    starts=jnp.asarray(z["starts"]),
                    ends=jnp.asarray(z["ends"]),
                    n_bins=rc.lut_bins,
                    n_overflow=int(z["n_overflow"]),
                )
        fresh = table is None
        if fresh:
            table = cddtlib.build_cddt(blocked, n_bins=rc.lut_bins, k=rc.cddt_k)
        if table.n_overflow:
            # Warn on cache hits too — a truncated table is wrong every run.
            from slam_tpu.utils.logging import get_logger

            get_logger().warning(
                "cddt table dropped %d runs (cddt_k=%s too small); far "
                "obstacles may read as misses",
                table.n_overflow,
                rc.cddt_k,
            )
        if fresh and path is not None:
            import numpy as np

            np.savez(
                path,
                starts=np.asarray(jax.device_get(table.starts)),
                ends=np.asarray(jax.device_get(table.ends)),
                n_overflow=table.n_overflow,
            )
        return RayField(blocked=blocked, cddt=table)
    raise ValueError(f"unknown raycast backend: {rc.backend}")


def dynamic_ray_field(blocked: jax.Array, rc: RaycastConfig) -> RayField:
    """Jittable rebuild for maps that change every step (SLAM mode).

    The sdf backend uses the gather-free JFA transform; lut is rejected (its
    build cost only amortizes over static maps).
    """
    if rc.backend == "march":
        return RayField(blocked=blocked)
    if rc.backend == "sdf":
        return RayField(blocked=blocked, edt=edtlib.edt_jfa(blocked))
    raise ValueError(
        f"backend {rc.backend!r} cannot be rebuilt per-step; use 'sdf' or "
        "'march' for SLAM mode"
    )


def raycast_field(field: RayField, x, y, theta, rc: RaycastConfig):
    """(dist, hit) for a ray batch via the configured backend."""
    if rc.backend == "march":
        return raycast_march(
            field.blocked,
            x,
            y,
            theta,
            step=rc.step,
            max_dist=rc.max_dist,
            chunk=rc.chunk,
        )
    if rc.backend == "sdf":
        if field.edt is None:
            raise ValueError("sdf backend needs field.edt")
        return raycast_sdf(
            field.edt,
            x,
            y,
            theta,
            step=rc.step,
            max_dist=rc.max_dist,
            margin=rc.sdf_margin,
        )
    if rc.backend == "lut":
        if field.lut is None:
            raise ValueError("lut backend needs field.lut")
        return lutlib.raycast_lut(
            field.lut, x, y, theta, max_dist=rc.max_dist,
            n_bins=field.lut_bins,
        )
    if rc.backend == "cddt":
        if field.cddt is None:
            raise ValueError("cddt backend needs field.cddt")
        return cddtlib.raycast_cddt(
            field.cddt, x, y, theta, max_dist=rc.max_dist,
            shape=field.blocked.shape,
        )
    raise ValueError(f"unknown raycast backend: {rc.backend}")


def as_ray_field(field_or_blocked, rc: RaycastConfig) -> RayField:
    """Accept either a prebuilt RayField or a raw blocked mask (jit-safe:
    builds dynamically when given a raw mask)."""
    if isinstance(field_or_blocked, RayField):
        return field_or_blocked
    return dynamic_ray_field(jnp.asarray(field_or_blocked, bool), rc)
