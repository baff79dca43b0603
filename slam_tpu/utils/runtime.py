"""Process set-up shared by every entry point: compile cache and device.

Call `enable_compile_cache()` before the first compilation and
`require_gpu(allow_cpu)` before the first device use, from ``main`` (never
at import time: tests and workers import these modules).
"""

from __future__ import annotations

import os
import pathlib
import sys

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``
    (a fixed path: the path is part of the cache key, so it must not move
    between runs)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache"
    )


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compile cache on the GPU; return its
    directory (None on the CPU, whose cached programs are tied to the
    host's instruction set and are cheap to rebuild).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here. Small programs (the planners' per-round
    kernels) compile in well under a second, so the minimum compile time
    for an entry is dropped to zero.
    """
    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def device_info() -> dict:
    """The device results ran on, as JAX reports it."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def require_gpu(allow_cpu: bool) -> dict:
    """Pin the backend for an entry point and return `device_info()`.

    ``allow_cpu`` (the ``--cpu`` flag) selects the CPU backend for a
    functional check. Otherwise a backend other than ``gpu`` exits non-zero:
    JAX silently falls back to the CPU when it finds no GPU, and a number
    taken there must never pass for a device measurement.
    """
    if allow_cpu:
        jax.config.update("jax_platforms", "cpu")
        return device_info()
    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(
            f"error: no GPU found (JAX backend is {backend!r}); pass --cpu "
            "for a functional check on the CPU"
        )
    return device_info()
