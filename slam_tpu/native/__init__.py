"""ctypes bindings for the native host runtime (native/slam_native.cpp).

The reference's runtime is C++ (pthread fan-outs, scalar DDA raycast,
OpenCV preambles); here the accelerator owns the compute path and these native
pieces serve the host side: exact-semantics raycast oracle / sensor
simulation off-device, disc erosion for vehicle inflation, and a threaded
scan prefetcher. Everything degrades gracefully to pure-Python/JAX when the
shared library has not been built (`native/build.sh`).
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Iterable, Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".build", "libslam_native.so"),
]

_lib = None
for _p in _LIB_PATHS:
    if os.path.exists(_p):
        try:
            _lib = ctypes.CDLL(_p)
            break
        except OSError:
            pass

if _lib is not None:
    _u8p = ctypes.POINTER(ctypes.c_uint8)
    _f32p = ctypes.POINTER(ctypes.c_float)
    _lib.rc_raycast_batch.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
        ctypes.c_long, ctypes.c_float, ctypes.c_float, _f32p, _u8p,
    ]
    _lib.rc_scan_poses.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, _f32p, _f32p, _f32p,
        ctypes.c_long, _f32p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        _f32p, _u8p,
    ]
    _lib.em_erode_disc.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
    ]
    _lib.rc_hardware_threads.restype = ctypes.c_int


def available() -> bool:
    return _lib is not None


def _as_c(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def raycast_batch(blocked, x, y, theta, step=0.5, max_dist=500.0):
    """Exact reference-semantics DDA raycast (`slam/raycast.cpp:8-51`) on
    host threads. Returns (dist f32[n], hit bool[n])."""
    blocked = np.ascontiguousarray(blocked, np.uint8)
    h, w = blocked.shape
    x = np.ascontiguousarray(x, np.float32).ravel()
    y = np.ascontiguousarray(y, np.float32).ravel()
    theta = np.ascontiguousarray(theta, np.float32).ravel()
    n = x.size
    dist = np.empty(n, np.float32)
    hit = np.empty(n, np.uint8)
    if _lib is None:
        for k in range(n):  # pure-python fallback (slow; tests only)
            dist[k], hit[k] = _py_raycast(blocked, h, w, x[k], y[k], theta[k], step, max_dist)
    else:
        _lib.rc_raycast_batch(
            _as_c(blocked, ctypes.c_uint8), h, w,
            _as_c(x, ctypes.c_float), _as_c(y, ctypes.c_float),
            _as_c(theta, ctypes.c_float), n, step, max_dist,
            _as_c(dist, ctypes.c_float), _as_c(hit, ctypes.c_uint8),
        )
    return dist, hit.astype(bool)


def scan_poses(blocked, px, py, ptheta, beam_angles, step=0.5, max_dist=500.0):
    """Simulate a lidar over a trajectory: returns (dist f32[T, B],
    hit bool[T, B])."""
    blocked = np.ascontiguousarray(blocked, np.uint8)
    h, w = blocked.shape
    px = np.ascontiguousarray(px, np.float32).ravel()
    py = np.ascontiguousarray(py, np.float32).ravel()
    pt = np.ascontiguousarray(ptheta, np.float32).ravel()
    ba = np.ascontiguousarray(beam_angles, np.float32).ravel()
    t, b = px.size, ba.size
    dist = np.empty(t * b, np.float32)
    hit = np.empty(t * b, np.uint8)
    if _lib is None:
        for k in range(t * b):
            dist[k], hit[k] = _py_raycast(
                blocked, h, w, px[k // b], py[k // b], pt[k // b] + ba[k % b],
                step, max_dist,
            )
    else:
        _lib.rc_scan_poses(
            _as_c(blocked, ctypes.c_uint8), h, w,
            _as_c(px, ctypes.c_float), _as_c(py, ctypes.c_float),
            _as_c(pt, ctypes.c_float), t, _as_c(ba, ctypes.c_float), b,
            step, max_dist,
            _as_c(dist, ctypes.c_float), _as_c(hit, ctypes.c_uint8),
        )
    return dist.reshape(t, b), hit.reshape(t, b).astype(bool)


def erode_disc(binary, radius: int):
    """Binary disc erosion (vehicle inflation). binary: any int/bool [H, W];
    returns same dtype."""
    arr = np.ascontiguousarray(binary.astype(np.uint8))
    h, w = arr.shape
    out = np.empty_like(arr)
    if _lib is None:
        from slam_tpu.utils.maps import erode

        return erode(binary, radius)
    _lib.em_erode_disc(
        _as_c(arr, ctypes.c_uint8), h, w, radius, _as_c(out, ctypes.c_uint8)
    )
    return out.astype(binary.dtype)


def _py_raycast(blocked, h, w, x, y, theta, step, max_dist):
    # p_k = origin + k*step*dir (NOT additive accumulation) so positions
    # match raycast_one in native/slam_native.cpp and the vectorized
    # backends bit-for-bit on long rays (ADVICE r1).
    dx = np.float32(np.cos(theta) * step)
    dy = np.float32(np.sin(theta) * step)
    x0, y0 = np.float32(x), np.float32(y)
    prev = int(np.floor(h - y0 - 1.0)) * w + int(np.floor(x0))
    step32 = np.float32(step)
    k = 0
    while True:
        k += 1
        d = float(step32 * np.float32(k))
        if d >= max_dist:
            return max_dist, 0
        px = np.float32(x0 + dx * k)
        py = np.float32(y0 + dy * k)
        i = int(np.floor(h - py - 1.0))
        j = int(np.floor(px))
        if not (0 <= i < h and 0 <= j < w):
            return max_dist, 0
        cell = i * w + j
        if cell == prev:
            continue
        prev = cell
        if blocked[i, j]:
            return d, 1


class ScanPrefetcher:
    """Threaded sensor-feed: simulates scans for upcoming poses on host
    threads while the device crunches the current step (the reference's
    runtime role of feeding MCL from FakeLidar, made asynchronous)."""

    def __init__(self, blocked, beam_angles, step=0.5, max_dist=500.0, depth=4):
        self._blocked = np.ascontiguousarray(blocked, np.uint8)
        self._angles = np.asarray(beam_angles, np.float32)
        self._step = step
        self._max_dist = max_dist
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._in: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, x: float, y: float, theta: float) -> None:
        self._in.put((x, y, theta))

    def get(self):
        """(dist f32[B], hit bool[B]) for the oldest submitted pose."""
        return self._q.get()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                break
            x, y, theta = item
            d, hh = scan_poses(
                self._blocked, [x], [y], [theta], self._angles,
                self._step, self._max_dist,
            )
            self._q.put((d[0], hh[0]))

    def close(self):
        self._in.put(None)
