"""Map IO: PNG -> occupancy arrays.

Replaces the reference's OpenCV load-and-threshold preambles
(`apps/grid_slam.cpp:79-86`: imread grayscale, threshold at 128 to 0/1 CV_32S;
`apps/hastar_planner.cpp:130-134` and `apps/rrt_planner.cpp`: erode by an
ellipse kernel for vehicle inflation then threshold).
"""

from __future__ import annotations

import numpy as np


def load_grayscale(path) -> np.ndarray:
    """u8[H, W] grayscale image."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def load_binary_map(path, threshold: int = 128) -> np.ndarray:
    """i32[H, W] 0/1 ground-truth map: 1 = free, 0 = obstacle
    (`apps/grid_slam.cpp:84-86` THRESH_BINARY at 128)."""
    g = load_grayscale(path)
    return (g > threshold).astype(np.int32)


def load_prob_map(path, threshold: int = 128) -> np.ndarray:
    """f32[H, W] probability-of-free map, 0.0 or 1.0 after binarization
    (the planners' CV_64F convention, `slam/astar.h:14-17`)."""
    return load_binary_map(path, threshold).astype(np.float32)


def erode(binary: np.ndarray, radius: int) -> np.ndarray:
    """Binary erosion by an ellipse-ish (disc) structuring element — the
    vehicle-inflation step of `apps/hastar_planner.cpp:130-134`. Pure NumPy
    separable implementation (min-filter via shifted mins over the disc)."""
    if radius <= 0:
        return binary.copy()
    out = binary.astype(bool)
    h, w = out.shape
    acc = np.ones_like(out)
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disc = (yy * yy + xx * xx) <= radius * radius
    padded = np.pad(out, radius, constant_values=False)
    for dy, dx in zip(*np.nonzero(disc)):
        acc &= padded[dy : dy + h, dx : dx + w]
    return acc.astype(binary.dtype)
