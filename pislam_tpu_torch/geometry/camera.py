"""Lens distortion on the normalised image plane (OpenCV convention).

The port of ``pislam_tpu/geometry/camera.py``. Model (``k1, k2, p1, p2``),
applied to normalised coords x = X/Z:

    r2 = x^2 + y^2,  radial = 1 + k1 r2 + k2 r2^2
    x_d = x * radial + 2 p1 x y + p2 (r2 + 2 x^2)
    y_d = y * radial + p1 (r2 + 2 y^2) + 2 p2 x y

``undistort_normalised`` inverts it with a fixed-count fixed-point
iteration: 5 iterations recover TUM-class distortion to < 1e-6 plane units.
"""

from __future__ import annotations

import torch


def distort_normalised(pts, k1: float, k2: float = 0.0,
                       p1: float = 0.0, p2: float = 0.0):
    """(N, 2) ideal normalised coords -> distorted normalised coords."""
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalised(pts, k1: float, k2: float = 0.0,
                         p1: float = 0.0, p2: float = 0.0,
                         iters: int = 5):
    """(N, 2) distorted normalised coords -> ideal normalised coords.

    Fixed-point: start at the distorted point, repeatedly divide out the
    radial factor and subtract the tangential term evaluated at the
    current estimate.
    """
    xd, yd = pts[..., 0], pts[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)
