"""Two-view midpoint triangulation (map initialisation for BA windows).

The port of ``pislam_tpu/backend/triangulate.py``.
"""

from __future__ import annotations

import torch


def triangulate_two_view(R1, t1, R2, t2, p1, p2):
    """Batched midpoint triangulation of normalised correspondences.

    Poses are world->cam. Returns (N, 3) world points. Uses the relative
    pose (R, t): X_c2 = R X_c1 + t, solves the depth along ray 1 in closed
    form (as geometry.epipolar.triangulate_depths), then lifts to world
    through camera 1.
    """
    R1t = R1.transpose(-1, -2)
    R = R2 @ R1t
    t = t2 - (R @ t1[..., None])[..., 0]

    d1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    d2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    rd1 = d1 @ R.transpose(-1, -2)
    c_rd1 = torch.linalg.cross(d2, rd1)
    c_t = torch.linalg.cross(d2, torch.broadcast_to(t, d2.shape))
    s = -torch.sum(c_rd1 * c_t, -1) / torch.clamp(torch.sum(c_rd1 * c_rd1, -1), min=1e-12)
    x_c1 = s[..., None] * d1
    return (x_c1 - t1) @ R1  # R1^T (x_c1 - t1): cam1 -> world
