"""Intensity-centroid orientation: disc moments + discretised atan2.

The port of ``pislam_tpu/ops/orientation.py`` (reference Orb.h:80-387). The
moments m10 = sum(x*I), m01 = sum(y*I) over the radius-15 disc are exact
integer sums; ``atan2_bins`` turns them into a bin in [0, 30) with the
reference's 2-term polynomial, evaluated one float32 operation at a time
(every torch op rounds on its own: there is no FMA contraction to move a
bin). Pixel (dx, dy) is in the disc iff |dy| <= VMAX[|dx|].
"""

from __future__ import annotations

import numpy as np
import torch

from .patches import RADIUS, remap_weights_packed

# Max |dy| per |dx|; decoded from Orb.h:117-121 + strip row layout.
VMAX = np.array([15, 15, 15, 15, 15, 15, 14, 14, 13, 13, 12, 11, 10, 9, 7, 5])


def disc_mask() -> np.ndarray:
    """(31, 31) bool: the reference's exact sampling disc."""
    d = np.arange(-RADIUS, RADIUS + 1)
    dx = d[None, :]
    dy = d[:, None]
    return np.abs(dy) <= VMAX[np.clip(np.abs(dx), 0, 15)]


def _moment_weights() -> np.ndarray:
    """(961, 2) float32 weight matrix [x*disc, y*disc]."""
    d = np.arange(-RADIUS, RADIUS + 1)
    m = disc_mask()
    wx = (m * d[None, :]).astype(np.float32)
    wy = (m * d[:, None]).astype(np.float32)
    return np.stack([wx.reshape(-1), wy.reshape(-1)], axis=1)


MOMENT_WEIGHTS = _moment_weights()


def packed_moment_weights() -> np.ndarray:
    """(1024, 2) int8 moment weights over the packed window layout."""
    return remap_weights_packed(MOMENT_WEIGHTS.astype(np.int8))


def centroids_packed(flat, mom_w=None):
    """(K, 1024) packed int8 windows -> (K,) m10, (K,) m01 int32 (exact).

    ``mom_w``: the (1024, 2) packed weights as a tensor, built when None.
    """
    if mom_w is None:
        mom_w = torch.as_tensor(packed_moment_weights(), device=flat.device)
    w = mom_w.to(torch.int32)
    f = flat.to(torch.int32)
    m10 = (f * w[:, 0]).sum(dim=1, dtype=torch.int32)
    m01 = (f * w[:, 1]).sum(dim=1, dtype=torch.int32)
    return m10, m01


# Polynomial constants, pre-scaled by 60/pi and 256 (Orb.h:333-348).
_C0 = np.float32(256 * 14.999998)
_C1 = np.float32(256 * 4.723436)
_C2 = np.float32(256 * 1.266240)


def atan2_bins(m10, m01):
    """(K,) int32 moments -> (K,) uint8 angle bin in [0, 30) (Orb.h:310-387)."""
    x, y = m10.to(torch.int32), m01.to(torch.int32)
    xf = x.to(torch.float32).abs()
    yf = y.to(torch.float32).abs()
    zmax = torch.maximum(xf, yf)
    zmin = torch.minimum(xf, yf)
    # the constants are float32 values, so each op rounds as in float32
    z = zmin / zmax.clamp_min(float(np.float32(1e-30)))
    poly = float(_C1) + float(_C2) * z
    anglef = z * (float(_C0) - (z - 1.0) * poly)
    angle = anglef.to(torch.int32)  # trunc toward zero (vcvtq_s32_f32)

    signs_differ = (x < 0) ^ (y < 0)
    xdom = x.abs() > y.abs()
    a1 = torch.where(signs_differ, -angle, angle)
    a1 = torch.where(x < 0, a1 + 256 * 60, torch.where(a1 < 0, a1 + 256 * 120, a1))
    a2 = torch.where(signs_differ, angle, -angle)
    a2 = torch.where(y >= 0, a2 + 256 * 30, a2 + 256 * 90)
    out = torch.where(xdom, a1, a2) >> 10
    out = torch.where((out >= 0) & (out < 30) & (zmax > 0), out, torch.zeros_like(out))
    return out.to(torch.uint8)


def sweep_moments(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(m10, m01) int32 pairs that exercise every branch and bin edge of
    ``atan2_bins``: all of [-300, 300]^2, 10^5 random pairs within +-2^20,
    and the 7x7 neighbourhood of the point on each of the 30 bin edges
    (12 degrees apart) at radii 10^3..10^6."""
    r = np.arange(-300, 301)
    gx, gy = np.meshgrid(r, r)
    rng = np.random.default_rng(seed)
    rand = rng.integers(-(1 << 20), 1 << 20, (2, 100_000))
    theta = np.deg2rad(12.0 * np.arange(30))
    radius = 10.0 ** np.arange(3, 7)
    ex = np.rint(radius[:, None] * np.cos(theta)[None, :]).reshape(-1)
    ey = np.rint(radius[:, None] * np.sin(theta)[None, :]).reshape(-1)
    d = np.arange(-3, 4)
    dx, dy = np.meshgrid(d, d)
    nx = (ex[:, None] + dx.reshape(-1)[None, :]).reshape(-1)
    ny = (ey[:, None] + dy.reshape(-1)[None, :]).reshape(-1)
    m10 = np.concatenate([gx.reshape(-1), rand[0], nx]).astype(np.int32)
    m01 = np.concatenate([gy.reshape(-1), rand[1], ny]).astype(np.int32)
    return m10, m01
