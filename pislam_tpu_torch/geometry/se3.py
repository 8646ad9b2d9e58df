"""SE(3) / SO(3) utilities in float32 torch.

The port of ``pislam_tpu/geometry/se3.py``. Rotation matrices act on column
vectors; exp/log use Rodrigues forms. Every trig coefficient is written in a
cancellation-free form (1 - cos via 2 sin^2(theta/2)) and switched to its
Taylor series below theta ~ 0.07, where the closed forms lose float32
precision. Both branches of each ``torch.where`` are NaN-free for all inputs.
"""

from __future__ import annotations

import torch

_T2_SMALL = 5e-3  # theta^2 cutoff (theta ~ 0.07) for Taylor fallbacks


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _eye_like(k):
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def _coefficients(theta2):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), stable float32."""
    t = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _T2_SMALL
    ts = torch.where(small, 1.0, t)  # safe theta for the closed forms
    sh = torch.sin(0.5 * ts)
    a = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    2.0 * sh * sh / (ts * ts))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (ts - torch.sin(ts)) / (ts * ts * ts))
    return a, b, c


def so3_exp(w):
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues)."""
    theta2 = torch.sum(w * w, -1)[..., None, None]
    a, b, _ = _coefficients(theta2)
    k = hat(w)
    return _eye_like(k) + a * k + b * (k @ k)


def so3_log(R):
    """(..., 3, 3) rotation -> (..., 3) axis-angle (theta in [0, pi]).

    The small-angle branch derives its series from u = sin(theta) = |v|/2,
    so it is differentiable at the identity.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    th = theta[..., None]
    small = th < 0.07
    ths = torch.where(small, 1.0, th)
    u2 = torch.sum(v * v, -1, keepdim=True) * 0.25
    s = torch.where(small,
                    0.5 * (1.0 + u2 / 6.0 + 3.0 * u2 * u2 / 40.0),
                    ths / (2.0 * torch.sin(ths)))
    # theta -> pi branch (sin -> 0): axis_i^2 = (R_ii - cos) / (1 - cos),
    # signs from the antisymmetric part v
    near_pi = th > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis = torch.sqrt(torch.clamp(
        (diag - cos[..., None]) / torch.clamp(1.0 - cos[..., None], min=1e-6),
        0.0, 1.0) + 1e-12)
    sign = torch.where(v >= 0, 1.0, -1.0)
    return torch.where(near_pi, axis * sign * th, v * s)


def se3_exp(xi):
    """(..., 6) twist [rho, w] -> ((..., 3, 3) R, (..., 3) t)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, -1)[..., None, None]
    a, b, c = _coefficients(theta2)
    k = hat(w)
    k2 = k @ k
    eye = _eye_like(k)
    R = eye + a * k + b * k2
    V = eye + b * k + c * k2
    return R, (V @ rho[..., None])[..., 0]


def se3_log(R, t):
    """Inverse of se3_exp: ((..., 3, 3), (..., 3)) -> (..., 6) twist."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _T2_SMALL
    ths = torch.where(small, 1.0, th)
    # coef = (1 - (theta/2) cot(theta/2)) / theta^2, Taylor 1/12 + t^2/720
    half = 0.5 * ths
    cot = torch.cos(half) / torch.clamp(torch.sin(half), min=1e-12)
    coef = torch.where(small,
                       1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
                       (1.0 - half * cot) / (ths * ths))
    k = hat(w)
    Vinv = _eye_like(k) - 0.5 * k + coef * (k @ k)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], -1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): X -> Ra (Rb X + tb) + ta."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, X):
    """Apply: (..., 3, 3), (..., 3), (..., N, 3) -> (..., N, 3)."""
    return X @ R.transpose(-1, -2) + t[..., None, :]
