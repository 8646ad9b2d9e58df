"""Trajectory evaluation: ATE / RPE, pure numpy.

A copy of ``pislam_tpu/evaluation.py`` (which this package does not import):
TUM-RGBD style absolute trajectory error after SE(3) or Sim(3) Umeyama
alignment, and relative pose error over fixed deltas.
"""

from __future__ import annotations

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Align est (N, 3) onto gt (N, 3). Returns (s, R, t) minimising
    ||gt - (s R est + t)||^2 (Umeyama 1991)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / len(est)
    u, d, vt = np.linalg.svd(cov)
    s_fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s_fix[2, 2] = -1.0
    R = u @ s_fix @ vt
    if with_scale:
        var_e = (e * e).sum() / len(est)
        s = float(np.trace(np.diag(d) @ s_fix) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after alignment. est/gt: (N, 3)."""
    s, R, t = umeyama_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = aligned - gt
    return float(np.sqrt((err * err).sum(-1).mean()))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """Relative pose (drift) error RMSE over `delta`-frame steps.

    Rotation-invariant: compares per-step translation magnitudes after a
    global scale alignment (monocular trajectories are up-to-scale)."""
    de = np.linalg.norm(est[delta:] - est[:-delta], axis=-1)
    dg = np.linalg.norm(gt[delta:] - gt[:-delta], axis=-1)
    s = dg.sum() / max(de.sum(), 1e-12)
    err = s * de - dg
    return float(np.sqrt((err * err).mean()))
