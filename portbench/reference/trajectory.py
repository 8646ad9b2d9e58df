"""Trajectory and map comparisons against the scene's exact ground truth, in
float64 numpy: Sim(3) alignment (Umeyama 1991), per-frame position errors
and relative rotation errors.

Imports nothing of the port: what it reads are the poses, keyframes,
landmarks and observations that the port returned, as numpy arrays.
"""

from __future__ import annotations

import numpy as np


def umeyama(est: np.ndarray, gt: np.ndarray):
    """(s, R, t) minimising ||gt - (s R est + t)||^2 over (N, 3) points."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    u, d, vt = np.linalg.svd(g.T @ e / len(est))
    fix = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        fix[2, 2] = -1.0
    R = u @ fix @ vt
    var_e = (e * e).sum() / len(est)
    s = float(np.trace(np.diag(d) @ fix) / max(var_e, 1e-300))
    return s, R, mu_g - s * R @ mu_e


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of world -> camera poses (N, 3, 3), (N, 3)."""
    return -np.einsum("nji,nj->ni", R, t)


def position_errors(R, t, gt_R, gt_t):
    """Per-frame distance between the Sim(3)-aligned estimated camera
    centres and the true ones, as a share of the true centres' RMS spread
    about their mean (so a number without units, the same at any scene
    scale). Non-finite poses count as an error of infinity."""
    est = centres(np.asarray(R, np.float64), np.asarray(t, np.float64))
    gt = centres(np.asarray(gt_R, np.float64), np.asarray(gt_t, np.float64))
    spread = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean()))
    finite = np.isfinite(est).all(1)
    err = np.full(len(est), np.inf)
    if finite.sum() >= 3 and spread > 0:
        s, Ra, ta = umeyama(est[finite], gt[finite])
        aligned = s * est[finite] @ Ra.T + ta
        err[finite] = np.linalg.norm(aligned - gt[finite], axis=1) / spread
    return err


def relative_rotation_errors(R, gt_R, frames, gap: int = 4):
    """Degrees between the estimated and the true rotation from frame k to
    frame k + gap, for every such pair of the given frame numbers."""
    R, gt_R = np.asarray(R, np.float64), np.asarray(gt_R, np.float64)
    at = {int(k): i for i, k in enumerate(frames)}
    out = []
    for k, i in at.items():
        j = at.get(k + gap)
        if j is None:
            continue
        d = (R[j] @ R[i].T) @ (gt_R[j] @ gt_R[i].T).T
        out.append(np.degrees(np.arccos(np.clip((np.trace(d) - 1) / 2, -1.0, 1.0))))
    return np.asarray(out)
