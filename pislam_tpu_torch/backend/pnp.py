"""Motion-only bundle adjustment: camera pose from 2D-3D correspondences.

The port of ``pislam_tpu/backend/pnp.py``: robust Gauss-Newton on the
reprojection error with a fixed iteration count and Huber re-weighting.
The JAX package takes the Jacobian by forward-mode autodiff of the residual
at the identity perturbation (``jax.jacfwd``); here it is written out, as
``backend/ba.py`` writes its own: for a left-multiplicative twist
[rho, w], d(xc)/d rho = I and d(xc)/d w = -[xc]_x, through the projection
Jacobian: the same derivative in a dozen launches per iteration, where
``torch.func.jacfwd``'s many small launches made this solve the largest
stage of a SLAM frame on the card. The normal equations are solved with
``torch.linalg.solve_ex``.

That is ``motion_only_ba_plain``, which runs on the CPU. On a CUDA device
``motion_only_ba`` is one launch of ``csrc/motion_only_ba.cu``
(``motion_only_ba_kernel``, which ``ops.kernels.motion_only_ba`` launches and
``ops.kernels.COUNTED`` counts): the plain version's ~800 launches a call,
and the two reads of the solve's status that ``linalg_lu_solve`` makes on
the host every iteration, were a third of a SLAM frame's host time.
"""

from __future__ import annotations

import torch

from ..geometry import se3
from ..ops import kernels


def _camera_points(R, t, xyz):
    """(N, 3) camera-frame points and the (N,) depths the projection
    divides by, world->cam pose."""
    xc = xyz @ R.T + t
    return xc, torch.where(xc[:, 2] > 1e-6, xc[:, 2], 1.0)  # NaN-free behind the camera


def _project_residuals(R, t, xyz, uv):
    """(N, 2) reprojection residuals + (N,) depths, world->cam pose."""
    xc, zs = _camera_points(R, t, xyz)
    return xc[:, :2] / zs[:, None] - uv, xc[:, 2]


def _jacobian(xc, zs):
    """(N, 2, 6) d(residual)/d[rho, w] at the identity perturbation. Where
    z <= 1e-6 the divisor is the constant 1, as in the residual."""
    x, y = xc[:, 0], xc[:, 1]
    inv = 1.0 / zs
    front = (xc[:, 2] > 1e-6).to(xc.dtype)
    zero = torch.zeros_like(inv)
    jpi = torch.stack([
        torch.stack([inv, zero, -x * inv * inv * front], -1),
        torch.stack([zero, inv, -y * inv * inv * front], -1),
    ], -2)                                               # (N, 2, 3)
    return torch.cat([jpi, jpi @ -se3.hat(xc)], -1)


def motion_only_ba(R0, t0, xyz, uv, valid, iters: int = 8,
                   huber: float = 5e-3, inlier_threshold: float = 6e-3,
                   damping: float = 1e-6):
    """Refine a world->cam pose against matched map points.

    R0 (3,3), t0 (3,): initial pose. xyz (N,3) world landmarks, uv (N,2)
    normalised observations, valid (N,) bool. Returns dict with R, t,
    inliers (N,) bool, num_inliers and costs (iters,). Behind-camera points
    get zero weight. ``motion_only_ba_plain`` on CPU tensors, one kernel
    launch on CUDA ones.
    """
    return motion_only_ba_kernel(R0, t0, xyz, uv, valid, iters, huber, inlier_threshold,
                                 damping)


def motion_only_ba_plain(R0, t0, xyz, uv, valid, iters: int = 8,
                         huber: float = 5e-3, inlier_threshold: float = 6e-3,
                         damping: float = 1e-6):
    """``motion_only_ba`` in plain torch, on any device: Gauss-Newton with
    the written-out Jacobian, iteration by iteration."""
    R, t = R0, t0
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    costs = []
    for _ in range(iters):
        xc, zs = _camera_points(R, t, xyz)
        r = xc[:, :2] / zs[:, None] - uv
        J = _jacobian(xc, zs)
        rn = torch.linalg.vector_norm(r, dim=1)
        w = torch.where(rn > huber, huber / torch.clamp(rn, min=1e-12), 1.0)
        w = torch.where(valid & (xc[:, 2] > 1e-6), w, 0.0)
        Jw = J * w[:, None, None]
        H = torch.einsum("nki,nkj->ij", Jw, J) + damping * eye6
        b = -torch.einsum("nki,nk->i", Jw, r)
        xi = torch.linalg.solve_ex(H, b)[0]
        dR, dt = se3.se3_exp(xi)
        R, t = dR @ R, (dR @ t[:, None])[:, 0] + dt
        costs.append(torch.sum(w * rn * rn))
    r, z = _project_residuals(R, t, xyz, uv)
    inl = valid & (z > 1e-6) & (torch.linalg.vector_norm(r, dim=1) < inlier_threshold)
    return {"R": R, "t": t, "inliers": inl, "num_inliers": inl.sum(),
            "costs": torch.stack(costs)}


motion_only_ba_kernel = kernels.counted(kernels.hopper_kernel(
    motion_only_ba_plain, "pislam_tpu_torch/csrc/motion_only_ba.cu",
    "none: pislam_tpu/backend/pnp.py motion_only_ba is plain JAX")(kernels.motion_only_ba))
