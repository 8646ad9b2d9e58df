"""Motion-only bundle adjustment: camera pose from 2D-3D correspondences.

The port of ``pislam_tpu/backend/pnp.py``: robust Gauss-Newton on the
reprojection error with a fixed iteration count and Huber re-weighting.
Jacobians come from forward-mode autodiff of the residual at the identity
perturbation (``torch.func.jacfwd``, as the JAX package uses ``jax.jacfwd``).
The normal equations are solved with ``torch.linalg.solve_ex``, which does
not read its status back to the host.
"""

from __future__ import annotations

import torch

from ..geometry import se3


def _project_residuals(R, t, xyz, uv):
    """(N, 2) reprojection residuals + (N,) depths, world->cam pose."""
    xc = xyz @ R.T + t
    z = xc[:, 2]
    zs = torch.where(z > 1e-6, z, 1.0)  # NaN-free for behind-camera points
    return xc[:, :2] / zs[:, None] - uv, z


def motion_only_ba(R0, t0, xyz, uv, valid, iters: int = 8,
                   huber: float = 5e-3, inlier_threshold: float = 6e-3,
                   damping: float = 1e-6):
    """Refine a world->cam pose against matched map points.

    R0 (3,3), t0 (3,): initial pose. xyz (N,3) world landmarks, uv (N,2)
    normalised observations, valid (N,) bool. Returns dict with R, t,
    inliers (N,) bool, num_inliers and costs (iters,). Behind-camera points
    get zero weight.
    """
    R, t = R0, t0
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    costs = []
    for _ in range(iters):
        def res(xi, R=R, t=t):
            dR, dt = se3.se3_exp(xi)
            return _project_residuals(dR @ R, (dR @ t[:, None])[:, 0] + dt, xyz, uv)[0]

        r, z = _project_residuals(R, t, xyz, uv)
        J = torch.func.jacfwd(res)(torch.zeros(6, dtype=R.dtype, device=R.device))
        rn = torch.linalg.vector_norm(r, dim=1)
        w = torch.where(rn > huber, huber / torch.clamp(rn, min=1e-12), 1.0)
        w = torch.where(valid & (z > 1e-6), w, 0.0)
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
