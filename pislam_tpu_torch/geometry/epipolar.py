"""Epipolar geometry: 8-point essential matrix, Sampson error, pose recovery.

The port of ``pislam_tpu/geometry/epipolar.py``. Convention: normalised
image points p = (u, v, 1) (pixels pre-multiplied by K^-1); E = [t]x R with
p2^T E p1 = 0 and X_cam2 = R X_cam1 + t. Everything is fixed-shape and
batches over leading dimensions.

The least-squares solve takes the SVD of the (N, 9) constraint matrix with
``full_matrices=False``: its ``vt`` is (9, 9) for N >= 9, the same rows the
JAX package reads from its full SVD. Singular vectors carry an arbitrary
sign per LAPACK or cuSOLVER build, so E is defined up to sign; the Sampson
error and the recovered (R, t) do not depend on it.
"""

from __future__ import annotations

import torch


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _det3(m):
    """Determinant of (..., 3, 3) by cofactors (its sign is all that is used)."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def _constraint_rows(p1, p2, w=None):
    """(N, 2)+(N, 2) -> (N, 9) rows of the epipolar constraint p2h^T E p1h."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    rows = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], -1)
    if w is not None:
        rows = rows * w[..., None]
    return rows


def essential_8pt(p1, p2, weights=None):
    """Least-squares essential matrix from N >= 9 normalised correspondences.

    Solves min ||A e|| via SVD, then projects to the essential manifold
    (singular values (1, 1, 0)).
    """
    a = _constraint_rows(p1, p2, weights)
    _, _, vt = torch.linalg.svd(a, full_matrices=False)
    em = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    u, _, vt2 = torch.linalg.svd(em)
    # u @ diag(1, 1, 0) @ vt2: the dropped term is an exact zero
    return u[..., :, :2] @ vt2[..., :2, :]


def nullvec_8x9(a):
    """(..., 8, 9) -> (..., 9) unit nullvector, LAPACK-free.

    The nullvector of an exactly-8-row A is the 9th column of Q in the QR
    factorisation of A^T (9, 8), computed as 8 batched Householder
    reflections: fixed-shape elementwise arithmetic, exact to float32
    roundoff, and no per-hypothesis SVD.
    """
    r = a.transpose(-1, -2)                          # (..., 9, 8) = A^T
    i9 = torch.arange(9, device=a.device)
    vs = []
    for k in range(8):
        x = torch.where(i9 >= k, r[..., :, k], 0.0)  # entries below the pivot
        xk = x[..., k]
        nrm = torch.linalg.vector_norm(x, dim=-1)
        alpha = -torch.sign(torch.where(xk == 0, 1.0, xk)) * nrm
        v = x - alpha[..., None] * (i9 == k)
        vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        # degenerate column (already triangular): identity reflection
        v = torch.where(vn > 1e-20, v / torch.clamp(vn, min=1e-30), 0.0)
        r = r - 2.0 * v[..., :, None] * torch.sum(v[..., :, None] * r, dim=-2,
                                                  keepdim=True)
        vs.append(v)
    # nullvec = H1 ... H8 e9 (the 9th column of Q)
    q = (i9 == 8).to(a.dtype) * torch.ones_like(a[..., 0, :])
    for v in reversed(vs):
        q = q - 2.0 * v * torch.sum(v * q, dim=-1, keepdim=True)
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30)


def essential_8pt_fast(p1, p2):
    """Batched 8-point hypotheses without SVD (see nullvec_8x9).

    Returns unprojected (3, 3) E estimates for Sampson scoring; refit the
    winning inlier set with ``essential_8pt`` before pose recovery."""
    q = nullvec_8x9(_constraint_rows(p1, p2))
    return q.reshape(q.shape[:-1] + (3, 3))


def sampson_error(E, p1, p2):
    """First-order geometric error of p2^T E p1 (squared, per point).

    E (..., 3, 3) broadcasts against p1, p2 (N, 2): a (H, 3, 3) stack of
    hypotheses gives (H, N).
    """
    p1h = _homogeneous(p1)
    p2h = _homogeneous(p2)
    Ep1 = p1h @ E.transpose(-1, -2)   # (..., N, 3) = (E @ p1h^T)^T
    Etp2 = p2h @ E                     # (..., N, 3) = (E^T @ p2h^T)^T
    num = torch.sum(p2h * Ep1, -1) ** 2
    den = Ep1[..., 0] ** 2 + Ep1[..., 1] ** 2 + Etp2[..., 0] ** 2 + Etp2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def decompose_essential(E):
    """E -> (R_a, R_b, t): the two rotations and translation direction."""
    u, _, vt = torch.linalg.svd(E)
    # enforce proper rotations
    u = u * torch.sign(_det3(u))[..., None, None]
    vt = vt * torch.sign(_det3(vt))[..., None, None]
    # u @ W and u @ W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: exact
    # column permutations and negations, made on the device
    c0, c1, c2 = u[..., :, 0], u[..., :, 1], u[..., :, 2]
    uw = torch.stack([c1, -c0, c2], -1)
    uwt = torch.stack([-c1, c0, c2], -1)
    return uw @ vt, uwt @ vt, c2


def triangulate_depths(R, t, p1, p2):
    """Closed-form two-view depths for cheirality testing.

    Rays d1 = (p1, 1) in cam1, d2 = (p2, 1) in cam2 with X2 = R X1 + t.
    Depth s along d1 minimises ||cross(d2, R (s d1) + t)||^2:
        s = -dot(cross(d2, R d1), cross(d2, t)) / ||cross(d2, R d1)||^2
    Returns (z1, z2): depths of the point in each camera.
    """
    d1 = _homogeneous(p1)
    d2 = _homogeneous(p2)
    rd1 = d1 @ R.transpose(-1, -2)
    c_rd1 = torch.linalg.cross(d2, rd1)
    c_t = torch.linalg.cross(d2, t.expand(d2.shape))
    s = -torch.sum(c_rd1 * c_t, -1) / torch.clamp(torch.sum(c_rd1 * c_rd1, -1), min=1e-12)
    x2 = s[..., None] * rd1 + t
    return s, x2[..., 2]


def recover_pose(E, p1, p2, weights):
    """Pick the (R, t) among the 4 decompositions with max cheirality support.

    weights: (N,) 0/1 inlier mask (float). Returns (R, t, support); the first
    candidate wins a tie.
    """
    ra, rb, t = decompose_essential(E)
    best_r = best_t = best_n = None
    for R in (ra, rb):
        for tt in (t, -t):
            z1, z2 = triangulate_depths(R, tt, p1, p2)
            n = torch.sum(weights * (z1 > 0) * (z2 > 0))
            if best_n is None:
                best_r, best_t, best_n = R, tt, n
            else:
                take = n > best_n
                best_r = torch.where(take, R, best_r)
                best_t = torch.where(take, tt, best_t)
                best_n = torch.maximum(n, best_n)
    return best_r, best_t, best_n
