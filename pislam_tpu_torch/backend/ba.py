"""Windowed sparse bundle adjustment with Schur-complement reduction.

The port of ``pislam_tpu/backend/ba.py`` (without its ``axis_name``
collectives: the distributed Schur reduction belongs to the port of
``parallel/``). A window holds C poses, P landmark slots and O observation
slots, each with a validity mask; invalid slots carry zero Jacobians and drop
out of every sum. Two solvers of the reduced camera system:

* dense: the camera-point coupling W stored per point, (P, C*6, 3), the
  Schur complement S = H_cc + lambda I - sum_p W_p Hpp_p^-1 W_p^T as one
  einsum, and a (6C, 6C) solve;
* cg: S applied matrix-free from per-observation terms, block-Jacobi
  preconditioned conjugate gradients (global BA at 64 keyframes).

Landmark blocks H_pp are inverted in closed form (adjugate). LM runs a fixed
number of iterations with the accept/reject expressed as ``torch.where`` per
field, and solves with ``solve_ex``/``inv_ex``: nothing reads a value back
to the host, so a BA is launched whole and the caller's read waits for it.

Camera model: normalised pinhole; residual = pi(R X + t) - uv. Pose updates
are left-multiplicative twists. The first ``n_fixed`` cameras and the
invalid ones are held fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3


class BAProblem(NamedTuple):
    """One BA window (all tensors fixed-shape, masked)."""
    R: torch.Tensor          # (C, 3, 3) world->cam rotations
    t: torch.Tensor          # (C, 3)
    points: torch.Tensor     # (P, 3) world landmarks
    obs_cam: torch.Tensor    # (O,) int camera index per observation
    obs_pt: torch.Tensor     # (O,) int landmark index
    obs_uv: torch.Tensor     # (O, 2) normalised measurements
    obs_valid: torch.Tensor  # (O,) bool
    cam_valid: torch.Tensor  # (C,) bool
    pt_valid: torch.Tensor   # (P,) bool


class _Segments:
    """jax.ops.segment_sum over fixed segment ids (< n), deterministic: the
    rows are sorted by segment once (stable) and ``torch.segment_reduce``
    sums each segment in row order, where ``index_add_`` on CUDA adds with
    atomics in an order that changes from run to run (and BA's LM
    accept/reject can turn on the last bit)."""

    def __init__(self, seg, n: int):
        self.order = torch.argsort(seg, stable=True)
        self.lengths = torch.zeros(n, dtype=torch.int64, device=seg.device).index_add_(
            0, seg, torch.ones_like(seg))

    def sum(self, x):
        return torch.segment_reduce(x[self.order], "sum", lengths=self.lengths, axis=0,
                                    unsafe=True)


class _ProblemSegments(NamedTuple):
    cam: _Segments    # observations by camera
    pt: _Segments     # observations by point
    pair: _Segments   # observations by (point, camera)


def _segments(p: "BAProblem") -> _ProblemSegments:
    C, P = p.R.shape[0], p.points.shape[0]
    cam, pt = p.obs_cam.long(), p.obs_pt.long()
    return _ProblemSegments(_Segments(cam, C), _Segments(pt, P), _Segments(pt * C + cam, P * C))


def _project(R, t, X):
    xc = (R @ X[..., None])[..., 0] + t
    z = torch.clamp(xc[..., 2], min=1e-6)
    return xc[..., :2] / z[..., None], xc


def residuals_and_jacobians(p: BAProblem, huber: float = 0.0):
    """Per-observation residual (O, 2), J_c (O, 2, 6), J_p (O, 2, 3) and
    the (O,) 0/1 validity mask.

    J_c is wrt a left-multiplicative twist [rho, w] on (R, t):
    d(xc)/d rho = I, d(xc)/d w = -[xc]_x; J_p is wrt the world point:
    d(xc)/dX = R. With ``huber`` > 0 the rows are scaled by the square root
    of the Huber IRLS weight min(1, huber/|r|).
    """
    cam, pt = p.obs_cam.long(), p.obs_pt.long()
    R = p.R[cam]
    X = p.points[pt]
    uv, xc = _project(R, p.t[cam], X)
    r = uv - p.obs_uv

    x, y, z = xc[..., 0], xc[..., 1], torch.clamp(xc[..., 2], min=1e-6)
    zinv = 1.0 / z
    zero = torch.zeros_like(zinv)
    jpi = torch.stack([
        torch.stack([zinv, zero, -x * zinv * zinv], -1),
        torch.stack([zero, zinv, -y * zinv * zinv], -1),
    ], -2)                                          # (O, 2, 3)
    jc = torch.cat([jpi, jpi @ -se3.hat(xc)], -1)   # (O, 2, 6): [d/drho, d/dw]
    jp = jpi @ R                                    # (O, 2, 3)

    w = (p.obs_valid & p.cam_valid[cam] & p.pt_valid[pt]).to(r.dtype)
    s = w
    if huber > 0:
        rn = torch.linalg.vector_norm(r, dim=1)
        s = w * torch.sqrt(torch.where(rn > huber, huber / torch.clamp(rn, min=1e-12), 1.0))
    return r * s[:, None], jc * s[:, None, None], jp * s[:, None, None], w


def _adjugate_inv3(m, damping):
    """Batched closed-form inverse of (..., 3, 3) SPD blocks with LM damping."""
    m = m + damping * torch.eye(3, dtype=m.dtype, device=m.device)
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
        torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
    ], -2)
    return adj / det[..., None, None]


def _normal_terms(segs: _ProblemSegments, r, jc, jp):
    """(H_cc (C,6,6), b_c (C,6), H_pp (P,3,3), b_p (P,3)) by segment sums."""
    hcc = segs.cam.sum(torch.einsum("oki,okj->oij", jc, jc))
    bc = segs.cam.sum(-torch.einsum("oki,ok->oi", jc, r))
    hpp = segs.pt.sum(torch.einsum("oki,okj->oij", jp, jp))
    bp = segs.pt.sum(-torch.einsum("oki,ok->oi", jp, r))
    return hcc, bc, hpp, bp


def gn_normal_blocks(p: BAProblem, r, jc, jp, segs=None):
    """The Schur ingredients from per-observation terms: (H_cc (C,6,6),
    b_c (C,6), H_pp (P,3,3), b_p (P,3), W (P, C, 6, 3))."""
    C, P = p.R.shape[0], p.points.shape[0]
    segs = segs or _segments(p)
    hcc, bc, hpp, bp = _normal_terms(segs, r, jc, jp)
    w = segs.pair.sum(torch.einsum("oki,okj->oij", jc, jp))      # (P*C, 6, 3)
    return hcc, bc, hpp, bp, w.reshape(P, C, 6, 3)


def _pinned(cam_valid, n_fixed: int):
    """Cameras whose deltas are pinned to zero: the invalid ones and the
    first n_fixed (n_fixed >= 2 also anchors the monocular scale gauge)."""
    return ~cam_valid | (torch.arange(cam_valid.shape[0], device=cam_valid.device) < n_fixed)


def schur_reduce(hcc, bc, hpp, bp, w, damping, cam_valid, n_fixed: int = 1):
    """The reduced camera system (S (6C, 6C), b (6C,)) and the point-solve
    helpers (hpp_inv (P, 3, 3), wf (P, 6C, 3)):

    S = blockdiag(H_cc) + lambda I - sum_p Wp Hpp^-1 Wp^T
    b = b_c - sum_p Wp Hpp^-1 b_p
    """
    C = hcc.shape[0]
    P = hpp.shape[0]
    hpp_inv = _adjugate_inv3(hpp, damping)
    wf = w.reshape(P, C * 6, 3)
    whi = torch.einsum("pij,pjk->pik", wf, hpp_inv)   # (P, 6C, 3)
    cross = torch.einsum("pik,plk->il", whi, wf)       # (6C, 6C)
    bcross = torch.einsum("pik,pk->pi", whi, bp).sum(0)
    idx = torch.arange(C, device=hcc.device)
    s = (-cross).reshape(C, 6, C, 6)
    s[idx, :, idx, :] += hcc
    eye = torch.eye(6 * C, dtype=cross.dtype, device=cross.device)
    s = s.reshape(6 * C, 6 * C) + damping * eye
    b = bc.reshape(-1) - bcross
    pin = torch.repeat_interleave(_pinned(cam_valid, n_fixed), 6)
    s = torch.where(pin[:, None] | pin[None, :], eye, s)
    b = torch.where(pin, 0.0, b)
    return s, b, hpp_inv, wf


def _pcg(apply, minv_apply, b, iters: int):
    """Fixed-iteration preconditioned conjugate gradients (no data-dependent
    exit), guarded against zero curvature and residual so a converged system
    stays put instead of producing NaNs."""
    x = torch.zeros_like(b)
    r = b
    z = minv_apply(r)
    pvec = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        ap = apply(pvec)
        denom = torch.dot(pvec, ap)
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, 0.0)
        x = x + alpha * pvec
        r = r - alpha * ap
        z = minv_apply(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, 0.0)
        pvec = z + beta * pvec
        rz = rz_new
    return x


def reduced_system_cg(p: BAProblem, r, jc, jp, damping, iters: int, n_fixed: int = 1,
                      segs=None):
    """Solve the Schur-reduced camera system matrix-free with block-Jacobi
    preconditioned CG:

        S x = (H_cc + lambda I) x - sum_o J_c^T J_p Hpp^-1 [sum_o' J_p^T J_c x]

    two segment sums per CG iteration, O(O) memory, never forming W or S.
    Returns (dc_flat (6C,), hpp_inv, bp, points_from_cams).
    """
    C = p.R.shape[0]
    cam, pt = p.obs_cam.long(), p.obs_pt.long()
    segs = segs or _segments(p)
    hcc, bc, hpp, bp = _normal_terms(segs, r, jc, jp)
    hpp_inv = _adjugate_inv3(hpp, damping)
    pin = _pinned(p.cam_valid, n_fixed)

    def cams_from_points(z):
        """(P, 3) landmark-space vector -> (C, 6) camera accumulation."""
        w = torch.einsum("oki,oi->ok", jp, z[pt])
        return segs.cam.sum(torch.einsum("oki,ok->oi", jc, w))

    def points_from_cams(x):
        """(C, 6) camera vector -> (P, 3) landmark accumulation W^T x."""
        u = torch.einsum("oki,oi->ok", jc, x[cam])
        return segs.pt.sum(torch.einsum("oki,ok->oi", jp, u))

    def apply(x_flat):
        x = torch.where(pin[:, None], 0.0, x_flat.reshape(C, 6))
        z = torch.einsum("pij,pj->pi", hpp_inv, points_from_cams(x))
        out = torch.einsum("cij,cj->ci", hcc, x) + damping * x - cams_from_points(z)
        return torch.where(pin[:, None], x_flat.reshape(C, 6), out).reshape(-1)

    eye6 = torch.eye(6, dtype=hcc.dtype, device=hcc.device)
    blocks = torch.where(pin[:, None, None], eye6, hcc + damping * eye6)
    binv = torch.linalg.inv_ex(blocks)[0]

    def minv(r_flat):
        return torch.einsum("cij,cj->ci", binv, r_flat.reshape(C, 6)).reshape(-1)

    z0 = torch.einsum("pij,pj->pi", hpp_inv, bp)
    b = torch.where(pin[:, None], 0.0, bc - cams_from_points(z0)).reshape(-1)
    return _pcg(apply, minv, b, iters), hpp_inv, bp, points_from_cams


def ba_cost(p: BAProblem, huber: float = 0.0):
    r, _, _, w = residuals_and_jacobians(p, huber=huber)
    return torch.sum(r * r), torch.sum(w)


def _apply_update(p: BAProblem, dc, dp):
    dR, dt = se3.se3_exp(dc)
    return p._replace(R=dR @ p.R, t=(dR @ p.t[..., None])[..., 0] + dt,
                      points=p.points + dp * p.pt_valid[:, None])


def ba_iterations(p: BAProblem, iters: int, damping: float, solver: str = "dense",
                  cg_iters: int = 64, huber: float = 0.0, n_fixed: int = 1):
    """The LM loop. solver="dense" factorises the (6C, 6C) reduced camera
    matrix (schur_reduce); "cg" solves it matrix-free (reduced_system_cg).
    With ``huber`` > 0 both the normal equations and the accept/reject
    costs use the robustified residuals. Returns (problem, {"costs",
    "final_damping"})."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown BA solver {solver!r}")
    prob = p
    segs = _segments(p)     # the observations' cameras and points stay fixed
    lam = torch.tensor(damping, dtype=p.points.dtype, device=p.points.device)
    costs = []
    for _ in range(iters):
        r, jc, jp, _ = residuals_and_jacobians(prob, huber=huber)
        cost0 = torch.sum(r * r)
        if solver == "cg":
            dc_flat, hpp_inv, bp, points_from_cams = reduced_system_cg(
                prob, r, jc, jp, lam, cg_iters, n_fixed=n_fixed, segs=segs)
            dc = dc_flat.reshape(-1, 6)
            dp = torch.einsum("pij,pj->pi", hpp_inv, bp - points_from_cams(dc))
        else:
            hcc, bc, hpp, bp, w = gn_normal_blocks(prob, r, jc, jp, segs)
            s, b, hpp_inv, wf = schur_reduce(hcc, bc, hpp, bp, w, lam, prob.cam_valid,
                                             n_fixed=n_fixed)
            dc_flat = torch.linalg.solve_ex(s, b)[0]
            dc = dc_flat.reshape(-1, 6)
            # back-substitute landmarks: dp = Hpp^-1 (b_p - W^T dc)
            dp = torch.einsum("pij,pj->pi", hpp_inv,
                              bp - torch.einsum("pik,i->pk", wf, dc_flat))
        cand = _apply_update(prob, dc, dp)
        r1, _, _, _ = residuals_and_jacobians(cand, huber=huber)
        cost1 = torch.sum(r1 * r1)
        accept = cost1 < cost0
        prob = BAProblem(*(torch.where(accept, a, b) for a, b in zip(cand, prob)))
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e3))
        costs.append(torch.where(accept, cost1, cost0))
    return prob, {"costs": torch.stack(costs) if costs else lam.new_zeros(0),
                  "final_damping": lam}


def bundle_adjust(p: BAProblem, iters: int = 8, damping: float = 1e-4,
                  solver: str = "auto", cg_iters: int = 64, huber: float = 0.0,
                  n_fixed: int = 1):
    """Run ``iters`` LM iterations. Returns (problem, info).

    solver="auto" picks the dense Schur factorisation for up to 48 cameras
    and matrix-free CG above (where the dense W tensor and the O((6C)^3)
    factorisation stop scaling)."""
    if solver == "auto":
        solver = "cg" if p.R.shape[0] > 48 else "dense"
    return ba_iterations(p, iters, damping, solver=solver, cg_iters=cg_iters,
                         huber=huber, n_fixed=n_fixed)
