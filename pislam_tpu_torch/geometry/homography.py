"""Homography estimation + decomposition: the planar-scene initialiser.

The port of ``pislam_tpu/geometry/homography.py``. An essential matrix is
degenerate when the scene is a single plane, so the two-view initialiser
also fits a homography and recovers (R, t, n) from it: fixed-iteration
batched 4-point DLT hypotheses, one (iters, N) symmetric-transfer scoring
pass, the Faugeras-Lustman decomposition into 8 (R, t, n) candidates as one
batch, and cheirality as a batched argmax. Nothing here reads a value back
to the host; the samples are inputs (``idx``) or come from a
``torch.Generator`` through ``ransac.sample_indices``, as for the essential
solver.

Singular vectors carry an arbitrary sign per LAPACK or cuSOLVER build, so H
is defined up to sign; the transfer error, the inliers and the recovered
pose do not depend on it.
"""

from __future__ import annotations

import torch

from . import epipolar, ransac


def _dlt_rows(p1, p2):
    """(..., N, 2) pairs -> the two (..., N, 9) DLT rows of p2 ~ H p1."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], -1)
    r2 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    return r1, r2


def homography_dlt(p1, p2, weights=None):
    """(N, 2), (N, 2) normalised correspondences -> H (3, 3), p2 ~ H p1.

    Each correspondence gives two rows of the 2N x 9 system; H is its
    smallest right singular vector. ``weights`` (N,) weights the rows (the
    inlier refit). The SVD is thin, so no (2N, 2N) U is built, except below
    9 rows, where only the full V holds the null vector."""
    r1, r2 = _dlt_rows(p1, p2)
    if weights is not None:
        r1 = r1 * weights[:, None]
        r2 = r2 * weights[:, None]
    a = torch.cat([r1, r2], 0)
    _, _, vt = torch.linalg.svd(a, full_matrices=a.shape[0] < 9)
    return vt[-1].reshape(3, 3)


def homography_dlt_fast(p1, p2):
    """(..., 4, 2) sample pairs -> batched unnormalised H hypotheses.

    A 4-point sample gives exactly 8 DLT rows, whose null vector comes from
    the Householder QR of ``epipolar.nullvec_8x9`` instead of an SVD per
    hypothesis. Refit the winner with ``homography_dlt``."""
    r1, r2 = _dlt_rows(p1, p2)
    q = epipolar.nullvec_8x9(torch.cat([r1, r2], -2))
    return q.reshape(q.shape[:-1] + (3, 3))


def transfer_error(H, p1, p2):
    """(..., N) symmetric transfer error of p2 ~ H p1 (both directions);
    ``H`` (..., 3, 3) batches over hypotheses."""
    def err(H, a, b):
        q = a @ H[..., :, :2].transpose(-1, -2) + H[..., None, :, 2]
        w = torch.where(torch.abs(q[..., 2]) > 1e-9, q[..., 2], 1e-9)
        return torch.sum((q[..., :2] / w[..., None] - b) ** 2, -1)

    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hi = torch.linalg.inv_ex(H + 1e-12 * eye)[0]
    return err(H, p1, p2) + err(Hi, p2, p1)


def decompose_homography(H):
    """H (3, 3) -> 8 candidate (R (8, 3, 3), t (8, 3), n (8, 3)).

    Faugeras & Lustman (1988) via the SVD H = U diag(d1, d2, d3) V^T.
    Translations are up to scale (monocular); plane normals are in the
    first camera's frame. The near-pure-rotation case (d1 ~ d3) collapses
    every candidate to (R = H / d2, t = 0)."""
    u, d, vt = torch.linalg.svd(H)
    s = epipolar._det3(u) * epipolar._det3(vt)
    d1, d3 = d[0] / d[1], d[2] / d[1]

    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - 1.0) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((1.0 - d3 * d3) / denom, min=0.0))

    # the sign pairs (e1, e3) = (1, 1), (1, -1), (-1, 1), (-1, -1), made on
    # the device by fills
    e1 = torch.ones(4, dtype=H.dtype, device=H.device)
    e1[2:] = -1.0
    e3 = torch.ones(4, dtype=H.dtype, device=H.device)
    e3[1::2] = -1.0
    zero = torch.zeros_like(e1)
    one = torch.ones_like(e1)

    def rot(c00, c02, c11, c20, c22):
        return torch.stack([c00, zero, c02, zero, c11, zero, c20, zero, c22],
                           -1).reshape(4, 3, 3)

    # d' = +d2
    st = (d1 - d3) * x1 * x3 * e1 * e3
    ct = (d1 * x3 * x3 + d3 * x1 * x1) * one
    Rp_a = rot(ct, -st, one, st, ct)
    tp_a = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3], -1)
    n_a = torch.stack([e1 * x1, zero, e3 * x3], -1)
    # d' = -d2
    sp = (d1 + d3) * x1 * x3 * e1 * e3
    cp = (d3 * x1 * x1 - d1 * x3 * x3) * one
    Rp_b = rot(cp, sp, -one, sp, -cp)
    tp_b = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3], -1)
    Rp = torch.cat([Rp_a, Rp_b])
    tp = torch.cat([tp_a, tp_b])
    nn = torch.cat([n_a, n_a])

    R = s * (u @ Rp @ vt)
    t = tp @ u.T
    n = nn @ vt                    # V @ n'

    # near-pure rotation: d1 ~ d3 ~ 1 -> H / d2 is the rotation, t ~ 0
    pure = (d1 - d3) < 1e-4
    Rr = s * ((u * torch.sign(d / d[1])) @ vt)
    R = torch.where(pure, Rr.expand(R.shape), R)
    t = torch.where(pure, 0.0, t)
    return R, t, n


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-9)


def recover_pose_homography(H, p1, p2, weights):
    """Pick the (R, t, n) candidate with the best cheirality support.

    weights (N,): inlier weights. Support = correspondences that
    triangulate with positive depth in both views. Each candidate is scored
    in its better t orientation; n is oriented by the front-majority of the
    inliers (the SVD's sign freedom makes both signs conventions). Two views
    of a plane have a two-fold (R, t, n) ambiguity, so the runner-up with a
    different rotation is returned too: (R, t, n, support, R2, t2, n2,
    support2); support2 / support near 1 means "ambiguous"."""
    R, t, n = decompose_homography(H)
    c = R.shape[0]
    p1h = torch.cat([p1, torch.ones_like(p1[:, :1])], 1)
    tn = _unit(t)[:, None, :]
    q1 = p1.expand((c,) + p1.shape)
    q2 = p2.expand((c,) + p2.shape)

    def support(sign):
        z1, z2 = epipolar.triangulate_depths(R, sign * tn, q1, q2)
        return torch.sum(((z1 > 1e-6) & (z2 > 1e-6)) * weights, -1)

    s_pos, s_neg = support(1.0), support(-1.0)
    t_signs = torch.where(s_neg > s_pos, -1.0, 1.0)
    side = p1h @ n.T                                       # (N, 8)
    n_signs = torch.where(torch.sum((side > 0.0) * weights[:, None], 0)
                          >= torch.sum((side < 0.0) * weights[:, None], 0), 1.0, -1.0)
    scores = torch.maximum(s_pos, s_neg)
    k = torch.argmax(scores).reshape(1)

    # runner-up among candidates with a different rotation (sign mirrors
    # share R and are folded into their candidate's orientation)
    same_R = torch.sum((R - R.index_select(0, k)) ** 2, (1, 2)) < 1e-6
    scores2 = torch.where(same_R, -1.0, scores)
    k2 = torch.argmax(scores2).reshape(1)

    def pick(kk):
        return (R.index_select(0, kk)[0],
                (t_signs.index_select(0, kk)[:, None] * _unit(t.index_select(0, kk)))[0],
                (n_signs.index_select(0, kk)[:, None] * n.index_select(0, kk))[0])

    r, tt, nk = pick(k)
    r2, t2, n2 = pick(k2)
    return (r, tt, nk, scores.index_select(0, k)[0], r2, t2, n2,
            torch.clamp(scores2.index_select(0, k2)[0], min=0.0))


def choose_model(oe, oh, h_ratio: float = 0.45):
    """The ORB-SLAM rule over an essential (``ransac.ransac_essential``) and
    a homography (``ransac_homography``) result on the same correspondences:
    the homography's pose when its inlier share S_H / (S_H + S_E) exceeds
    ``h_ratio``. Returns R, t (unit), inliers, num_inliers, used_homography
    and the homography's planar twin (R2, t2, ambiguous)."""
    s_e = oe["num_inliers"].to(torch.float32)
    s_h = oh["num_inliers"].to(torch.float32)
    use_h = s_h / torch.clamp(s_h + s_e, min=1.0) > h_ratio
    return {
        "R": torch.where(use_h, oh["R"], oe["R"]),
        "t": torch.where(use_h, oh["t"], _unit(oe["t"])),
        "inliers": torch.where(use_h, oh["inliers"], oe["inliers"]),
        "num_inliers": torch.where(use_h, oh["num_inliers"], oe["num_inliers"]),
        "used_homography": use_h,
        "R2": oh["R2"],
        "t2": oh["t2"],
        "ambiguous": use_h & oh["ambiguous"],
    }


def select_model(p1, p2, valid, iters: int = 256, e_threshold: float = 1.5e-3,
                 h_threshold: float = 2e-3, h_ratio: float = 0.45, *, idx_e=None,
                 idx_h=None, generator=None):
    """Two-view initialisation with E/H model selection (``choose_model``):
    both RANSACs on the same correspondences. ``idx_e`` (iters, 8) and
    ``idx_h`` (iters, 4) give their samples; those not given are drawn
    from ``generator``, E's first, then H's."""
    if idx_e is None:
        idx_e = ransac.sample_indices(valid, iters, 8, generator)
    if idx_h is None:
        idx_h = ransac.sample_indices(valid, iters, 4, generator)
    oe = ransac.ransac_essential(p1, p2, valid, iters=iters, inlier_threshold=e_threshold,
                                 idx=idx_e)
    oh = ransac_homography(p1, p2, valid, iters=iters, inlier_threshold=h_threshold,
                           idx=idx_h)
    return choose_model(oe, oh, h_ratio)


def ransac_homography(p1, p2, valid, iters: int = 256, sample_size: int = 4,
                      inlier_threshold: float = 2e-3, *, idx=None, generator=None):
    """Fixed-iteration homography RANSAC (``ransac_essential``'s shape).

    ``idx`` (iters, sample_size) gives the sample rows; without it they are
    drawn from ``generator``. Returns a dict with H, R, t (unit), n (plane
    normal, camera-1 frame), inliers, num_inliers, cheirality_support, the
    planar twin R2, t2, n2, cheirality_support2 and ambiguous.
    ``inlier_threshold`` is on sqrt(symmetric transfer error), normalised
    units."""
    if idx is None:
        idx = ransac.sample_indices(valid, iters, sample_size, generator)
    idx = idx.long()
    hs = homography_dlt_fast(p1[idx], p2[idx])            # (iters, 3, 3)
    err = transfer_error(hs, p1, p2)                       # (iters, N)
    thr2 = inlier_threshold * inlier_threshold
    inl = (err < thr2) & valid[None, :]
    scores = inl.sum(dim=1)
    best = torch.argmax(scores).reshape(1)
    inl_best = inl.index_select(0, best)[0]

    h_ref = homography_dlt(p1, p2, weights=inl_best.to(p1.dtype))
    inl_ref = (transfer_error(h_ref, p1, p2) < thr2) & valid
    better = inl_ref.sum() >= scores.index_select(0, best)[0]
    h_fin = torch.where(better, h_ref, hs.index_select(0, best)[0])
    inl_fin = torch.where(better, inl_ref, inl_best)

    r, t, n, support, r2, t2, n2, support2 = recover_pose_homography(
        h_fin, p1, p2, inl_fin.to(p1.dtype))
    return {"H": h_fin, "R": r, "t": t, "n": n, "inliers": inl_fin,
            "num_inliers": inl_fin.sum(), "cheirality_support": support,
            "R2": r2, "t2": t2, "n2": n2, "cheirality_support2": support2,
            "ambiguous": support2 > 0.75 * support}
