"""RANSAC essential-matrix estimation as a batched top-1.

The port of ``pislam_tpu/geometry/ransac.py``: sample ``iters`` 8-tuples at
once, solve every hypothesis without SVD (``essential_8pt_fast``), score all
of them against all correspondences with one (iters, N) Sampson evaluation,
take the first best, refit on its inliers with the exact SVD path, and
recover the pose. Nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch

from . import epipolar


def sample_indices(valid, iters: int, sample_size: int, generator=None):
    """(iters, sample_size) int64 row indices, uniform with replacement over
    the valid rows, as ``jax.random.categorical`` draws them from logits of
    0 (valid) and -inf. With no valid row every index is 0, where the JAX
    draw lands too. The draws themselves differ from ``jax.random``'s."""
    n = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid rows first
    u = torch.rand((iters, sample_size), generator=generator, device=valid.device)
    pick = torch.minimum((u * n).long(), torch.clamp(n - 1, min=0))
    return order[pick]


def ransac_essential(p1, p2, valid, iters: int = 256, sample_size: int = 8,
                     inlier_threshold: float = 1.5e-3, *, idx=None,
                     generator=None):
    """p1, p2: (N, 2) normalised correspondences; valid: (N,) bool.

    ``idx`` (iters, sample_size) gives the sample rows; without it they are
    drawn from ``generator`` (``sample_indices``). Returns a dict with E
    (3, 3), R (3, 3), t (3,), inliers (N,) bool, num_inliers (int64) and
    cheirality_support.
    """
    if idx is None:
        idx = sample_indices(valid, iters, sample_size, generator)
    idx = idx.long()
    es = epipolar.essential_8pt_fast(p1[idx], p2[idx])        # (iters, 3, 3)
    err = epipolar.sampson_error(es, p1, p2)                   # (iters, N)
    inl = (err < inlier_threshold) & valid[None, :]
    scores = inl.sum(dim=1)
    # first maximum; a (1,) index, since indexing by a 0-dim tensor reads it
    # back to the host
    best = torch.argmax(scores).reshape(1)
    inl_best = inl.index_select(0, best)[0]

    # refit on the winning inlier set (weighted 8-point over all N)
    e_ref = epipolar.essential_8pt(p1, p2, weights=inl_best.to(p1.dtype))
    inl_ref = (epipolar.sampson_error(e_ref, p1, p2) < inlier_threshold) & valid
    # keep whichever of (refit, best sample) has more support
    better = inl_ref.sum() >= scores.index_select(0, best)[0]
    e_fin = torch.where(better, e_ref, es.index_select(0, best)[0])
    inl_fin = torch.where(better, inl_ref, inl_best)

    r, t, support = epipolar.recover_pose(e_fin, p1, p2, inl_fin.to(p1.dtype))
    return {"E": e_fin, "R": r, "t": t, "inliers": inl_fin,
            "num_inliers": inl_fin.sum(), "cheirality_support": support}
