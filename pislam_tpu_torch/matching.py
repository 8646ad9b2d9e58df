"""Brute-force Hamming descriptor matching.

The port of ``pislam_tpu/matching.py``. Descriptors are (K, words) int32
tensors holding the u32 words' bit patterns (``Features.descriptors``). On
a CUDA tensor ``match`` and ``match_gated`` reduce the distances with the
K5 Hopper kernel (``ops/kernels.match_reduce``, ``csrc/match_reduce.cu``: an
int8 ``wgmma`` tensor-core product of the descriptors' +-1 expansions, the
Hamming distance (32 words - dot) >> 1), so the (K1, K2) matrix never
exists; on the CPU they take its plain version, the dense matrix below. Both give the JAX package's values:
first-occurrence argmins, a duplicate of the best counting as second,
invalid slots at ``MAX_DIST``, the Lowe ratio test in float32 and the
mutual cross-check through the column argmin.
"""

from __future__ import annotations

import torch

from .ops import kernels

MAX_DIST = 1 << 14  # sentinel > any real Hamming distance (<= 256)


def expand_pm1(desc):
    """(K, words) int32 packed bits -> (K, words*32) int8 in {-1, +1}."""
    k, words = desc.shape
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return (2 * bits - 1).reshape(k, words * 32).to(torch.int8)


def _dot_pm1(a, b):
    """(M, n) x (N, n) int8 +-1 -> (M, N) int32 dot products.

    A float32 product: every term is +-1 and |dot| <= 256, so it is exact
    (int8 @ int8 in torch wraps, and CUDA has no int32 matmul).
    """
    return (a.to(torch.float32) @ b.to(torch.float32).T).to(torch.int32)


def hamming_matrix(desc1, desc2, valid1=None, valid2=None):
    """(K1, w), (K2, w) packed descriptors -> (K1, K2) int32 Hamming distances."""
    nbits = desc1.shape[1] * 32
    dist = (nbits - _dot_pm1(expand_pm1(desc1), expand_pm1(desc2))) >> 1
    if valid1 is not None:
        dist = torch.where(valid1[:, None], dist, MAX_DIST)
    if valid2 is not None:
        dist = torch.where(valid2[None, :], dist, MAX_DIST)
    return dist


def gate(dist, uv1, uv2, radius: float):
    """Pin pairs farther than ``radius`` apart on the normalised plane to
    MAX_DIST: dx*dx + dy*dy <= r2 in float32, r2 the float32 rounding of the
    double radius*radius, as the JAX package computes it."""
    d = uv1[:, None, :] - uv2[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    r2 = torch.tensor(float(radius) * float(radius), dtype=torch.float32)
    return torch.where(d2 <= r2, dist, MAX_DIST)


def _best_two(dist):
    """Row-wise (best_idx, best, second_best) of a distance matrix, int32."""
    best_idx = torch.argmin(dist, dim=-1)          # first occurrence
    best = dist.amin(dim=-1)
    cols = torch.arange(dist.shape[-1], device=dist.device)
    masked = torch.where(cols == best_idx[..., None], MAX_DIST, dist)
    return best_idx.to(torch.int32), best, masked.amin(dim=-1)


def _filter(best, second, idx2, rbest_idx, valid1, max_distance, ratio,
            cross_check):
    ok = best <= max_distance
    ok &= best.to(torch.float32) < torch.tensor(ratio, dtype=torch.float32) * second.to(torch.float32)
    if cross_check:
        rows = torch.arange(idx2.shape[-1], device=idx2.device)
        ok &= rbest_idx.gather(-1, idx2.long()) == rows
    ok &= valid1
    return torch.where(ok, idx2, -1), torch.where(ok, best, MAX_DIST)


def match(desc1, desc2, valid1, valid2, max_distance: int = 64,
          ratio: float = 0.8, cross_check: bool = True,
          reduce=kernels.match_reduce):
    """Match descriptors frame1 -> frame2.

    Returns (idx2 (K1,) int32 with -1 for unmatched, dist (K1,) int32).
    Filters: Hamming <= max_distance, Lowe ratio best < ratio*second,
    and optional mutual-best cross-check. ``reduce`` is K5's wrapper, or
    ``kernels.match_reduce_plain`` to run the plain version on any device.
    """
    best, second, idx2, col = reduce(desc1, desc2, valid1, valid2)
    return _filter(best, second, idx2, col, valid1, max_distance, ratio,
                   cross_check)


def match_gated(desc1, desc2, valid1, valid2, uv1, uv2, radius: float,
                max_distance: int = 64, ratio: float = 0.8,
                cross_check: bool = True, reduce=kernels.match_reduce):
    """Projection-gated matching: only pairs within ``radius`` of each other
    on the normalised image plane are candidates. uv1 (K1, 2), uv2 (K2, 2)
    float32; inf or large values exclude a point. The gate runs inside K5
    on the card."""
    best, second, idx2, col = reduce(desc1, desc2, valid1, valid2,
                                     uv1.to(torch.float32), uv2.to(torch.float32),
                                     float(radius))
    return _filter(best, second, idx2, col, valid1, max_distance, ratio,
                   cross_check)


def match_many(descs, valids, desc2, valid2, max_distance: int = 64,
               ratio: float = 0.8, cross_check: bool = True):
    """Match a whole keyframe store against one query frame at once.

    descs (F, K1, words), valids (F, K1); desc2/valid2 (K2, words)/(K2,).
    Returns (idx2 (F, K1) int32 with -1 unmatched, counts (F,) int32) with
    the per-keyframe semantics of ``match``. The JAX package has no kernel
    here: one float32 product of the +-1 expansions on any device.
    """
    f, k1, words = descs.shape
    dist = hamming_matrix(descs.reshape(f * k1, words), desc2).reshape(f, k1, -1)
    dist = torch.where(valids[:, :, None], dist, MAX_DIST)
    dist = torch.where(valid2[None, None, :], dist, MAX_DIST)
    best_idx, best, second = _best_two(dist)
    col_best = torch.argmin(dist, dim=1).to(torch.int32)    # (F, K2)
    idx2, _ = _filter(best, second, best_idx, col_best, valids, max_distance,
                      ratio, cross_check)
    return idx2, (idx2 >= 0).sum(dim=1, dtype=torch.int32)


def match_features(f1, f2, cfg):
    """Convenience wrapper over Features pairs (frontend.Features)."""
    return match(f1.descriptors, f2.descriptors, f1.valid, f2.valid,
                 max_distance=cfg.matcher.max_distance, ratio=cfg.matcher.ratio,
                 cross_check=cfg.matcher.cross_check)
