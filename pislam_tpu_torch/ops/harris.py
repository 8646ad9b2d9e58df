"""Harris corner scoring with the reference's exact integer semantics, dense.

The port of ``pislam_tpu/ops/harris.py`` (reference Harris.h:37-248):

  hd = (img[y,x+1] - img[y,x-1]) >> 1,  vd = (img[y+1,x] - img[y-1,x]) >> 1
  dx = hadd(hadd(hd[y-1], hd[y+1]), hd[y]),  dy likewise along x
  Sxx/Syy/Sxy = sums over the 6x6 window {y-2..y+3} x {x-2..x+3}
  Ixx = Sxx >> 4, Iyy = Syy >> 4, Ixy = Sxy >> 4 (arithmetic)
  score = int32(uint32(Ixx*Iyy - Ixy*Ixy) - (uint32((Ixx+Iyy)^2) >> 4))
  qf    = score > threshold ? (f32bits(score) >> 20) & 0xff : 0

The uint32 wrap-around is computed in int64 and masked to 32 bits: torch has
no uint32 multiply or shift on the CPU.
"""

from __future__ import annotations

import torch

from .fast import shift2d

_U32 = 0xFFFFFFFF


def _hadd(a, b):
    """vhadd_s8: (a + b) >> 1 arithmetic (floor)."""
    return (a + b) >> 1


def _window6_sum(a):
    """Sum over the 6x6 window of offsets {-2..3} x {-2..3} (Harris.h:216-239)."""
    acc = a
    for u in (-2, -1, 1, 2, 3):
        acc = acc + shift2d(a, 0, u)
    acc2 = acc
    for v in (-2, -1, 1, 2, 3):
        acc2 = acc2 + shift2d(acc, v, 0)
    return acc2


def harris_response(img):
    """(..., H, W) uint8 -> int32 Harris response (det - trace^2/16)."""
    x = img.to(torch.int32)
    hd = (shift2d(x, 0, 1) - shift2d(x, 0, -1)) >> 1
    vd = (shift2d(x, 1, 0) - shift2d(x, -1, 0)) >> 1
    dx = _hadd(_hadd(shift2d(hd, -1, 0), shift2d(hd, 1, 0)), hd)
    dy = _hadd(_hadd(shift2d(vd, 0, -1), shift2d(vd, 0, 1)), vd)

    ixx = (_window6_sum(dx * dx) >> 4).to(torch.int64)
    iyy = (_window6_sum(dy * dy) >> 4).to(torch.int64)
    ixy = (_window6_sum(dx * dy) >> 4).to(torch.int64)  # signed, Harris.h:245

    trace = ixx + iyy
    trace2 = ((trace * trace) & _U32) >> 4            # uint32 wrap (Harris.h:41-43)
    det = (ixx * iyy - ixy * ixy) & _U32              # == u32(ixy)^2 mod 2^32
    score = (det - trace2) & _U32
    return torch.where(score >= 1 << 31, score - (1 << 32), score).to(torch.int32)


def quarter_float(score_i32):
    """int32 score -> uint8 quarter-precision float (Harris.h:58-66)."""
    bits = score_i32.to(torch.float32).view(torch.int32)
    return ((bits >> 20) & 0xFF).to(torch.uint8)


def harris_score(img, threshold: int, mask=None):
    """Dense fastScoreHarris (Fast.h:166-180): uint8 quarter-float score map,
    qf(score) where (mask & (score > threshold)), else 0."""
    score = harris_response(img)
    keep = score > threshold
    if mask is not None:
        keep = keep & mask
    return torch.where(keep, quarter_float(score), torch.zeros((), dtype=torch.uint8,
                                                                 device=img.device))
