"""Gaussian 5x5 binomial blur, integer-exact RHADD semantics.

The port of ``pislam_tpu/ops/gaussian.py`` (reference Gaussian.h:51-72). Per
axis, with (a, b, c, d, e) the pixels at offsets -2..+2 and RHADD(a, b) =
(a + b + 1) >> 1:

    out = RHADD(RHADD(RHADD(RHADD(a, e), c), c), RHADD(b, d))

Borders reflect-101 (index -1 -> 1, -2 -> 2, h -> h-2, h+1 -> h-3). torch's
reflect padding does not take 2-D uint8 tensors, so the reflection is a
gather through precomputed indices.
"""

from __future__ import annotations

import torch


def _rhadd(a, b):
    """vrhadd: (a + b + 1) >> 1."""
    return (a + b + 1) >> 1


def _rhadd_chain(a, b, c, d, e):
    """The exact vrhadd rewriting of [1 4 6 4 1]/16 (Gaussian.h:51-72)."""
    x = _rhadd(a, e)
    y = _rhadd(b, d)
    x = _rhadd(x, c)
    x = _rhadd(x, c)
    return _rhadd(x, y)


def reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a reflect-101 padded axis: [pad, ..., 1, 0, 1, ..., n-1,
    n-2, ...]."""
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _shifts(x, dim: int):
    """The five offset views (-2..+2) along ``dim`` of a 2-padded tensor."""
    n = x.shape[dim] - 4
    return tuple(x.narrow(dim, k, n) for k in range(5))


def gaussian5x5(img):
    """Blur a (..., H, W) uint8 image; byte-exact vs the reference.

    Vertical pass then horizontal pass (GaussianTest.cpp:159-215). Reflection
    in x commutes with blurring in y, so one 2-D reflect serves both passes.
    Needs H >= 3 and W >= 3.
    """
    h, w = img.shape[-2], img.shape[-1]
    x = img.to(torch.int32)
    x = x.index_select(-2, reflect101_index(h, 2, img.device))
    x = x.index_select(-1, reflect101_index(w, 2, img.device))
    x = _rhadd_chain(*_shifts(x, -2))   # (..., H, W+4)
    x = _rhadd_chain(*_shifts(x, -1))   # (..., H, W)
    return x.to(torch.uint8)
