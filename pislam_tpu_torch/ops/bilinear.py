"""Bilinear pyramid downscale kernels: 7/8, 13/16, and general resize.

The port of ``pislam_tpu/ops/bilinear.py``. The fixed-ratio resamplers
reproduce the reference's fixed-point semantics (Bilinear.h:49-52, 172-180;
BilinearTest.cpp:171-233): interpolate horizontally between source columns
(c, c+1) with weights (f[x], f[last-x]), round with RSHR (round half up),
then vertically the same way. ``resize_bilinear`` is the general
fixed-point resize (half-pixel centres, 8-bit weights) that builds the
demo's round(640*(5/6)^l) level table. The numpy gather plans are copied
verbatim, so the weight tables are identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

FILTER_7_8 = np.array([238, 201, 165, 128, 91, 55, 18], np.int32)
FILTER_13_16 = np.array(
    [226, 167, 108, 49, 246, 187, 128, 69, 10, 207, 138, 89, 30], np.int32
)


def _map13(i: np.ndarray) -> np.ndarray:
    """Source-offset hole map for 13/16 (BilinearTest.cpp:198-206)."""
    i = np.asarray(i)
    i = np.where(i > 3, i + 1, i)
    i = np.where(i > 9, i + 1, i)
    return i


def _rshr8(a):
    """RSHR(a, 8): round-half-up divide by 256 (BilinearTest.cpp:35)."""
    return (a >> 8) + ((a >> 7) & 1)


def _axis_plan(n_in: int, block_in: int, block_out: int, filt: np.ndarray, holes):
    """Static gather plan for one axis: source index + weights per output idx."""
    assert n_in % block_in == 0, (
        f"dimension {n_in} must be padded to a multiple of {block_in} "
        "(reference Bilinear.h:32,:155)"
    )
    nblocks = n_in // block_in
    o = np.arange(nblocks * block_out)
    blk, off = o // block_out, o % block_out
    src_off = _map13(off) if holes else off
    idx = blk * block_in + src_off
    w0 = filt[off]
    w1 = filt[block_out - 1 - off]
    return idx, w0, w1


def _resample(img, yplan, xplan):
    """Separable 2-tap fixed-point resample: horizontal, then vertical."""
    (yi0, yi1, yw0, yw1), (xi0, xi1, xw0, xw1) = yplan, xplan
    dev = img.device

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    x = img.to(torch.int32)
    hrow = _rshr8(x.index_select(-1, t(xi0).long()) * t(xw0)
                  + x.index_select(-1, t(xi1).long()) * t(xw1))
    return _rshr8(hrow.index_select(-2, t(yi0).long()) * t(yw0)[:, None]
                  + hrow.index_select(-2, t(yi1).long()) * t(yw1)[:, None])


def _downscale(img, block_in: int, block_out: int, filt: np.ndarray, holes: bool):
    h, w = img.shape[-2], img.shape[-1]
    yidx, yw0, yw1 = _axis_plan(h, block_in, block_out, filt, holes)
    xidx, xw0, xw1 = _axis_plan(w, block_in, block_out, filt, holes)
    out = _resample(img, (yidx, yidx + 1, yw0, yw1), (xidx, xidx + 1, xw0, xw1))
    return out.to(torch.uint8)


def bilinear7_8(img):
    """(..., H, W) uint8 -> (..., H*7//8, W*7//8); H, W multiples of 8."""
    return _downscale(img, 8, 7, FILTER_7_8, holes=False)


def bilinear13_16(img):
    """(..., H, W) uint8 -> (..., H*13//16, W*13//16); H, W multiples of 16."""
    return _downscale(img, 16, 13, FILTER_13_16, holes=True)


def resize_bilinear(img, out_h: int, out_w: int):
    """General fixed-point bilinear resize with half-pixel-centred sampling:
    src = (dst + 0.5) * scale - 0.5, clamped, 8-bit fixed-point weights and
    round-half-up (the JAX package's convention, deterministic and exact)."""
    h, w = img.shape[-2], img.shape[-1]

    def plan(n_in, n_out):
        scale = n_in / n_out
        src = (np.arange(n_out) + 0.5) * scale - 0.5
        src = np.clip(src, 0.0, n_in - 1)
        i0 = np.floor(src).astype(np.int32)
        i0 = np.clip(i0, 0, n_in - 2) if n_in > 1 else np.zeros_like(i0)
        frac = np.round((src - i0) * 256.0).astype(np.int32)
        return i0, 256 - frac, frac

    yi, yw0, yw1 = plan(h, out_h)
    xi, xw0, xw1 = plan(w, out_w)
    out = _resample(img, (yi, np.minimum(yi + 1, h - 1), yw0, yw1),
                    (xi, np.minimum(xi + 1, w - 1), xw0, xw1))
    return out.clamp(0, 255).to(torch.uint8)
