"""Per-keypoint packed 32x32 windows.

The port of ``pislam_tpu/ops/patches.py``. A window (rows y-15..y+16, cols
x-15..x+16) is stored as 1024 bytes with byte (r, c) at index
(r >> 2) * 128 + c * 4 + (r & 3), as int8 pixel - 128 (an order-preserving
bijection of uint8). Disc moments (zero-sum weights) and BRIEF compares are
both offset-invariant. Consumers remap their weight tables to this layout,
so no transpose ever materialises.
"""

from __future__ import annotations

import numpy as np


RADIUS = 15
PATCH = 2 * RADIUS + 1  # 31


def packed_index_map() -> np.ndarray:
    """(31, 31) -> flat packed index for weight-matrix remapping."""
    r = np.arange(31)[:, None]
    c = np.arange(31)[None, :]
    return (r >> 2) * 128 + c * 4 + (r & 3)


def remap_weights_packed(w961):
    """(961, n) weight matrix over r*31+c -> (1024, n) over packed layout."""
    w961 = np.asarray(w961)
    out = np.zeros((1024,) + w961.shape[1:], w961.dtype)
    out[packed_index_map().reshape(-1)] = w961
    return out
