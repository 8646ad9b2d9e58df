"""Rotated BRIEF (ORB) 256-bit descriptors via a rotation lookup table.

The port of ``pislam_tpu/ops/brief.py`` (reference Brief.h:28-133). The 256
learned point pairs are rotated into a (30, 256) table per point: theta =
rot*pi/15 in float32, float32 cos/sin, roundf (half away from zero), clamped
to [-15, 15]. Descriptor bit i of a keypoint with angle bin a is

    patch[idx0[a, i]] < patch[idx1[a, i]]                  (Brief.h:52)

packed as word i // 32, bit i % 32; ``words`` in 1..8 selects 32..256-bit
descriptors. Descriptor words are int32 tensors holding the u32 bit pattern.

GDIFF, the JAX package's (961, 30*256) {-1, 0, +1} matrix with column
onehot(idx1) - onehot(idx0), is kept for the dense formulation
(``_orb_compute_packed_dense``): the sign of a window's dot with a column is
the compare above.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from ._brief_pattern import BRIEF_PATTERN
from .orientation import atan2_bins, packed_moment_weights
from .patches import PATCH, RADIUS, packed_index_map, remap_weights_packed
from ..utils import codec

N_ROT = 30
N_BITS = 256
ORB_GCOLS = N_ROT * N_BITS + 128   # GDIFF + one 128-wide tile of moment columns


def _round_half_away(x):
    """C roundf: round half away from zero."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _rotation_tables():
    """(30, 256) flat patch indices for point 0 and point 1."""
    pat = np.array(BRIEF_PATTERN, np.int32)  # (256, 4): dx0, dy0, dx1, dy1
    idx0 = np.zeros((N_ROT, N_BITS), np.int32)
    idx1 = np.zeros((N_ROT, N_BITS), np.int32)
    for rot in range(N_ROT):
        theta = np.float32(rot * np.pi / 15)
        c = np.float32(np.cos(theta))
        s = np.float32(np.sin(theta))
        dx0, dy0, dx1, dy1 = (pat[:, i].astype(np.float32) for i in range(4))
        rdx0 = np.clip(_round_half_away(c * dx0 - s * dy0), -15, 15).astype(np.int32)
        rdy0 = np.clip(_round_half_away(s * dx0 + c * dy0), -15, 15).astype(np.int32)
        rdx1 = np.clip(_round_half_away(c * dx1 - s * dy1), -15, 15).astype(np.int32)
        rdy1 = np.clip(_round_half_away(s * dx1 + c * dy1), -15, 15).astype(np.int32)
        idx0[rot] = (rdy0 + RADIUS) * PATCH + (rdx0 + RADIUS)
        idx1[rot] = (rdy1 + RADIUS) * PATCH + (rdx1 + RADIUS)
    return idx0, idx1


IDX0, IDX1 = _rotation_tables()


def _diff_matrix(idx0=IDX0, idx1=IDX1) -> np.ndarray:
    """(961, 30*256) int8: column (rot*256+i) = onehot(idx1) - onehot(idx0)."""
    g = np.zeros((PATCH * PATCH, N_ROT * N_BITS), np.int8)
    for rot in range(N_ROT):
        cols = rot * N_BITS + np.arange(N_BITS)
        np.add.at(g, (idx1[rot], cols), 1)
        np.subtract.at(g, (idx0[rot], cols), 1)
    return g


GDIFF = _diff_matrix()


def _gm_packed(gdiff=GDIFF, mom_w=None) -> np.ndarray:
    """(1024, ORB_GCOLS) int8: packed-layout GDIFF, then the two packed
    moment weight columns at the head of the trailing 128-column tile."""
    g = remap_weights_packed(gdiff)
    mom_w = packed_moment_weights() if mom_w is None else mom_w
    pad = np.zeros((1024, ORB_GCOLS - g.shape[1] - 2), np.int8)
    return np.concatenate([g, mom_w, pad], axis=1)


def packed_rotation_tables(idx0=IDX0, idx1=IDX1):
    """(30, 256) r*31+c patch indices -> int16 packed-window indices."""
    pmap = packed_index_map().reshape(-1)
    return (pmap[np.asarray(idx0)].astype(np.int16),
            pmap[np.asarray(idx1)].astype(np.int16))


class OrbTables(NamedTuple):
    """The K4 kernel's constant tables, on one device."""

    idx0: torch.Tensor   # (30, 256) int16 packed indices of point 0
    idx1: torch.Tensor   # (30, 256) int16 packed indices of point 1
    mom_w: torch.Tensor  # (1024, 2) int8 packed disc-moment weights

    @staticmethod
    def build(device) -> "OrbTables":
        i0, i1 = packed_rotation_tables()
        return OrbTables(torch.as_tensor(i0, device=device),
                         torch.as_tensor(i1, device=device),
                         torch.as_tensor(packed_moment_weights(), device=device))


def _pack_bits_u8(bits, words: int):
    """(K, 256) descriptor bits -> (K, words) int32 u32 bit patterns
    (Brief.h:71-133 order)."""
    k = bits.shape[0]
    b = bits[:, : words * 32].to(torch.int64).reshape(k, words, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return codec.u32_to_i32((b << shifts).sum(dim=-1))


@functools.lru_cache(maxsize=None)
def _dense_weights(device: str) -> torch.Tensor:
    return torch.as_tensor(_gm_packed(), device=device)


def dense_weights(device) -> torch.Tensor:
    """K4d's constant (1024, 7808) int8 weights (``_gm_packed``) on a device,
    built once per device."""
    return _dense_weights(str(torch.device(device)))


def orb_compute_packed(flat, words: int = 8, variant: str = "dense"):
    """Fused orientation + descriptors from packed windows, as the JAX
    package computes them per variant (pislam_tpu/ops/brief.py:141-145):
    "sorted" through K4 (``orb_select``, 256 direct compares), "dense"
    through K4d (``orb_select_bits`` with the ``_gm_packed`` weights). The
    two give identical bits (config.py:112-121). The frontend runs neither:
    it describes from codes (``orb_describe``, ``orb_describe_dense``).

    (K, 1024) int8 windows -> ((K,) uint8 angle bins, (K, words) int32).
    """
    if variant not in ("dense", "sorted"):
        raise ValueError(f"unknown brief variant {variant!r}")
    if variant == "dense":
        angles, bits = kernels.orb_select_bits(flat, dense_weights(flat.device))
        return angles.to(torch.uint8), _pack_bits_u8(bits, words)
    return kernels.orb_select(flat, *OrbTables.build(flat.device), words)


def _orb_compute_packed_dense(flat, words: int = 8):
    """The dense all-rotations formulation: one (K, 1024) x (1024, 7682)
    product gives p1 - p0 for every rotation and the two moments, then each
    keypoint's rotation is selected. float32 is exact here: every product
    and partial sum is an integer below 2^24."""
    k = flat.shape[0]
    gm = np.concatenate([remap_weights_packed(GDIFF), packed_moment_weights()], axis=1)
    out = flat.to(torch.float32) @ torch.as_tensor(gm, device=flat.device).to(torch.float32)
    out = out.to(torch.int32)
    angles = atan2_bins(out[:, N_ROT * N_BITS], out[:, N_ROT * N_BITS + 1])
    diff = out[:, : N_ROT * N_BITS].reshape(k, N_ROT, N_BITS)
    dsel = diff[torch.arange(k, device=flat.device), angles.long()]
    return angles, _pack_bits_u8(dsel > 0, words)
