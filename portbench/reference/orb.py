"""The plain ORB frontend and Hamming matcher that the benchmark holds the
port to: stacked pyramid, FAST-9, Harris, 3x3 NMS, top-k by code, intensity
centroid orientation, rotated BRIEF-256, normalised points and the mutual
ratio-tested match.

A frozen copy of the port's plain path (its CPU versions of K1, K2 and
``orb_describe``, and its plain ``match_reduce``), in plain torch and numpy,
so that it imports nothing of the port. Every step is integer-exact, as in
the reference ORB (Gaussian.h, Bilinear.h, Fast.h, Harris.h, Orb.h,
Brief.h): the port must reproduce it bit for bit. ``precision="bfloat16"``
resamples the pyramid in bfloat16 instead of 8-bit fixed point: the control
that a correct comparison has to reject.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lens as lens_model
from .brief_pattern import BRIEF_PATTERN

RADIUS = 15
PATCH = 2 * RADIUS + 1
U32 = 0xFFFFFFFF
INT32_MIN = -(1 << 31)
MAX_DIST = 1 << 14


# -- pyramid ----------------------------------------------------------------

def level_sizes(w: int, h: int, levels: int, inv_scale: float):
    """The demo's level table: round(base * inv_scale ** level)."""
    return [(int(round(w * inv_scale ** lvl)), int(round(h * inv_scale ** lvl)))
            for lvl in range(levels)]


def _reflect101(n: int, pad: int, device):
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _rhadd(a, b):
    return (a + b + 1) >> 1


def gaussian5x5(img):
    """The exact vrhadd binomial blur, reflect-101 borders."""
    h, w = img.shape
    x = img.to(torch.int32)
    x = x.index_select(0, _reflect101(h, 2, img.device))
    x = x.index_select(1, _reflect101(w, 2, img.device))
    for dim in (0, 1):
        n = x.shape[dim] - 4
        a, b, c, d, e = (x.narrow(dim, k, n) for k in range(5))
        x = _rhadd(_rhadd(_rhadd(_rhadd(a, e), c), c), _rhadd(b, d))
    return x.to(torch.uint8)


def _resize_plan(n_in: int, n_out: int):
    scale = n_in / n_out
    src = np.clip((np.arange(n_out) + 0.5) * scale - 0.5, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int32)
    i0 = np.clip(i0, 0, n_in - 2) if n_in > 1 else np.zeros_like(i0)
    frac = np.round((src - i0) * 256.0).astype(np.int32)
    return i0, np.minimum(i0 + 1, n_in - 1), 256 - frac, frac


def resize_bilinear(img, out_h: int, out_w: int, precision: str = "exact"):
    """Half-pixel-centred bilinear resize with 8-bit weights and
    round-half-up, horizontal then vertical."""
    h, w = img.shape
    dev = img.device
    yi0, yi1, yw0, yw1 = (torch.as_tensor(a, device=dev) for a in _resize_plan(h, out_h))
    xi0, xi1, xw0, xw1 = (torch.as_tensor(a, device=dev) for a in _resize_plan(w, out_w))
    if precision == "bfloat16":
        x = img.to(torch.bfloat16)
        hrow = (x.index_select(1, xi0.long()) * (xw0 / 256).to(torch.bfloat16)
                + x.index_select(1, xi1.long()) * (xw1 / 256).to(torch.bfloat16))
        out = (hrow.index_select(0, yi0.long()) * (yw0 / 256).to(torch.bfloat16)[:, None]
               + hrow.index_select(0, yi1.long()) * (yw1 / 256).to(torch.bfloat16)[:, None])
        return torch.round(out.float()).clamp(0, 255).to(torch.uint8)

    def rshr8(a):
        return (a >> 8) + ((a >> 7) & 1)

    x = img.to(torch.int32)
    hrow = rshr8(x.index_select(1, xi0.long()) * xw0 + x.index_select(1, xi1.long()) * xw1)
    out = rshr8(hrow.index_select(0, yi0.long()) * yw0[:, None]
                + hrow.index_select(0, yi1.long()) * yw1[:, None])
    return out.clamp(0, 255).to(torch.uint8)


def build_pyramid(frame, sizes, padded_height: int, stride: int,
                  precision: str = "exact"):
    """(h, w) uint8 frame -> the (padded_height, stride) stacked pyramid."""
    levels = [frame]
    for w, h in sizes[1:]:
        levels.append(resize_bilinear(gaussian5x5(levels[-1]), h, w, precision))
    out = torch.zeros((padded_height, stride), dtype=torch.uint8, device=frame.device)
    row = 0
    for img, (w, h) in zip(levels, sizes):
        out[row:row + h, :w] = img
        row += h
    return out


def level_mask(sizes, padded_height: int, stride: int, border: int):
    m = np.zeros((padded_height, stride), bool)
    row = 0
    for w, h in sizes:
        m[row + border:row + h - border, border:w - border] = True
        row += h
    return m


# -- FAST-9, Harris, NMS, top-k ---------------------------------------------

RING = ((-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
        (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2))


def _shift(a, dy: int, dx: int):
    """out[y, x] = a[y + dy, x + dx], wrapping: wrapped values land in the
    border, which the level mask removes."""
    return torch.roll(a, shifts=(-dy, -dx), dims=(-2, -1))


def _run9(bits):
    r = bits | (bits << 16)
    r = r & (r >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)
    r = r & (r >> 1)
    return (r & 0xFFFF) != 0


def fast9(img, threshold: int):
    c = img.to(torch.int32)
    dark = torch.zeros_like(c)
    light = torch.zeros_like(c)
    for p, (dy, dx) in enumerate(RING):
        s = _shift(c, dy, dx)
        dark |= (s < c - threshold).to(torch.int32) << p
        light |= (s > c + threshold).to(torch.int32) << p
    return _run9(dark) | _run9(light)


def _window6(a):
    acc = a
    for u in (-2, -1, 1, 2, 3):
        acc = acc + _shift(a, 0, u)
    out = acc
    for v in (-2, -1, 1, 2, 3):
        out = out + _shift(acc, v, 0)
    return out


def harris_score(img, threshold: int, mask):
    """Quarter-float Harris score where the mask holds and the response
    exceeds the threshold, else 0 (uint32 wrap-around as the reference)."""
    x = img.to(torch.int32)
    hd = (_shift(x, 0, 1) - _shift(x, 0, -1)) >> 1
    vd = (_shift(x, 1, 0) - _shift(x, -1, 0)) >> 1
    dx = ((((_shift(hd, -1, 0) + _shift(hd, 1, 0)) >> 1) + hd) >> 1)
    dy = ((((_shift(vd, 0, -1) + _shift(vd, 0, 1)) >> 1) + vd) >> 1)
    ixx = (_window6(dx * dx) >> 4).to(torch.int64)
    iyy = (_window6(dy * dy) >> 4).to(torch.int64)
    ixy = (_window6(dx * dy) >> 4).to(torch.int64)
    tr = ixx + iyy
    score = ((ixx * iyy - ixy * ixy) & U32) - (((tr * tr) & U32) >> 4)
    score = score & U32
    score = torch.where(score >= 1 << 31, score - (1 << 32), score).to(torch.int32)
    qf = ((score.to(torch.float32).view(torch.int32) >> 20) & 0xFF).to(torch.uint8)
    return torch.where((score > threshold) & mask, qf, torch.zeros_like(qf))


def nms_keep(s):
    ge = [s >= _shift(s, dy, dx) for dy, dx in ((-1, -1), (-1, 0), (-1, 1), (0, -1))]
    gt = [s > _shift(s, dy, dx) for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1))]
    keep = s > 0
    for m in ge + gt:
        keep = keep & m
    return keep


def top_codes(score, keep, k: int):
    """Codes score<<24 | x<<12 | y of the survivors, the k largest first
    (int64 holding the u32 value), and their validity."""
    h, w = score.shape
    ys = torch.arange(h, dtype=torch.int64, device=score.device)[:, None]
    xs = torch.arange(w, dtype=torch.int64, device=score.device)[None, :]
    enc = (score.to(torch.int64) << 24) | (xs << 12) | ys
    enc = torch.where(keep, enc, torch.zeros_like(enc)).reshape(-1)
    if enc.numel() < k:
        enc = torch.cat([enc, enc.new_zeros(k - enc.numel())])
    codes = torch.topk(enc, k).values
    return codes, codes != 0


# -- orientation and rotated BRIEF ------------------------------------------

VMAX = np.array([15, 15, 15, 15, 15, 15, 14, 14, 13, 13, 12, 11, 10, 9, 7, 5])
_C0 = np.float32(256 * 14.999998)
_C1 = np.float32(256 * 4.723436)
_C2 = np.float32(256 * 1.266240)


def _round_half_away(x):
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


def _tables():
    """(30, 256) window indices r*31+c of each rotation's point pairs, and
    the (961, 2) disc-moment weights [x, y]."""
    pat = np.array(BRIEF_PATTERN, np.int32)
    idx0 = np.zeros((30, 256), np.int64)
    idx1 = np.zeros((30, 256), np.int64)
    for rot in range(30):
        theta = np.float32(rot * np.pi / 15)
        c, s = np.float32(np.cos(theta)), np.float32(np.sin(theta))
        dx0, dy0, dx1, dy1 = (pat[:, i].astype(np.float32) for i in range(4))

        def rnd(v):
            return np.clip(_round_half_away(v), -15, 15).astype(np.int64)

        idx0[rot] = (rnd(s * dx0 + c * dy0) + RADIUS) * PATCH + rnd(c * dx0 - s * dy0) + RADIUS
        idx1[rot] = (rnd(s * dx1 + c * dy1) + RADIUS) * PATCH + rnd(c * dx1 - s * dy1) + RADIUS
    d = np.arange(-RADIUS, RADIUS + 1)
    disc = np.abs(d[:, None]) <= VMAX[np.clip(np.abs(d[None, :]), 0, 15)]
    mom = np.stack([(disc * d[None, :]).reshape(-1), (disc * d[:, None]).reshape(-1)], 1)
    return idx0, idx1, mom.astype(np.int64)


IDX0, IDX1, MOMENTS = _tables()


def atan2_bins(m10, m01):
    """Integer disc moments -> orientation bin in [0, 30), the reference's
    two-term polynomial one float32 operation at a time."""
    x, y = m10.to(torch.int32), m01.to(torch.int32)
    xf, yf = x.to(torch.float32).abs(), y.to(torch.float32).abs()
    zmax, zmin = torch.maximum(xf, yf), torch.minimum(xf, yf)
    z = zmin / zmax.clamp_min(float(np.float32(1e-30)))
    poly = float(_C1) + float(_C2) * z
    angle = (z * (float(_C0) - (z - 1.0) * poly)).to(torch.int32)
    differ = (x < 0) ^ (y < 0)
    a1 = torch.where(differ, -angle, angle)
    a1 = torch.where(x < 0, a1 + 256 * 60, torch.where(a1 < 0, a1 + 256 * 120, a1))
    a2 = torch.where(differ, angle, -angle)
    a2 = torch.where(y >= 0, a2 + 256 * 30, a2 + 256 * 90)
    out = torch.where(x.abs() > y.abs(), a1, a2) >> 10
    return torch.where((out >= 0) & (out < 30) & (zmax > 0), out, 0).to(torch.uint8)


def describe(img, codes, valid, words: int):
    """Angle bins and (K, words) int32 descriptor words (u32 bit patterns)
    at the codes' (x, y); invalid keypoints get bin 0 and zero words."""
    h, w = img.shape
    dev = img.device
    xs = (codes >> 12) & 0xFFF
    ys = codes & 0xFFF
    sx = torch.where(valid, xs, RADIUS + 1).clamp(RADIUS, w - RADIUS - 2) - RADIUS
    sy = torch.where(valid, ys, RADIUS + 1).clamp(RADIUS, h - RADIUS - 2) - RADIUS
    r = torch.arange(PATCH, device=dev)
    win = img[(sy[:, None] + r)[:, :, None], (sx[:, None] + r)[:, None, :]]
    flat = win.reshape(-1, PATCH * PATCH).to(torch.int32) - 128
    mom = torch.as_tensor(MOMENTS, device=dev, dtype=torch.int32)
    m10 = (flat * mom[:, 0]).sum(1, dtype=torch.int32)
    m01 = (flat * mom[:, 1]).sum(1, dtype=torch.int32)
    angles = atan2_bins(m10, m01)
    a = angles.long()
    p0 = flat.gather(1, torch.as_tensor(IDX0, device=dev)[a])
    p1 = flat.gather(1, torch.as_tensor(IDX1, device=dev)[a])
    bits = (p0 < p1)[:, :words * 32].to(torch.int64).reshape(-1, words, 32)
    words_u32 = (bits << torch.arange(32, dtype=torch.int64, device=dev)).sum(-1)
    desc = torch.where(words_u32 >= 1 << 31, words_u32 - (1 << 32), words_u32).to(torch.int32)
    return (torch.where(valid, angles, torch.zeros_like(angles)),
            torch.where(valid[:, None], desc, torch.zeros_like(desc)))


class Frame(NamedTuple):
    codes: torch.Tensor        # (K,) int64 u32 codes, strongest first
    valid: torch.Tensor        # (K,) bool
    angles: torch.Tensor       # (K,) uint8 orientation bins
    descriptors: torch.Tensor  # (K, words) int32
    pts: torch.Tensor          # (K, 2) float32 normalised level-0 coordinates


class Frontend:
    """frame (h, w) uint8 -> ``Frame`` for one deployment's settings. With a
    ``lens`` (k1, k2, p1, p2), the normalised points are undistorted by its
    inverse solved to convergence in float64 (``lens.undistort``), then
    rounded to float32."""

    def __init__(self, width: int, height: int, levels: int, inv_scale: float,
                 max_keypoints: int, fast_threshold: int, harris_threshold: int,
                 border: int, words: int, intrinsics, device, precision: str = "exact",
                 lens=None):
        self.sizes = level_sizes(width, height, levels, inv_scale)
        total = sum(h for _, h in self.sizes)
        self.padded_height = -(-total // 8) * 8
        self.stride = -(-width // 128) * 128
        self.mask = torch.as_tensor(level_mask(self.sizes, self.padded_height,
                                               self.stride, border), device=device)
        self.k, self.fast_t, self.harris_t, self.words = (max_keypoints, fast_threshold,
                                                          harris_threshold, words)
        rows, y = [], 0
        for _, h in self.sizes:
            rows.append(y)
            y += h
        self.rows = torch.tensor(rows, dtype=torch.int32, device=device)
        self.scales = torch.tensor([width / w for w, _ in self.sizes], dtype=torch.float32,
                                   device=device)
        fx, fy, cx, cy = (float(v) for v in intrinsics)
        lane = torch.arange(2, device=device)
        self.centre = torch.where(lane == 0, cx, cy).to(torch.float32)
        self.focal = torch.where(lane == 0, fx, fy).to(torch.float32)
        self.precision = precision
        self.lens = lens

    def pyramid(self, frame):
        return build_pyramid(frame, self.sizes, self.padded_height, self.stride,
                             self.precision)

    def __call__(self, frame) -> Frame:
        img = self.pyramid(frame)
        score = harris_score(img, self.harris_t, fast9(img, self.fast_t) & self.mask)
        keep = nms_keep(score)
        codes, valid = top_codes(score, keep, self.k)
        angles, desc = describe(img, codes, valid, self.words)
        ys = (codes & 0xFFF).to(torch.int32)
        xs = ((codes >> 12) & 0xFFF).to(torch.int32)
        lvl = torch.sum(ys[:, None] >= self.rows[None, :], dim=1) - 1
        scale = self.scales[lvl]
        uv = torch.stack([xs.to(torch.float32) * scale,
                          (ys - self.rows[lvl]).to(torch.float32) * scale], dim=1)
        pts = (uv - self.centre) / self.focal
        if self.lens is not None:
            p = pts.detach().cpu().numpy()
            x, y = lens_model.undistort(p[:, 0], p[:, 1], *self.lens)
            pts = torch.as_tensor(np.stack([x, y], 1).astype(np.float32), device=pts.device)
        return Frame(codes, valid, angles, desc, pts)


# -- matching ---------------------------------------------------------------

def hamming(d1, v1, d2, v2):
    """(K1, K2) int32 Hamming distances, MAX_DIST where either is invalid."""
    shifts = torch.arange(32, dtype=torch.int64, device=d1.device)
    b1 = ((d1.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(d1.shape[0], -1)
    b2 = ((d2.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(d2.shape[0], -1)
    dot = (2 * b1 - 1).to(torch.float32) @ (2 * b2 - 1).to(torch.float32).T
    dist = (b1.shape[1] - dot.to(torch.int32)) >> 1
    dist = torch.where(v1[:, None], dist, MAX_DIST)
    return torch.where(v2[None, :], dist, MAX_DIST)


def match(d1, v1, d2, v2, max_distance: int, ratio: float, cross_check: bool = True):
    """idx2 (K1,) int32: frame-1 keypoint i -> frame-2 keypoint, or -1.
    Best distance at most ``max_distance``, below ``ratio`` x the second
    best, and (with ``cross_check``) i the best of its match's column."""
    dist = hamming(d1, v1, d2, v2)
    best_idx = torch.argmin(dist, dim=1)
    best = dist.amin(dim=1)
    cols = torch.arange(dist.shape[1], device=dist.device)
    second = torch.where(cols == best_idx[:, None], MAX_DIST, dist).amin(dim=1)
    ok = (best <= max_distance) & (best.to(torch.float32)
                                   < torch.tensor(ratio, dtype=torch.float32)
                                   * second.to(torch.float32))
    if cross_check:
        col_best = torch.argmin(dist, dim=0)
        ok &= col_best[best_idx] == torch.arange(dist.shape[0], device=dist.device)
    ok &= v1
    return torch.where(ok, best_idx.to(torch.int32), -1)
