"""A two-plane scene rendered on the device, with exact ground-truth poses.

A textured fronto-parallel background plane at depth ``z_bg`` and a
foreground band at ``z_fg`` for parallax, seen by a camera that rolls about
its optical axis, moves sideways and dollies forward. The inverse pixel map
is analytic: a plane at depth Z maps frame pixels to texture coordinates by
the inverse roll about the principal point, an unzoom by Z / (Z - dz) and a
sideways shift of fx * sx / Z texture pixels. World -> camera:
x_c = R_z(roll) (X - c), c = (sx, 0, dz).

The same model as the JAX package's ``utils/render.py`` (a numpy renderer
that the benchmark does not import), rewritten in torch so that a whole lap
of frames is rendered on the card in a few large calls during set-up. Where
the configuration states a lens, each pixel samples the scene along its
ideal ray (``lens_rays``), so that the frame is what that lens would see.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import lens


def bilinear_sample(tex, xs, ys):
    """Bilinear samples of the (H, W) float texture at float coordinates,
    clipped to its edges."""
    h, w = tex.shape
    xs = xs.clamp(0.0, w - 1.001)
    ys = ys.clamp(0.0, h - 1.001)
    x0, y0 = xs.long(), ys.long()
    fx, fy = xs - x0, ys - y0
    flat = tex.reshape(-1)

    def at(y, x):
        return flat[y * w + x]

    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
            + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)


class PlaneScene:
    """Renders (N, H, W) uint8 frames of two textured planes.

    ``bg`` and ``fg`` are float32 textures of shape (H + 2 margin_y,
    W + 2 margin_x) on the rendering device: the frame-0 view of each plane
    with a margin for the excursions of the trajectory. ``rays``, where a
    lens bends them, is a pair of (H, W) float32 tensors: each pixel's ideal
    offset from the principal point, in pixels; without it a pixel's ray is
    its own offset."""

    def __init__(self, width: int, height: int, fx: float, fy: float, cx: float,
                 cy: float, z_bg: float, z_fg: float, margin_x: int, margin_y: int, bg, fg,
                 rays=None):
        want = (height + 2 * margin_y, width + 2 * margin_x)
        if tuple(bg.shape) != want or tuple(fg.shape) != want:
            raise ValueError(f"textures {tuple(bg.shape)}, {tuple(fg.shape)}; want {want}")
        self.w, self.h = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.z_bg, self.z_fg = z_bg, z_fg
        self.mx, self.my = margin_x, margin_y
        self.bg, self.fg = bg, fg
        self.rays = rays

    def render(self, rolls, sxs, dzs, batch: int = 32):
        """Frames for per-frame (roll rad, sx, dz) tensors on the device,
        ``batch`` frames per call."""
        dev = self.bg.device
        out = torch.empty((len(rolls), self.h, self.w), dtype=torch.uint8, device=dev)
        if self.rays is None:
            u = (torch.arange(self.w, device=dev, dtype=torch.float32) - self.cx)[None, None, :]
            v = (torch.arange(self.h, device=dev, dtype=torch.float32) - self.cy)[None, :, None]
        else:
            u, v = (r[None] for r in self.rays)
        mx, my = self.mx, self.my
        for lo in range(0, len(rolls), batch):
            th = rolls[lo:lo + batch, None, None]
            sx = sxs[lo:lo + batch, None, None]
            dz = dzs[lo:lo + batch, None, None]
            c, s = torch.cos(th), torch.sin(th)
            ru, rv = c * u + s * v, -s * u + c * v
            frame = None
            for tex, z, is_fg in ((self.bg, self.z_bg, False), (self.fg, self.z_fg, True)):
                zoom = z / (z - dz)
                tx = ru / zoom + self.fx * sx / z + self.cx + mx
                ty = rv / zoom + self.cy + my
                layer = bilinear_sample(tex, tx, ty)
                if is_fg:
                    band = (ty - my >= self.h / 4) & (ty - my < 3 * self.h / 4)
                    frame = torch.where(band, layer, frame)
                else:
                    frame = layer
            out[lo:lo + batch] = torch.round(frame).clamp(0, 255).to(torch.uint8)
        return out


def lens_rays(width: int, height: int, fx: float, fy: float, cx: float, cy: float,
              terms, device):
    """Each pixel's ideal offset from the principal point, in pixels, behind
    a lens of (k1, k2, p1, p2): its distorted normalised coordinate inverted
    in float64 (``reference/lens.undistort``, which raises where the inverse
    misses by more than 1e-9), then rounded to float32."""
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    x, y = lens.undistort((u - cx) / fx, (v - cy) / fy, *terms)
    return (torch.as_tensor((fx * x).astype(np.float32), device=device),
            torch.as_tensor((fy * y).astype(np.float32), device=device))


def poses(rolls, sxs, dzs):
    """(N, 3, 3) R and (N, 3) t, world -> camera, float64 numpy."""
    rolls, sxs, dzs = (np.asarray(a, np.float64) for a in (rolls, sxs, dzs))
    c, s = np.cos(rolls), np.sin(rolls)
    R = np.zeros((len(rolls), 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1.0
    centre = np.stack([sxs, np.zeros_like(sxs), dzs], 1)
    return R, -np.einsum("nij,nj->ni", R, centre)


def loop_trajectory(n: int, sx_amp: float, sx_cycles: int, dz_amp: float, dz_cycles: int,
                    roll_deg: float, roll_cycles: int):
    """(roll rad, sx, dz) float64 arrays of a closed loop of ``n`` frames:
    whole sine periods, so frame n would be frame 0 again and the lap replays
    without a seam. dz >= 0: the camera only dollies towards the planes."""
    ph = np.arange(n) / n
    sx = sx_amp * np.sin(2 * math.pi * sx_cycles * ph)
    dz = dz_amp * np.sin(math.pi * dz_cycles * ph) ** 2
    roll = np.deg2rad(roll_deg) * np.sin(2 * math.pi * roll_cycles * ph)
    return roll, sx, dz


def texture_pair(frames: np.ndarray, seed: int, shape, device, gain: float = 1.0):
    """Background and foreground textures of ``shape`` from crops of photo
    frames (N, h, w) uint8, chosen by the seed: two different frames, each
    cropped to the texture's aspect at a seeded offset, resized on the
    device and its contrast about its mean multiplied by ``gain`` (a
    camera's gain: the resize spreads the photo's edges over several
    pixels); the foreground is the negative (ORB is not invariant to it, so
    the two planes never share descriptors)."""
    rng = np.random.default_rng(seed)
    th, tw = shape
    n, h, w = frames.shape
    picks = rng.choice(n, size=2, replace=False)
    out = []
    for i, f in enumerate(picks):
        ch = min(h, int(w * th / tw))
        cw = min(w, int(round(ch * tw / th)))
        y0 = int(rng.integers(0, h - ch + 1))
        x0 = int(rng.integers(0, w - cw + 1))
        crop = torch.as_tensor(frames[f, y0:y0 + ch, x0:x0 + cw], device=device)
        tex = torch.nn.functional.interpolate(crop[None, None].to(torch.float32),
                                              size=(th, tw), mode="bilinear",
                                              align_corners=False)[0, 0]
        tex = ((tex - tex.mean()) * gain + tex.mean()).clamp(0.0, 255.0)
        out.append(tex if i == 0 else 255.0 - tex)
    return out[0], out[1], [int(p) for p in picks]
