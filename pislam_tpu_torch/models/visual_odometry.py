"""Frame-to-frame visual odometry.

The port of ``pislam_tpu/models/visual_odometry.py``. Per frame, all on the
state's device:

    pyramid <- build_pyramid(frame)               ops/pyramid.py
    feats   <- extract(pyramid)                   frontend.py (K1-K4)
    matches <- hamming match vs previous frame    matching.py (K5)
    (R, t)  <- RANSAC essential + cheirality      geometry/ransac.py
    pose    <- (R, t) o pose                      (camera trajectory)

The translation of each pair is up to scale (monocular); steps are chained
at unit scale unless ``vo.scale_propagation`` is on. ``vo_step`` reads
nothing back to the host, so a sequence runs without waiting on the card
until its trajectory is read. The RANSAC samples come from a
``torch.Generator`` carried in the state; its draws differ from
``jax.random``'s (on the committed sequences the refit on the winning inlier
set covers every match, so the trajectory does not depend on them).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import matching
from ..config import PislamConfig
from ..frontend import Features, OrbExtractor
from ..geometry import camera, ransac
from ..ops import kernels
from ..ops.pyramid import build_pyramid
from ..utils.metrics import NullMetrics


class VOState(NamedTuple):
    R: torch.Tensor           # (3, 3) world->cam of the current frame
    t: torch.Tensor           # (3,)
    prev: Features
    prev_pts: torch.Tensor    # (K, 2) normalised coords of prev features
    generator: torch.Generator
    # scale propagation (vo.scale_propagation): per-feature depths of the
    # previous frame's keypoints in ITS camera (map units, 0 = unknown) and
    # the last accepted step scale
    prev_depths: Optional[torch.Tensor] = None
    step_scale: Optional[torch.Tensor] = None


def _depths_along_ray1(R, t, p1, p2):
    """Depth (z in camera 1) of each correspondence for relative pose
    x_c2 = R x_c1 + t: the closed-form midpoint solve."""
    d1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    d2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    rd1 = d1 @ R.T
    c_rd1 = torch.linalg.cross(d2, rd1)
    c_t = torch.linalg.cross(d2, t.expand(d2.shape))
    return -torch.sum(c_rd1 * c_t, -1) / torch.clamp(
        torch.sum(c_rd1 * c_rd1, -1), min=1e-12)


def _pair(a: float, b: float, device):
    """(2,) float32 [a, b] made on the device, not copied from the host
    (an element assignment from a Python number waits on the card)."""
    return torch.where(torch.arange(2, device=device) == 0, a, b).to(torch.float32)


def normalise_points(feats: Features, fx, fy, cx, cy, level_rows,
                     level_scales, dist=None):
    """Pixel keypoints (stacked-pyramid coords) -> (K, 2) normalised level-0
    coords, float32.

    Keypoint y is a global pyramid row: subtract its level origin and scale
    back to level 0 by the level's downscale factor before applying the
    inverse intrinsics. ``level_rows`` and ``level_scales`` are sequences or
    tensors on the features' device. ``dist`` is an optional
    (k1, k2, p1, p2) lens distortion to undo (geometry/camera.py).
    """
    ys, xs = feats.ys, feats.xs
    dev = ys.device
    rows = torch.as_tensor(level_rows, dtype=torch.int32, device=dev)
    lvl = torch.sum(ys[:, None] >= rows[None, :], dim=1) - 1
    y_local = ys - rows[lvl]
    scale = torch.as_tensor(level_scales, dtype=torch.float32, device=dev)[lvl]
    uv = torch.stack([xs.to(torch.float32) * scale,
                      y_local.to(torch.float32) * scale], dim=1)
    # a true division by a device tensor: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which is not the JAX package's rounding
    pts = (uv - _pair(cx, cy, dev)) / _pair(fx, fy, dev)
    if dist is not None:
        pts = camera.undistort_normalised(pts, *dist)
    return pts


def vo_step(mc, vc, state: VOState, feats: Features, pts,
            reduce=kernels.match_reduce):
    """One VO step: match vs the previous frame, RANSAC essential, chain.

    Shared by ``VisualOdometry.process`` and ``make_vo_scan``. The RANSAC
    samples come from the state's generator; ``reduce`` is K5's wrapper or
    its plain version.
    Returns (new_state, info) with 0-dim tensors ``num_matches``,
    ``num_inliers`` and ``accepted``, and the match's (K,) ``idx2`` and
    ``dist``.
    """
    if vc.guided_radius > 0:
        # guided matching: the previous frame's own position is each
        # feature's motion prediction at tracking frame rates
        idx2, dist = matching.match_gated(
            state.prev.descriptors, feats.descriptors,
            state.prev.valid, feats.valid,
            state.prev_pts, pts, vc.guided_radius,
            max_distance=mc.max_distance, ratio=mc.ratio,
            cross_check=mc.cross_check, reduce=reduce)
    else:
        idx2, dist = matching.match(
            state.prev.descriptors, feats.descriptors,
            state.prev.valid, feats.valid,
            max_distance=mc.max_distance, ratio=mc.ratio,
            cross_check=mc.cross_check, reduce=reduce)
    ok = idx2 >= 0
    p1 = state.prev_pts
    p2 = pts[torch.clamp(idx2, min=0).long()]
    out = ransac.ransac_essential(
        p1, p2, ok, iters=vc.ransac_iters, sample_size=vc.sample_size,
        inlier_threshold=vc.inlier_threshold, generator=state.generator)
    if vc.refine_two_view:
        # two-view refinement: triangulate the RANSAC inliers at the
        # unit-baseline relative pose and polish it by motion-only BA
        from ..backend import pnp

        t_u = out["t"] / torch.clamp(torch.linalg.vector_norm(out["t"]), min=1e-9)
        z1 = _depths_along_ray1(out["R"], t_u, p1, p2)
        x_c1 = z1[:, None] * torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
        tri_ok = out["inliers"] & ok & (z1 > 1e-4) & torch.isfinite(z1)
        ref = pnp.motion_only_ba(out["R"], t_u, x_c1, p2, tri_ok, iters=6,
                                 inlier_threshold=vc.inlier_threshold)
        accept = ((ref["num_inliers"] >= out["num_inliers"])
                  & torch.all(torch.isfinite(ref["R"]))
                  & torch.all(torch.isfinite(ref["t"])))
        out = {k: torch.where(accept, ref[k], out[k])
               for k in ("R", "t", "inliers", "num_inliers")}
    good = out["num_inliers"] >= vc.min_inliers
    if vc.max_rel_rotation_deg > 0:
        # motion-continuity guard: a huge frame-to-frame rotation is a
        # mirrored RANSAC solution on self-similar texture, not motion
        cosang = (torch.trace(out["R"]) - 1.0) / 2.0
        ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
        good &= ang <= vc.max_rel_rotation_deg
    tnorm = out["t"] / torch.clamp(torch.linalg.vector_norm(out["t"]), min=1e-9)

    if vc.scale_propagation:
        # triangulated-depth scale propagation: the lower median over the
        # inliers of (depth in frame i from the previous pair) / (depth from
        # this pair) scales the step
        K = pts.shape[0]
        d1 = _depths_along_ray1(out["R"], tnorm, p1, p2)   # (K,) unit-base
        pair_ok = out["inliers"] & ok & (d1 > 1e-6)
        have_prev = pair_ok & (state.prev_depths > 0)
        ratio = state.prev_depths / torch.clamp(d1, min=1e-9)
        ratio = torch.where(have_prev & torch.isfinite(ratio), ratio, math.inf)
        n_r = torch.sum(ratio < math.inf)
        r_sorted = torch.sort(ratio).values
        lower = (torch.clamp(n_r - 1, min=0) // 2).reshape(1)
        s_med = r_sorted.index_select(0, lower)[0]           # lower median
        s = torch.where(n_r >= vc.min_scale_matches, s_med, state.step_scale)
        s = torch.where(good & torch.isfinite(s) & (s > 1e-9), s, state.step_scale)
        # depths of the CURRENT frame's features in its camera, map units
        z2 = ((d1 * (p1 @ out["R"][2, :2] + out["R"][2, 2])) + tnorm[2]) * s
        dst = torch.where(pair_ok & (z2 > 0), torch.clamp(idx2, min=0), K).long()
        # min-scatter: the nearer depth wins where two features land on one
        depths_new = torch.full((K + 1,), math.inf, dtype=z2.dtype, device=z2.device)
        depths_new = depths_new.scatter_reduce(0, dst, z2, "amin", include_self=True)[:K]
        depths_new = torch.where(torch.isfinite(depths_new), depths_new, 0.0)
        depths_new = torch.where(good, depths_new, 0.0)
        tstep = s * tnorm
        step_scale_new = torch.where(good, s, state.step_scale)
    else:
        depths_new = state.prev_depths
        step_scale_new = state.step_scale
        tstep = tnorm

    Rn = torch.where(good, out["R"] @ state.R, state.R)
    tn = torch.where(good, (out["R"] @ state.t[:, None])[:, 0] + tstep, state.t)
    new_state = VOState(R=Rn, t=tn, prev=feats, prev_pts=pts,
                        generator=state.generator, prev_depths=depths_new,
                        step_scale=step_scale_new)
    info = {"num_matches": ok.sum(), "num_inliers": out["num_inliers"],
            "accepted": good, "idx2": idx2, "dist": dist}
    return new_state, info


def _initial_state(feats, pts, generator) -> VOState:
    dev = pts.device
    return VOState(R=torch.eye(3, device=dev), t=torch.zeros(3, device=dev),
                   prev=feats, prev_pts=pts, generator=generator,
                   prev_depths=torch.zeros(pts.shape[0], device=dev),
                   step_scale=torch.ones((), device=dev))


class _Frontend:
    """frame (H, W) uint8 -> (Features, (K, 2) normalised points) on a device.
    The image path's pyramid is the span ``pyramid`` of ``metrics``."""

    def __init__(self, cfg: PislamConfig, fx, fy, cx, cy, dist, device,
                 ops: kernels.KernelSet, features_fn=None, metrics=None):
        pc = cfg.pyramid
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else NullMetrics()
        self.device = torch.device(device)
        self.intrinsics = (float(fx), float(fy), float(cx), float(cy))
        self.dist = tuple(dist) if dist is not None else None
        self.extract = features_fn or OrbExtractor(cfg, ops=ops).to(self.device)
        self.image_input = features_fn is None
        self.level_rows = torch.tensor(pc.level_rows, dtype=torch.int32,
                                       device=self.device)
        # per-level scale back to level 0 = base_width / level_width
        self.level_scales = torch.tensor(
            [pc.base_width / w for (w, _h) in pc.level_sizes],
            dtype=torch.float32, device=self.device)

    def __call__(self, frame):
        if self.image_input:
            with self.metrics.timer("pyramid"):
                frame = torch.as_tensor(frame).to(self.device)
                pyramid = build_pyramid(frame, self.cfg.pyramid)
            feats = self.extract(pyramid)
        else:
            feats = self.extract(frame)
        return feats, normalise_points(feats, *self.intrinsics, self.level_rows,
                                       self.level_scales, dist=self.dist)


def make_vo_scan(cfg: PislamConfig, fx: float, fy: float, cx: float, cy: float,
                 dist=None, device="cuda", ops: kernels.KernelSet = kernels.HOPPER):
    """VO over a whole sequence on one device.

    Returns ``run(frames (T, H, W) uint8, generator) -> dict`` with the
    world->cam trajectory ``R (T, 3, 3)``, ``t (T, 3)`` (frame 0 = identity)
    and per-transition ``num_inliers`` / ``accepted`` ((T-1,)) and the
    matches ``idx2`` / ``dist`` ((T-1, K)), all on the device. The frames go
    to the device at once; each frame's outputs stay there and are stacked
    at the end, so the loop never waits on the card.
    ``generator`` is a ``torch.Generator`` on the device. ``ops`` picks the
    kernels (``kernels.PLAIN`` runs the plain versions on any device).
    """
    frontend = _Frontend(cfg, fx, fy, cx, cy, dist, device, ops)
    mc, vc = cfg.matcher, cfg.vo

    def run(frames, generator: torch.Generator):
        frames = torch.as_tensor(frames).to(frontend.device)
        if len(frames) < 2:
            raise ValueError("a sequence needs at least two frames")
        state = _initial_state(*frontend(frames[0]), generator)
        out = {"R": [state.R], "t": [state.t]}
        per_step = ("num_inliers", "accepted", "idx2", "dist")
        out.update({k: [] for k in per_step})
        for frame in frames[1:]:
            state, info = vo_step(mc, vc, state, *frontend(frame),
                                  reduce=ops.match_reduce)
            out["R"].append(state.R)
            out["t"].append(state.t)
            for k in per_step:
                out[k].append(info[k])
        return {k: torch.stack(v) for k, v in out.items()}

    return run


class VisualOdometry:
    """Monocular VO driver. Intrinsics in pixels at pyramid level 0.

    ``features_fn`` replaces the image frontend: it maps whatever
    ``process`` is given to ``Features`` on ``device``. ``metrics`` takes
    the frontend's ``pyramid`` span.
    """

    def __init__(self, cfg: PislamConfig, fx: float, fy: float, cx: float,
                 cy: float, features_fn=None, dist=None, device="cuda", metrics=None):
        self.cfg = cfg
        self.frontend = _Frontend(cfg, fx, fy, cx, cy, dist, device, kernels.HOPPER,
                                  features_fn, metrics)
        self.device = self.frontend.device

    def init(self, frame, seed: int = 0) -> VOState:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return _initial_state(*self.frontend(frame), generator)

    def process(self, state: VOState, frame):
        feats, pts = self.frontend(frame)
        return vo_step(self.cfg.matcher, self.cfg.vo, state, feats, pts)

    def camera_position(self, state: VOState) -> np.ndarray:
        """World position of the camera: -R^T t."""
        R = state.R.cpu().numpy()
        return -R.T @ state.t.cpu().numpy()


def vo_state_from_numpy(state, device="cuda", seed: int = 0) -> VOState:
    """The port's ``VOState`` from a JAX ``VOState`` given as numpy arrays.

    ``state`` has ``R``, ``t``, ``prev`` (``codes``, ``valid``, ``angles``,
    ``descriptors`` as the JAX package's uint32/bool/uint8 arrays),
    ``prev_pts``, ``prev_depths`` and ``step_scale``; its ``key`` is not
    carried (``jax.random`` draws cannot be reproduced), a generator seeded
    with ``seed`` takes its place.
    """
    def tensor(a, dtype):     # a copy: arrays from JAX are read-only
        return torch.tensor(np.asarray(a, dtype), device=device)

    def f32(a):
        return tensor(a, np.float32)

    prev = state.prev
    feats = Features(
        codes=tensor(np.asarray(prev.codes, np.uint32), np.int64),
        valid=tensor(prev.valid, bool),
        angles=tensor(prev.angles, np.uint8),
        descriptors=tensor(np.asarray(prev.descriptors, np.uint32).view(np.int32),
                           np.int32))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return VOState(R=f32(state.R), t=f32(state.t), prev=feats,
                   prev_pts=f32(state.prev_pts), generator=generator,
                   prev_depths=f32(state.prev_depths),
                   step_scale=f32(state.step_scale))
