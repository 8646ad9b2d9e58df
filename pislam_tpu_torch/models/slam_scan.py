"""Device-resident SLAM tracking: a chunk of frames with one readback.

The port of ``pislam_tpu/models/slam_scan.py``. ``KeyframeSLAM.process``
reads the inlier counts, the pose and the counters back to the host every
frame to take its decisions. Here the whole per-frame tracking path

    extract -> match vs the last keyframe -> RANSAC essential -> map PnP
    -> keyframe decision -> keyframe insert + triangulation

runs for every frame of a chunk with each decision a device tensor: the
loop over the frames is Python, but nothing in it reads a value back, so
the host runs ahead of the card and waits once, when the caller reads the
state and the outputs. Each ``lax.cond`` of the JAX scan becomes:

* bootstrap or track: the host knows the keyframe count when the chunk
  starts, and the bootstrap always inserts, so only a chunk's first frame
  can be the bootstrap and the host picks its branch;
* map tracking: it runs on every tracked frame, and ``torch.where`` on the
  JAX condition (landmarks exist, the frame is not lost, enough inliers,
  a finite pose) selects its pose, so the NaNs of an empty map or a lost
  frame never reach the pose;
* keyframe insertion: ``insert_keyframe_state`` runs on every tracked frame
  and the whole ``SlamState`` is selected by ``torch.where`` on the
  decision. That keeps the insertion the same function as ``process``'s,
  at the price of one elementwise select per state tensor per frame;
* the E/H bootstrap selection (``vo.bootstrap_model_select``): the keyframe
  count changes inside a chunk, so the homography's result is selected on
  the device while the chunk can still hold a frame with one keyframe.

RANSAC samples come from the state's generator in ``process``'s order: each
tracked frame draws the essential samples and, with
``vo.bootstrap_model_select``, the homography samples after them. Windowed
BA is not inside the scan: it runs per chunk in ``process_chunk``.

Each frame's stages are spans of ``metrics`` (``utils/metrics.py``) with the
frame's id: ``extract`` (with the frontend's ``pyramid``), ``track`` (match
and RANSAC, with the homography's), ``map_track`` and ``insert`` (the insert
and the state's select). The host only launches inside them; the card's work
is waited for at the chunk's readback.
"""

from __future__ import annotations

import torch

from .. import matching
from ..backend import keyframes as kfs
from ..config import PislamConfig
from ..geometry import homography, ransac
from ..ops import kernels
from ..utils.metrics import NullMetrics
from .slam import (SlamState, insert_keyframe_state, keyframe_step_prior,
                   rescale_step_to_prior, track_map_state)
from .visual_odometry import _Frontend


def _select_state(cond, a: SlamState, b: SlamState) -> SlamState:
    """``a`` where the 0-dim bool ``cond`` holds, else ``b``, tensor by tensor."""
    def pick(x, y):
        return type(x)(*(torch.where(cond, u, v) for u, v in zip(x, y)))

    return SlamState(pick(a.store, b.store), pick(a.lmap, b.lmap), pick(a.obs, b.obs),
                     torch.where(cond, a.counters, b.counters), a.generator)


def _all_finite(*xs):
    out = torch.isfinite(xs[0]).all()
    for x in xs[1:]:
        out = out & torch.isfinite(x).all()
    return out


def make_slam_track_scan(cfg: PislamConfig, fx: float, fy: float, cx: float, cy: float,
                         keyframe_min_inliers: int = 60, keyframe_max_gap: int = 10,
                         dist=None, device="cuda", metrics=None):
    """Build ``run(state, frames (T, H, W) uint8, num_kf, first_frame=0) ->
    (state, outs)``.

    ``num_kf`` is the host's count of keyframes in ``state`` (its
    ``counters[0]``), so that the host never reads it; ``first_frame`` is
    the frame id of ``frames[0]``, for the spans. ``outs`` holds the
    per-frame pose_R (T, 3, 3), pose_t (T, 3), keyframe, num_inliers and
    map_inliers (the fields ``KeyframeSLAM.process`` returns), stacked on
    the device."""
    mc, vc, mapc = cfg.matcher, cfg.vo, cfg.map
    cap = mapc.keyframe_capacity
    K = cfg.frontend.max_keypoints
    m = metrics if metrics is not None else NullMetrics()
    frontend = _Frontend(cfg, fx, fy, cx, cy, dist, device, kernels.HOPPER, metrics=m)
    dev = frontend.device
    lanes = torch.arange(5, device=dev)

    def set_counter(counters, i, value):
        return torch.where(lanes == i, value, counters)

    def insert(st, feats, pts, R, t, idx2, inliers, prev_slot, map_idx):
        return insert_keyframe_state(cap, st, feats, pts, R, t, idx2, inliers, prev_slot,
                                     map_idx, refresh_desc=mapc.refresh_descriptors)

    def bootstrap(st, feats, pts, f):
        R0 = torch.eye(3, device=dev)
        t0 = torch.zeros(3, device=dev)
        no_match = torch.full((K,), -1, dtype=torch.int32, device=dev)
        with m.timer("insert", f):
            st = insert(st, feats, pts, R0, t0, no_match,
                        torch.zeros(K, dtype=torch.bool, device=dev), 0, no_match)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return st, (R0, t0, torch.ones((), dtype=torch.bool, device=dev), zero, zero)

    def track(st, feats, pts, prev_R, prev_t, homography_possible, f):
        num_kf = st.counters[0]
        slot = torch.remainder(num_kf - 1, cap)
        store = st.store
        p1 = kfs.row(store.pts, slot)
        with m.timer("track", f):
            idx2, _ = matching.match(kfs.row(store.descriptors, slot), feats.descriptors,
                                     kfs.row(store.kp_valid, slot), feats.valid,
                                     max_distance=mc.max_distance, ratio=mc.ratio,
                                     cross_check=mc.cross_check)
            ok = idx2 >= 0
            p2 = pts[torch.clamp(idx2, min=0).long()]
            idx_e = ransac.sample_indices(ok, vc.ransac_iters, 8, st.generator)
            out = ransac.ransac_essential(p1, p2, ok, iters=vc.ransac_iters,
                                          inlier_threshold=vc.inlier_threshold, idx=idx_e)
            if vc.bootstrap_model_select:
                # drawn on every tracked frame, as process draws them
                idx_h = ransac.sample_indices(ok, vc.ransac_iters, 4, st.generator)
                if homography_possible:
                    oh = homography.ransac_homography(p1, p2, ok, iters=vc.ransac_iters,
                                                      inlier_threshold=vc.inlier_threshold,
                                                      idx=idx_h)
                    sel = homography.choose_model(out, oh)
                    boot = num_kf == 1
                    out = {k: torch.where(boot, sel[k], out[k])
                           for k in ("R", "t", "inliers", "num_inliers")}
        n_inl = out["num_inliers"].to(torch.int32)
        Rrel, t_raw = out["R"], out["t"]
        # lost when tracking collapses or the solve is not finite: the
        # previous pose is held (relocalisation waits for the chunk's end)
        lost = (n_inl < vc.min_inliers) | ~_all_finite(Rrel, t_raw)
        if vc.max_rel_rotation_deg > 0:
            # motion-continuity guard: a mirrored RANSAC solution is lost
            cosang = (torch.trace(Rrel) - 1.0) / 2.0
            ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
            lost = lost | (ang > vc.max_rel_rotation_deg)
        # the translation stays unit-norm: map PnP supplies the scale
        trel = t_raw / torch.clamp(torch.linalg.vector_norm(t_raw), min=1e-9)
        R_kf, t_kf = kfs.row(store.R, slot), kfs.row(store.t, slot)
        R = Rrel @ R_kf
        t = Rrel @ t_kf + trel
        if vc.step_magnitude_prior:
            # the map-PnP dropout fallback, applied below where map tracking
            # is not taken
            s_prior = keyframe_step_prior(store, num_kf, cap)
            d = s_prior * (st.counters[4] + 1).to(torch.float32)
            t_fb = rescale_step_to_prior(R, t, -(R_kf.T @ t_kf), d)
            fb_ok = ((s_prior > 0) & (num_kf >= vc.step_prior_min_kf)
                     & torch.isfinite(t_fb).all())
        R = torch.where(lost, prev_R, R)
        t = torch.where(lost, prev_t, t)

        n_lm = st.counters[1]
        if mapc.track_map:
            with m.timer("map_track", f):
                Rm, tm, n_map, assoc = track_map_state(cfg, st.lmap, feats, pts, R, t)
            tracked = (n_lm > 0) & ~lost
            n_map = torch.where(tracked, n_map.to(torch.int32), 0)
            use = tracked & (n_map >= mapc.min_map_inliers) & _all_finite(Rm, tm)
            R = torch.where(use, Rm, R)
            t = torch.where(use, tm, t)
            map_idx = torch.where(use, assoc, -1)
        else:
            use = torch.zeros((), dtype=torch.bool, device=dev)
            n_map = torch.zeros((), dtype=torch.int32, device=dev)
            map_idx = torch.full((K,), -1, dtype=torch.int32, device=dev)
        if vc.step_magnitude_prior:
            t = torch.where(~lost & ~use & fb_ok, t_fb, t)

        since = st.counters[4] + 1
        st = st._replace(counters=set_counter(st.counters, 4, since))
        make_kf = ~lost & ((n_inl < keyframe_min_inliers) | (since >= keyframe_max_gap))
        if mapc.keyframe_on_map_dropout and mapc.track_map:
            # tracking holds but map coverage collapsed, and the landmark
            # table can still grow
            make_kf = make_kf | (~lost & (n_lm > 0) & (n_map < mapc.min_map_inliers)
                                 & (n_lm < mapc.max_landmarks))
        with m.timer("insert", f):
            ins = insert(st, feats, pts, R, t, idx2, out["inliers"], slot, map_idx)
            ins = ins._replace(counters=set_counter(ins.counters, 4, 0))
            st = _select_state(make_kf, ins, st)
        return st, (R, t, make_kf, n_inl, n_map)

    def run(st: SlamState, frames, num_kf: int, first_frame: int = 0):
        frames = torch.as_tensor(frames).to(dev)
        # the previous accepted pose starts at the last keyframe's
        slot = torch.remainder(st.counters[0] - 1, cap)
        has_kf = st.counters[0] > 0
        prev_R = torch.where(has_kf, kfs.row(st.store.R, slot), torch.eye(3, device=dev))
        prev_t = torch.where(has_kf, kfs.row(st.store.t, slot), 0.0)
        next_frame = (lanes == 3).to(torch.int32)
        outs = []
        for i, frame in enumerate(frames):
            f = first_frame + i
            with m.timer("extract", f):
                feats, pts = frontend(frame)
            if i == 0 and num_kf == 0:
                st, out = bootstrap(st, feats, pts, f)
            else:
                # with two keyframes when the chunk starts, none of its
                # frames can see exactly one
                st, out = track(st, feats, pts, prev_R, prev_t, num_kf <= 1, f)
            # after the insert: counters[3] is the frame id
            st = st._replace(counters=st.counters + next_frame)
            prev_R, prev_t = out[0], out[1]
            outs.append(out)
        names = ("pose_R", "pose_t", "keyframe", "num_inliers", "map_inliers")
        return st, {k: torch.stack(v) for k, v in zip(names, zip(*outs))}

    return run
