"""Keyframe SLAM: map tracking + windowed BA + loop closure over a map of
fixed-shape tensors.

The port of ``pislam_tpu/models/slam.py`` (``KeyframeSLAM`` and the pure
state functions it is built from). Per frame, on the state's device:

    feats, pts <- pyramid + extraction + normalise     (K1-K4, or K6 unfused)
    (R, t)     <- match vs the last keyframe + RANSAC  (K5)
    (R, t)     <- map tracking: project landmarks, gated match, motion-only BA
                                                       (gated K5)
    keyframe?  -> insert: triangulate + landmarks + observations, then
                  windowed BA (Schur)

and at the end of a session ``close_loop``: loop detection against the whole
keyframe store, neighbourhood PnP, observation fusion, then three rounds of
global BA + landmark culling with and without a pose-graph step first; the
branch whose map is more self-consistent wins.

``KeyframeSLAM`` is orchestrated on the host by design, as in the JAX
package: it reads the inlier counts, the pose and the map counters per frame
and copies the observation tables to numpy for each BA. The state functions
(``insert_keyframe_state``, ``track_map_state``, the BA and pose-graph
solvers) read nothing back. The RANSAC samples come from a
``torch.Generator`` on the device, carried in the state where the JAX
package carries its PRNG key; its draws differ from ``jax.random``'s.

Not in this port yet: ``process_chunk`` (``models/slam_scan.py``),
``merge_map``, checkpoints, the service's housekeeping (``cull_keyframes``,
``compact``, ``evict_stale_landmarks``, ``retriangulate_landmarks``) and the
E/H bootstrap (``geometry/homography.py``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import matching
from ..backend import ba, pnp, pose_graph, triangulate
from ..backend import keyframes as kfs
from ..config import PislamConfig
from ..frontend import Features
from ..geometry import ransac, se3
from ..utils.metrics import NullMetrics
from .visual_odometry import VisualOdometry


class SlamState(NamedTuple):
    """The full SLAM session state: fixed-shape tensors on one device."""
    store: kfs.KeyframeStore
    lmap: kfs.LandmarkMap
    obs: kfs.ObservationTable
    # [num_keyframes, lm_cursor, obs_cursor, frame_idx, since_kf]
    counters: torch.Tensor       # (5,) int32
    generator: torch.Generator   # RANSAC samples (the JAX package's key)


@dataclasses.dataclass
class KeyframeView:
    """Lightweight host view of one stored keyframe."""
    index: int       # insertion ordinal
    frame: int       # source frame number
    slot: int        # store slot
    R: np.ndarray
    t: np.ndarray


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def init_state(cfg: PislamConfig, seed: int = 7, device="cuda") -> SlamState:
    mc, fc = cfg.map, cfg.frontend
    return SlamState(
        store=kfs.empty_store(mc.keyframe_capacity, fc.max_keypoints, fc.words, device),
        lmap=kfs.empty_map(mc.max_landmarks, fc.words, device),
        obs=kfs.empty_obs(mc.max_obs, device),
        counters=torch.zeros(5, dtype=torch.int32, device=device),
        generator=_generator(device, seed),
    )


def insert_keyframe_state(cap: int, st: SlamState, feats: Features, pts, R, t, idx2,
                          inliers, prev_slot: int, map_idx, refresh_desc: bool = False):
    """Pure keyframe insertion: SlamState -> SlamState, with no host read.

    Writes the keyframe ring slot, triangulates inlier matches against the
    previous keyframe (slot ``prev_slot``) into new landmarks, and appends
    observation rows. Features already associated with a landmark by map
    tracking (``map_idx``) get an observation row instead of a duplicate
    landmark.
    """
    num_kf = st.counters[0]
    frame_id = st.counters[3]
    slot = torch.remainder(num_kf, cap)
    # ring eviction: observation rows of the overwritten keyframe would
    # otherwise feed BA with a stale pose
    evict = num_kf >= cap
    obs = st.obs._replace(valid=st.obs.valid & ~(evict & (st.obs.kf == slot)))
    prev_R, prev_t = st.store.R[prev_slot], st.store.t[prev_slot]
    p1 = st.store.pts[prev_slot]
    prev_kp_valid = st.store.kp_valid[prev_slot]
    store = kfs.insert_keyframe(st.store, slot, R, t, feats, frame_id, pts=pts,
                                ordinal=num_kf)
    # triangulate inlier matches prev_kf -> new_kf into landmarks
    idx2c = torch.clamp(idx2, min=0).long()
    p2 = pts[idx2c]
    X = triangulate.triangulate_two_view(prev_R, prev_t, R, t, p1, p2)
    z1 = (X @ prev_R.T + prev_t)[:, 2]
    z2 = (X @ R.T + t)[:, 2]
    mask = (inliers & (idx2 >= 0) & prev_kp_valid & feats.valid[idx2c]
            & (z1 > 1e-4) & (z2 > 1e-4) & torch.all(torch.isfinite(X), dim=1))
    # data association: a feature matched to a map landmark by this
    # frame's map tracking gets an observation row, not a duplicate
    # landmark (whose identical descriptor would fail every later ratio test)
    matched_lm = map_idx[idx2c]
    exist = mask & (matched_lm >= 0)
    new = mask & (matched_lm < 0)
    desc_anchor = feats.descriptors[idx2c]
    lmap, obs, lm_cur, obs_cur = kfs.add_landmarks(
        st.lmap, obs, st.counters[1], st.counters[2], X, desc_anchor, new,
        prev_slot, slot, p1, p2)
    lmap, obs, obs_cur = kfs.add_observations(
        lmap, obs, obs_cur, slot, torch.clamp(matched_lm, min=0), p2, exist)
    if refresh_desc:
        rows = torch.where(exist, matched_lm, lmap.capacity)
        lmap = lmap._replace(descriptors=kfs.set_drop(lmap.descriptors, rows, desc_anchor))
    counters = torch.stack([num_kf + 1, lm_cur, obs_cur, st.counters[3],
                            st.counters[4]]).to(torch.int32)
    return SlamState(store, lmap, obs, counters, st.generator)


def project_landmarks(lmap: kfs.LandmarkMap, R0, t0):
    """Landmark positions -> normalised-plane coords under a pose prior.
    Behind-camera landmarks project to a far-away sentinel that no gate
    selects."""
    xc = lmap.xyz @ R0.T + t0
    z = xc[:, 2]
    uv = xc[:, :2] / torch.clamp(z, min=1e-6)[:, None]
    return torch.where((z > 1e-6)[:, None], uv, 1e6)


def track_map_state(cfg: PislamConfig, lmap: kfs.LandmarkMap, feats: Features, pts,
                    R0, t0):
    """Pure local-map tracking: match features to landmark descriptors and
    refine the pose with motion-only BA. Returns (R, t, num_inliers, assoc).

    With cfg.map.gate_radius > 0 the match is projection-gated (landmarks
    projected with the (R0, t0) prior; the gated K5 on the card)."""
    mc = cfg.map
    kw = dict(max_distance=mc.map_match_max_distance, ratio=cfg.matcher.ratio,
              cross_check=True)
    if mc.gate_radius > 0:
        idx, _ = matching.match_gated(
            feats.descriptors, lmap.descriptors, feats.valid, lmap.valid,
            pts, project_landmarks(lmap, R0, t0), mc.gate_radius, **kw)
    else:
        idx, _ = matching.match(feats.descriptors, lmap.descriptors, feats.valid,
                                lmap.valid, **kw)
    ok = idx >= 0
    xyz = lmap.xyz[torch.clamp(idx, min=0).long()]
    out = pnp.motion_only_ba(R0, t0, xyz, pts, ok, iters=mc.pnp_iters,
                             inlier_threshold=mc.pnp_inlier_threshold)
    # only reprojection-inlier associations feed data association
    assoc = torch.where(out["inliers"], idx, -1)
    return out["R"], out["t"], out["num_inliers"], assoc


def keyframe_step_prior(store: kfs.KeyframeStore, num_kf: int, cap: int):
    """Per-frame camera speed over the last keyframe interval (map units):
    |c_kf[-1] - c_kf[-2]| / frame gap, 0 with fewer than two valid
    keyframes. A 0-dim tensor."""
    sA, sB = (num_kf - 1) % cap, (num_kf - 2) % cap
    cA = -(store.R[sA].T @ store.t[sA])
    cB = -(store.R[sB].T @ store.t[sB])
    gap = (store.frame_id[sA] - store.frame_id[sB]).to(torch.float32)
    ok = store.valid[sA] & store.valid[sB] & (gap > 0) & (num_kf >= 2)
    s = torch.linalg.vector_norm(cA - cB) / torch.clamp(gap, min=1.0)
    return torch.where(ok & torch.isfinite(s), s, 0.0)


def rescale_step_to_prior(R, t_cand, c_kf, d_target):
    """Rescale the candidate pose's camera-centre displacement from the last
    keyframe to ``d_target``, keeping RANSAC's direction; returns the new
    translation -R c_new."""
    c_cand = -(R.transpose(-1, -2) @ t_cand[..., None])[..., 0]
    step = c_cand - c_kf
    n = torch.linalg.vector_norm(step)
    c_new = c_kf + step * (d_target / torch.clamp(n, min=1e-9))
    return -(R @ c_new[..., None])[..., 0]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class KeyframeSLAM:
    """Keyframe SLAM, orchestrated on the host. Intrinsics in pixels at
    pyramid level 0; ``dist`` an optional (k1, k2, p1, p2) lens distortion.
    Runs on ``device`` (the card unless told otherwise). ``features_fn``
    replaces the image frontend (it maps what ``process`` is given to
    ``Features`` on the device)."""

    def __init__(self, cfg: PislamConfig, fx, fy, cx, cy, features_fn=None,
                 keyframe_min_inliers: int = 60, keyframe_max_gap: int = 10,
                 seed: int = 7, metrics=None, reloc_min_matches: int = 30,
                 mapping: bool = True, dist=None, device="cuda"):
        if cfg.vo.bootstrap_model_select:
            raise NotImplementedError(
                "vo.bootstrap_model_select needs geometry/homography.py, not ported yet")
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else NullMetrics()
        self.vo = VisualOdometry(cfg, fx, fy, cx, cy, features_fn=features_fn, dist=dist,
                                 device=device)
        self.device = self.vo.device
        self.keyframe_min_inliers = keyframe_min_inliers
        self.keyframe_max_gap = keyframe_max_gap
        self.reloc_min_matches = reloc_min_matches
        # localization-only mode: track and relocalise against a frozen map
        self.mapping = mapping
        self.capacity = cfg.map.keyframe_capacity
        if self.capacity < cfg.ba.window:
            raise ValueError("the keyframe ring must hold at least one BA window")

        self._st = init_state(cfg, seed, self.device)
        # host mirrors of the counters (authoritative during a run; synced
        # from the device state by set_state)
        self._num_kf = 0
        self._num_lm = 0
        self._num_obs = 0
        self._frame_idx = 0
        self._since_kf = 0
        self.trajectory = []  # camera positions per processed frame (host)
        self._last: Optional[dict] = None   # rows of the last keyframe
        # last accepted pose (held while tracking is lost)
        self._prev_pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.frames_lost = 0
        self.relocalisations = 0

        mc = cfg.matcher
        self._match = partial(matching.match, max_distance=mc.max_distance,
                              ratio=mc.ratio, cross_check=mc.cross_check)
        self._insert = partial(insert_keyframe_state, self.capacity,
                               refresh_desc=cfg.map.refresh_descriptors)
        self._track_map = partial(track_map_state, cfg)
        # slots invalidated by keyframe culling, from a restored state (an
        # insert that reuses the slot removes it again)
        self._culled_slots: set = set()

    def _store_counts(self, store: kfs.KeyframeStore, feats: Features):
        mc = self.cfg.matcher
        return matching.match_many(store.descriptors, store.kp_valid, feats.descriptors,
                                   feats.valid, max_distance=mc.max_distance,
                                   ratio=mc.ratio, cross_check=mc.cross_check)[1]

    # -- state ----------------------------------------------------------------

    @property
    def state(self) -> SlamState:
        c = [self._num_kf, self._num_lm, self._num_obs, self._frame_idx, self._since_kf]
        return self._st._replace(
            counters=torch.tensor(c, dtype=torch.int32, device=self.device))

    def set_state(self, state: SlamState):
        """Adopt a SlamState (a snapshot, or one from ``slam_state_from_numpy``)."""
        self._st = state
        c, valid, ordinal = (_host(x) for x in (state.counters, state.store.valid,
                                                state.store.ordinal))
        self._num_kf, self._num_lm, self._num_obs = int(c[0]), int(c[1]), int(c[2])
        self._frame_idx, self._since_kf = int(c[3]), int(c[4])
        # culled slots keep their ordinal but turn invalid
        self._culled_slots = {int(s) for s in np.nonzero(~valid & (ordinal >= 0))[0]}
        if self._num_kf > 0:
            slot = (self._num_kf - 1) % self.capacity
            self._cache_last(slot)
            self._prev_pose = (self._last["R"], self._last["t"])
        else:
            self._last = None
            self._prev_pose = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))

    def process_chunk(self, frames):
        raise NotImplementedError(
            "process_chunk needs models/slam_scan.py, not ported yet")

    def _cache_last(self, slot: int):
        st = self._st.store
        self._last = {"slot": slot, "desc": st.descriptors[slot],
                      "valid": st.kp_valid[slot], "pts": st.pts[slot],
                      "R": _host(st.R[slot]), "t": _host(st.t[slot])}

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- internal -------------------------------------------------------------

    def _features(self, frame):
        return self.vo.frontend(frame)

    def _localise_against(self, desc, valid, ref_pts, feats, pts):
        """RANSAC essential pose of ``feats`` vs a reference feature block;
        the samples come from the state's generator."""
        idx2, _ = self._match(desc, feats.descriptors, valid, feats.valid)
        ok = idx2 >= 0
        p2 = pts[torch.clamp(idx2, min=0).long()]
        out = ransac.ransac_essential(
            ref_pts, p2, ok, iters=self.cfg.vo.ransac_iters,
            inlier_threshold=self.cfg.vo.inlier_threshold, generator=self._st.generator)
        return out, idx2

    def _slot_rows(self, slot: int):
        st = self._st.store
        return (st.descriptors[slot], st.kp_valid[slot], st.pts[slot],
                _host(st.R[slot]), _host(st.t[slot]))

    # -- public ---------------------------------------------------------------

    def process(self, frame):
        """Track one frame; returns a dict with the pose and bookkeeping."""
        m = self.metrics
        m.count("frames")
        with m.timer("extract"):
            feats, pts = self._features(frame)
        K = pts.shape[0]
        no_match = torch.full((K,), -1, dtype=torch.int32, device=self.device)
        no_inlier = torch.zeros(K, dtype=torch.bool, device=self.device)

        if self._num_kf == 0:
            R = np.eye(3, dtype=np.float32)
            t = np.zeros(3, np.float32)
            self._insert_keyframe(feats, pts, R, t, no_match, no_inlier, 0)
            m.count("keyframes_inserted")
            m.gauge("num_keyframes", self.num_keyframes)
            self._frame_idx += 1  # AFTER insert: counters[3] is the frame id
            self.trajectory.append(np.zeros(3))
            self._prev_pose = (R, t)
            return {"pose_R": R, "pose_t": t, "keyframe": True, "num_inliers": 0,
                    "map_inliers": 0, "lost": False, "relocalised": False}

        last = self._last
        with m.timer("track"):
            out, idx2 = self._localise_against(last["desc"], last["valid"], last["pts"],
                                               feats, pts)
            n_inl = int(out["num_inliers"])
        lost = n_inl < self.cfg.vo.min_inliers
        Rrel, trel = _host(out["R"]), _host(out["t"])
        if not lost and not (np.isfinite(Rrel).all() and np.isfinite(trel).all()):
            # a degenerate solve can emit a non-finite pose with high
            # "inlier" counts: treat it as lost
            m.count("nonfinite_poses")
            lost = True
        max_rot = self.cfg.vo.max_rel_rotation_deg
        if not lost and max_rot > 0:
            # motion-continuity guard: a large keyframe-relative rotation is
            # a mirrored RANSAC solution, not motion
            cosang = (np.trace(Rrel) - 1.0) / 2.0
            if np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))) > max_rot:
                m.count("rotation_jumps_rejected")
                lost = True
        relocalised = False
        n_map = 0
        map_idx = no_match
        if lost:
            # relocalise against the whole keyframe store; on success the
            # frame becomes a recovery keyframe, else the last pose is held
            m.count("frames_lost")
            self.frames_lost += 1
            with m.timer("relocalise"):
                rec = self._relocalise_feats(feats, pts, min_matches=self.reloc_min_matches)
            if rec is not None:
                R, t, _kf_ord = rec
                relocalised = True
                m.count("relocalisations")
                self.relocalisations += 1
            else:
                R, t = self._prev_pose
        else:
            trel = trel / max(np.linalg.norm(trel), 1e-9)
            # the essential-matrix translation stays unit-norm; map PnP
            # below supplies metric scale whenever landmarks are in view
            R = Rrel @ last["R"]
            t = Rrel @ last["t"] + trel

            used_pnp = False
            if self.cfg.map.track_map and self._num_lm > 0:
                with m.timer("map_track"):
                    Rm, tm, n_map_d, assoc = self._track_map(
                        self._st.lmap, feats, pts, self._tensor(R), self._tensor(t))
                    n_map = int(n_map_d)
                Rm, tm = _host(Rm), _host(tm)
                if (n_map >= self.cfg.map.min_map_inliers and np.isfinite(Rm).all()
                        and np.isfinite(tm).all()):
                    R, t = Rm, tm
                    map_idx = assoc
                    used_pnp = True
            if (self.cfg.vo.step_magnitude_prior and not used_pnp
                    and self._num_kf >= self.cfg.vo.step_prior_min_kf):
                # map-PnP dropout: the recent keyframe-interval speed x the
                # frames elapsed replaces the unit-norm displacement
                s_prior = float(keyframe_step_prior(self._st.store, self._num_kf,
                                                    self.capacity))
                if s_prior > 0:
                    d = s_prior * (self._since_kf + 1)
                    t_new = _host(rescale_step_to_prior(
                        self._tensor(R), self._tensor(t),
                        self._tensor(-last["R"].T @ last["t"]),
                        torch.tensor(d, dtype=torch.float32, device=self.device)))
                    if np.isfinite(t_new).all():
                        t = t_new
                        m.count("step_prior_fallbacks")

        self._since_kf += 1
        self.trajectory.append(-R.T @ t)

        map_dropout = (self.cfg.map.keyframe_on_map_dropout
                       and self.cfg.map.track_map and self._num_lm > 0
                       and not lost
                       and n_map < self.cfg.map.min_map_inliers
                       # with the landmark table full a new keyframe adds no
                       # coverage: the rule would only churn keyframes
                       and self._num_lm < self.cfg.map.max_landmarks)
        make_kf = (self.mapping and not lost
                   and (n_inl < self.keyframe_min_inliers
                        or self._since_kf >= self.keyframe_max_gap
                        or map_dropout))
        if make_kf:
            with m.timer("insert_ba"):
                self._insert_keyframe(feats, pts, R.astype(np.float32),
                                      t.astype(np.float32), idx2, out["inliers"],
                                      last["slot"], map_idx)
            m.count("keyframes_inserted")
            self._since_kf = 0
        elif relocalised:
            if self.mapping:
                # promote the relocalised view to a recovery keyframe (no
                # triangulation: no inlier matches to the previous keyframe)
                with m.timer("insert_ba"):
                    self._insert_keyframe(feats, pts, np.asarray(R, np.float32),
                                          np.asarray(t, np.float32), no_match, no_inlier,
                                          rec[2] % self.capacity)
                m.count("keyframes_inserted")
                self._since_kf = 0
                make_kf = True
            else:
                # localization-only: re-target tracking at the matched keyframe
                self._cache_last(rec[2] % self.capacity)
        self._frame_idx += 1  # AFTER insert: counters[3] is the frame id
        self._prev_pose = (np.asarray(R, np.float32), np.asarray(t, np.float32))

        m.count("track_inliers", n_inl)
        m.count("map_inliers", n_map)
        m.gauge("num_keyframes", self.num_keyframes)
        m.gauge("num_landmarks", self._num_lm)
        m.gauge("num_observations", self._num_obs)
        return {"pose_R": R, "pose_t": t, "keyframe": make_kf, "num_inliers": n_inl,
                "map_inliers": n_map, "lost": lost, "relocalised": relocalised}

    def _insert_keyframe(self, feats, pts, R, t, idx2, inliers, prev_slot: int,
                         map_idx=None):
        st = self.state  # sync counters into the device state
        if map_idx is None:
            map_idx = torch.full((pts.shape[0],), -1, dtype=torch.int32, device=self.device)
        self._st = self._insert(st, feats, pts, self._tensor(R), self._tensor(t), idx2,
                                inliers, prev_slot, map_idx)
        c = _host(self._st.counters)
        self._num_kf, self._num_lm, self._num_obs = int(c[0]), int(c[1]), int(c[2])
        self._culled_slots.discard((self._num_kf - 1) % self.capacity)
        self._cache_last((self._num_kf - 1) % self.capacity)
        if self._num_kf >= 2:
            self._local_ba()

    # -- bundle adjustment ----------------------------------------------------

    def _window(self, size: Optional[int] = None):
        """(ordinals, slots) of the newest ``size`` keyframes, oldest first.
        Culled slots are skipped."""
        w = min(size or self.cfg.ba.window, self._num_kf)
        pairs = [(o, o % self.capacity) for o in range(self._num_kf - w, self._num_kf)
                 if (o % self.capacity) not in self._culled_slots]
        return [o for o, _ in pairs], [s for _, s in pairs]

    def _window_covis(self):
        """(ordinals, slots) of the newest keyframe plus its most covisible
        keyframes; the temporal window while it has no covisible partner."""
        w = self.cfg.ba.window
        st = self._st
        weights = self.covisibility()
        valid, ordinal = _host(st.store.valid), _host(st.store.ordinal)
        cur = (self._num_kf - 1) % self.capacity
        wrow = np.where(valid, weights[cur], -1)
        wrow[cur] = -1
        order = np.argsort(-wrow, kind="stable")
        picked = [cur] + [int(s) for s in order if wrow[s] > 0][: w - 1]
        if len(picked) < 2:
            return self._window()
        picked.sort(key=lambda s: int(ordinal[s]))
        return [int(ordinal[s]) for s in picked], picked

    def _local_ba(self):
        bc = self.cfg.ba
        if bc.covisibility_window and self._num_kf > bc.window:
            ordinals, slots = self._window_covis()
        else:
            ordinals, slots = self._window()
        self._run_ba(ordinals, slots, C=bc.window, max_points=bc.max_points,
                     max_obs=bc.max_obs, iters=bc.gn_iters,
                     fixed_observers=bc.fixed_observers)

    def global_ba(self, iters: Optional[int] = None):
        """Full-map bundle adjustment: all stored keyframes + landmarks, the
        oldest two held fixed; the same machinery as the windowed pass,
        sized to the store (matrix-free CG above 48 cameras)."""
        mc, bc = self.cfg.map, self.cfg.ba
        ordinals, slots = self._window(size=self.capacity)
        with self.metrics.timer("global_ba"):
            self._run_ba(ordinals, slots, C=self.capacity, max_points=mc.max_landmarks,
                         max_obs=mc.max_obs, iters=iters or bc.global_iters,
                         fixed_observers=0)

    def _run_ba(self, ordinals, slots, C: int, max_points: int, max_obs: int, iters: int,
                fixed_observers: Optional[int] = None):
        bc = self.cfg.ba
        if len(ordinals) < 2 or self._num_obs == 0:
            return
        st = self._st
        # one host copy of the observation tables (per keyframe, not per frame)
        obs_kf, obs_lm = _host(st.obs.kf), _host(st.obs.lm)
        obs_uv, obs_valid = _host(st.obs.uv), _host(st.obs.valid)
        kf_ordinal = _host(st.store.ordinal)

        # rows whose keyframe ordinal is in the window (``ordinals`` sorted)
        ords = np.asarray(ordinals)
        ords_of_obs = kf_ordinal[obs_kf]
        pos_in = np.searchsorted(ords, ords_of_obs)
        member = (pos_in < len(ords)) & (ords[np.minimum(pos_in, len(ords) - 1)]
                                         == ords_of_obs)
        sel_idx = np.where(obs_valid & member)[0]
        if len(sel_idx) == 0:
            return
        lm_slots = np.unique(obs_lm[sel_idx])[:max_points]
        pos = np.searchsorted(lm_slots, obs_lm[sel_idx])
        in_window = (pos < len(lm_slots)) & (
            lm_slots[np.minimum(pos, len(lm_slots) - 1)] == obs_lm[sel_idx])
        rows = sel_idx[in_window][:max_obs]
        if len(rows) == 0:
            return

        # out-of-window FIXED observers: keyframes outside the window that
        # observe window landmarks join with frozen poses, ordered first so
        # the n_fixed prefix pins them
        fixed_cap = 0 if fixed_observers is None else fixed_observers
        fixed_slots = []
        fx_rows = np.empty(0, np.int64)
        if fixed_cap > 0:
            pos_all = np.searchsorted(lm_slots, obs_lm)
            lm_member = (pos_all < len(lm_slots)) & (
                lm_slots[np.minimum(pos_all, len(lm_slots) - 1)] == obs_lm)
            kf_valid = _host(st.store.valid)
            out_sel = obs_valid & lm_member & ~member & kf_valid[obs_kf]
            counts = np.bincount(obs_kf[out_sel], minlength=self.capacity)
            order = np.argsort(-counts, kind="stable")
            fixed_slots = [int(s) for s in order if counts[s] > 0][:fixed_cap]
            if fixed_slots:
                in_fixed = np.zeros(self.capacity, bool)
                in_fixed[fixed_slots] = True
                fx_rows = np.where(out_sel & in_fixed[obs_kf])[0][: max_obs - len(rows)]
        n_fx = len(fixed_slots)
        # >= 2 pinned cameras always (gauge + monocular scale anchor)
        n_fixed = max(2, n_fx)

        cam_slots = list(fixed_slots) + list(slots)
        cam_of_slot = np.full(self.capacity, -1, np.int64)
        cam_of_slot[np.asarray(cam_slots, np.int64)] = np.arange(len(cam_slots))

        C_total = C + fixed_cap
        O, P_ = max_obs, max_points
        obs_cam = np.zeros(O, np.int32)
        obs_pt = np.zeros(O, np.int32)
        uv = np.zeros((O, 2), np.float32)
        ov = np.zeros(O, bool)
        allrows = np.concatenate([rows, fx_rows]) if len(fx_rows) else rows
        nr = len(allrows)
        obs_cam[:nr] = cam_of_slot[obs_kf[allrows]]
        obs_pt[:nr] = np.searchsorted(lm_slots, obs_lm[allrows])
        uv[:nr] = obs_uv[allrows]
        ov[:nr] = True

        cam_idx = torch.as_tensor(np.asarray(cam_slots, np.int64), device=self.device)
        Rs = np.broadcast_to(np.eye(3, dtype=np.float32), (C_total, 3, 3)).copy()
        ts = np.zeros((C_total, 3), np.float32)
        Rs[:len(cam_slots)] = _host(st.store.R[cam_idx])
        ts[:len(cam_slots)] = _host(st.store.t[cam_idx])
        cam_valid = np.zeros(C_total, bool)
        cam_valid[:len(cam_slots)] = True

        lm_idx = torch.as_tensor(lm_slots.astype(np.int64), device=self.device)
        points = np.zeros((P_, 3), np.float32)
        points[:len(lm_slots)] = _host(st.lmap.xyz[lm_idx])
        pt_valid = np.zeros(P_, bool)
        pt_valid[:len(lm_slots)] = True

        dev = self.device
        prob = ba.BAProblem(*(torch.as_tensor(a, device=dev) for a in (
            Rs, ts, points, obs_cam, obs_pt, uv, ov, cam_valid, pt_valid)))
        out, _ = ba.bundle_adjust(prob, iters=iters, damping=bc.damping, huber=bc.huber,
                                  n_fixed=n_fixed)

        # a degenerate Schur solve must not poison the map: reject the whole
        # update rather than commit non-finite poses or points
        lo, hi = n_fx, n_fx + len(slots)   # free (window) camera block
        outR, outt = out.R[lo:hi], out.t[lo:hi]
        outX = out.points[:len(lm_slots)]
        if not all(bool(torch.isfinite(x).all()) for x in (outR, outt, outX)):
            self.metrics.count("ba_nonfinite_rejected")
            return

        sl = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
        store = st.store._replace(R=st.store.R.index_copy(0, sl, outR),
                                  t=st.store.t.index_copy(0, sl, outt))
        lmap = st.lmap._replace(xyz=st.lmap.xyz.index_copy(0, lm_idx, outX))
        self._st = st._replace(store=store, lmap=lmap)
        self._cache_last((self._num_kf - 1) % self.capacity)

    def cull_landmarks(self, max_residual: Optional[float] = None, min_obs: int = 2):
        """Drop landmarks that reproject badly against the current keyframe
        poses or have too little support (backend/keyframes.cull_landmarks).
        Returns the number culled. Slots are invalidated, not reclaimed."""
        mc = self.cfg.map
        thr = max_residual if max_residual is not None else 2.0 * mc.pnp_inlier_threshold
        st = self._st
        with self.metrics.timer("cull"):
            before = int(st.lmap.valid.sum())
            lmap, obs = kfs.cull_landmarks(st.store, st.lmap, st.obs, thr, min_obs)
            culled = before - int(lmap.valid.sum())
        self._st = st._replace(lmap=lmap, obs=obs)
        self.metrics.count("landmarks_culled", culled)
        return culled

    def covisibility(self) -> np.ndarray:
        """(F, F) shared-landmark counts between keyframe slots (the
        ORB-SLAM covisibility graph)."""
        st = self._st
        return _host(kfs.covisibility(st.store, st.lmap, st.obs))

    # -- loop closure / relocalisation -----------------------------------------

    def match_keyframe(self, feats, pts, exclude_recent: int = 0, min_matches: int = 30,
                       exclude_slots=None):
        """Match features against the whole keyframe store at once; localise
        against the best-supported keyframe.

        Returns (kf_ordinal, R_rel, t_rel_unit, num_inliers), the relative
        pose mapping the matched keyframe's camera to the query camera, or
        (-1, None, None, 0) when no keyframe reaches ``min_matches``.
        Keyframes with ordinal >= num_keyframes - exclude_recent are skipped.
        """
        if self._num_kf - exclude_recent <= 0:
            return -1, None, None, 0
        counts = _host(self._store_counts(self._st.store, feats))
        ordinal = _host(self._st.store.ordinal)
        valid = _host(self._st.store.valid)
        eligible = valid & (ordinal < self._num_kf - exclude_recent)
        if exclude_slots is not None:
            eligible = eligible & ~np.asarray(exclude_slots, bool)
        counts = np.where(eligible, counts, -1)
        best_slot = int(np.argmax(counts))
        if counts[best_slot] < min_matches:
            return -1, None, None, 0
        desc, kvalid, ref_pts, _R, _t = self._slot_rows(best_slot)
        out, _ = self._localise_against(desc, kvalid, ref_pts, feats, pts)
        n_inl = int(out["num_inliers"])
        if n_inl < max(self.cfg.vo.min_inliers, min_matches // 2):
            return -1, None, None, 0
        t = _host(out["t"])
        t = t / max(np.linalg.norm(t), 1e-9)
        return int(ordinal[best_slot]), _host(out["R"]), t, n_inl

    def _loop_neighbourhood_pnp(self, old_slot: int, desc, kvalid, pts, R_init, t_init,
                                min_inliers: int, exclude_recent: int = 0,
                                max_neighbours: Optional[int] = None):
        """Metric re-measurement of the loop pose: PnP of the current
        keyframe's features against the landmarks of the matched keyframe
        (stage A), then against the union with its most covisible
        neighbours, matched through a projection gate at the stage-A pose
        (stage B, kept if it has at least stage A's support).

        Returns {R, t, num_inliers, slots, supports, lm, idx2, inliers, uv}
        or None when the neighbourhood has too few usable landmarks or PnP
        support.
        """
        mc = self.cfg.map
        st = self._st
        slots = [old_slot]
        n_nb = mc.loop_neighbours if max_neighbours is None else max_neighbours
        if n_nb > 0:
            covis = self.covisibility()
            valid, ordinal = _host(st.store.valid), _host(st.store.ordinal)
            wrow = np.where(valid & (ordinal < self._num_kf - exclude_recent),
                            covis[old_slot], -1)
            wrow[old_slot] = -1
            order = np.argsort(-wrow, kind="stable")
            slots += [int(s) for s in order if wrow[s] >= mc.loop_neighbour_min_covis][:n_nb]
        okf, ovalid, olm = _host(st.obs.kf), _host(st.obs.valid), _host(st.obs.lm)
        lmv = _host(st.lmap.valid)
        L = lmv.shape[0]
        member = np.zeros((len(slots), L), bool)
        for i, s in enumerate(slots):
            rows = olm[(okf == s) & ovalid]
            member[i, rows[lmv[rows]]] = True
        counts = member.sum(0)
        K = int(desc.shape[0])
        lm_desc_all = _host(st.lmap.descriptors)
        lm_xyz_all = _host(st.lmap.xyz)
        pts_host = _host(pts)
        dev = self.device

        def pad(lm):
            ldesc = np.zeros((K, desc.shape[1]), np.int32)
            lxyz = np.zeros((K, 3), np.float32)
            ldesc[: lm.size] = lm_desc_all[lm]
            lxyz[: lm.size] = lm_xyz_all[lm]
            lok = np.zeros(K, bool)
            lok[: lm.size] = True
            return ldesc, lxyz, lok

        def solve(lm, idx2, R0, t0, coarse: bool):
            """Fine PnP against ``lm`` rows; a wide first stage when coarse
            (the drifted baseline can put the start outside the fine Huber
            basin)."""
            _, lxyz, lok = pad(lm)
            ok = torch.as_tensor(lok & (idx2 >= 0), device=dev)
            uv = pts_host[np.clip(idx2, 0, K - 1)]
            xyz_t = torch.as_tensor(lxyz, device=dev)
            uv_t = torch.as_tensor(uv, device=dev)
            R0, t0 = self._tensor(R0), self._tensor(t0)
            if coarse:
                c = pnp.motion_only_ba(R0, t0, xyz_t, uv_t, ok, iters=15, huber=5e-2)
                R0, t0 = c["R"], c["t"]
            return pnp.motion_only_ba(R0, t0, xyz_t, uv_t, ok, iters=15), uv

        # stage A: the matched keyframe's own landmarks, descriptor-only
        lm_a = np.nonzero(member[0])[0][:K]
        if lm_a.size < min_inliers:
            return None
        ldesc_a, _, lok_a = pad(lm_a)
        idx2_a, _ = self._match(torch.as_tensor(ldesc_a, device=dev), desc,
                                torch.as_tensor(lok_a, device=dev), kvalid)
        idx2_a = _host(idx2_a)
        out_a, uv_a = solve(lm_a, idx2_a, R_init, t_init, coarse=True)
        n_a = int(out_a["num_inliers"])
        if n_a < min_inliers:
            return None
        lm, idx2, out, uv = lm_a, idx2_a, out_a, uv_a

        if len(slots) > 1:
            # stage B: the neighbourhood union, gated at the converged pose;
            # landmarks seen by the most neighbourhood keyframes first
            lm_u = np.nonzero(counts > 0)[0]
            lm_u = lm_u[np.argsort(-counts[lm_u], kind="stable")][:K]
            ldesc_u, lxyz_u, lok_u = pad(lm_u)
            Rb, tb = _host(out_a["R"]), _host(out_a["t"])
            xc = lxyz_u @ Rb.T + tb
            z = xc[:, 2]
            proj = np.where((z > 1e-6)[:, None], xc[:, :2] / np.maximum(z, 1e-6)[:, None],
                            np.float32(1e6)).astype(np.float32)
            radius = self.cfg.map.gate_radius or 4.0 * self.cfg.map.pnp_inlier_threshold
            idx2_u, _ = matching.match_gated(
                torch.as_tensor(ldesc_u, device=dev), desc,
                torch.as_tensor(lok_u, device=dev), kvalid,
                torch.as_tensor(proj, device=dev), pts, float(radius),
                max_distance=self.cfg.map.map_match_max_distance,
                ratio=self.cfg.matcher.ratio, cross_check=True)
            idx2_u = _host(idx2_u)
            out_b, uv_b = solve(lm_u, idx2_u, Rb, tb, coarse=False)
            if int(out_b["num_inliers"]) >= n_a:
                lm, idx2, out, uv = lm_u, idx2_u, out_b, uv_b

        inl = _host(out["inliers"])
        inl_of_lm = np.zeros(L, bool)
        inl_of_lm[lm] = inl[: lm.size]
        supports = [int((member[i] & inl_of_lm).sum()) for i in range(len(slots))]
        return {"R": _host(out["R"]), "t": _host(out["t"]),
                "num_inliers": int(out["num_inliers"]), "slots": slots,
                "supports": supports, "lm": lm, "idx2": idx2, "inliers": inl, "uv": uv}

    def _fuse_loop_observations(self, cur_slot: int, res: dict) -> int:
        """Loop fusion: append observation rows linking the current keyframe
        to the PnP-inlier old landmarks it does not observe yet. Returns the
        number of rows fused."""
        st = self._st
        okf, ovalid, olm = _host(st.obs.kf), _host(st.obs.valid), _host(st.obs.lm)
        existing = np.zeros(st.lmap.capacity, bool)
        existing[olm[(okf == cur_slot) & ovalid]] = True
        lm, idx2, inl, uv = res["lm"], res["idx2"], res["inliers"], res["uv"]
        K = idx2.shape[0]
        lm_slot = np.zeros(K, np.int32)
        mask = np.zeros(K, bool)
        lm_slot[: lm.size] = lm
        mask[: lm.size] = inl[: lm.size] & ~existing[lm]
        n_fuse = int(mask.sum())
        if n_fuse == 0:
            return 0
        dev = self.device
        lmap, obs, obs_cur = kfs.add_observations(
            st.lmap, st.obs, self._num_obs, cur_slot, torch.as_tensor(lm_slot, device=dev),
            torch.as_tensor(np.asarray(uv, np.float32), device=dev),
            torch.as_tensor(mask, device=dev))
        self._st = st._replace(lmap=lmap, obs=obs)
        self._num_obs = int(obs_cur)
        self.metrics.count("loop_obs_fused", n_fuse)
        return n_fuse

    def _detect_loop(self, min_matches: int = 40, exclude_recent: int = 3,
                     exclude_covisible_weight: int = 0):
        """Loop detection + metric measurement + fusion (shared by
        try_close_loop and close_loop). One weighted pose-graph edge per old
        keyframe whose own landmarks supply at least
        cfg.map.loop_edge_min_support PnP inliers; the essential-matrix edge
        to the matched keyframe when there is none. With
        ``exclude_covisible_weight`` > 0, keyframes sharing at least that
        many landmarks with the query are excluded. Returns (matched
        ordinal, edges) or None."""
        if self._num_kf < exclude_recent + 2:
            return None
        m = self.metrics
        cur_slot = (self._num_kf - 1) % self.capacity
        desc, kvalid, pts, R_cur, t_cur = self._slot_rows(cur_slot)
        feats_like = Features(
            codes=self._st.store.codes[cur_slot], valid=kvalid,
            angles=torch.zeros(kvalid.shape[0], dtype=torch.uint8, device=self.device),
            descriptors=desc)
        excl = None
        if exclude_covisible_weight > 0:
            excl = self.covisibility()[cur_slot] >= exclude_covisible_weight
        with m.timer("loop_detect"):
            idx, R_rel, t_unit, n_sup = self.match_keyframe(
                feats_like, pts, exclude_recent=exclude_recent, min_matches=min_matches,
                exclude_slots=excl)
        if idx < 0:
            return None
        old_slot = idx % self.capacity
        R_old, t_old = _host(self._st.store.R[old_slot]), _host(self._st.store.t[old_slot])
        # the current-estimate baseline length sets the edge scale
        scale = float(np.linalg.norm((-R_cur.T @ t_cur) - (-R_old.T @ t_old)))
        # RANSAC measures x_cur = R_rel x_old + t_rel; the pose-graph edge is
        # Z = X_old^-1 X_cur, so conjugate
        R_meas = R_rel @ R_old
        t_meas = R_rel @ t_old + t_unit * scale
        res = self._loop_neighbourhood_pnp(
            old_slot, desc, kvalid, pts, R_meas, t_meas,
            min_inliers=max(self.cfg.map.min_map_inliers, min_matches // 2),
            exclude_recent=exclude_recent)
        edges = []
        cur_ord = self._num_kf - 1
        if res is not None:
            R_meas, t_meas, n_sup = res["R"], res["t"], res["num_inliers"]
            m.count("loop_edges_metric")
            ordinal = _host(self._st.store.ordinal)
            store_R, store_t = _host(self._st.store.R), _host(self._st.store.t)
            for s, sup in zip(res["slots"], res["supports"]):
                if sup < self.cfg.map.loop_edge_min_support:
                    continue
                edges.append((int(ordinal[s]), cur_ord, store_R[s].T @ R_meas,
                              store_R[s].T @ (t_meas - store_t[s]), float(sup)))
            if self.cfg.map.loop_fuse_observations:
                self._fuse_loop_observations(cur_slot, res)
        if not edges:
            edges = [(idx, cur_ord, R_old.T @ R_meas, R_old.T @ (t_meas - t_old),
                      float(n_sup))]
        return idx, edges

    def try_close_loop(self, min_matches: int = 40, exclude_recent: int = 3,
                       exclude_covisible_weight: int = 0):
        """Detect a loop for the newest keyframe and optimise the pose graph.
        Returns the matched keyframe ordinal, or -1."""
        det = self._detect_loop(min_matches, exclude_recent, exclude_covisible_weight)
        if det is None:
            return -1
        idx, edges = det
        with self.metrics.timer("pose_graph"):
            self.optimise_pose_graph(loop_edges=edges)
        self.metrics.count("loops_closed")
        return idx

    def map_consistency(self, obs_ref=None):
        """Mean Huber-robust reprojection cost per valid observation of the
        whole map at the current poses (ground-truth free). ``obs_ref``, a
        host tuple (kf, lm, uv, valid), freezes the observation set so a
        branch cannot score well by culling its worst rows. Returns
        (mean_cost, num_obs)."""
        st = self._st
        if obs_ref is None:
            okf, olm, ouv, ov = (_host(x) for x in (st.obs.kf, st.obs.lm, st.obs.uv,
                                                    st.obs.valid))
        else:
            okf, olm, ouv, ov = obs_ref
        kv = _host(st.store.valid)
        lv = _host(st.lmap.valid) if obs_ref is None else np.ones(st.lmap.capacity, bool)
        sel = ov & kv[okf] & lv[olm]
        n = int(sel.sum())
        if n == 0:
            return 0.0, 0
        R = _host(st.store.R)[okf[sel]]
        t = _host(st.store.t)[okf[sel]]
        X = _host(st.lmap.xyz)[olm[sel]]
        xc = np.einsum("nij,nj->ni", R, X) + t
        z = np.maximum(xc[:, 2], 1e-6)
        rn = np.linalg.norm(xc[:, :2] / z[:, None] - ouv[sel], axis=1)
        h = self.cfg.ba.huber or 6e-3
        rho = np.where(rn <= h, rn * rn, h * (2 * rn - h))
        return float(rho.mean()), n

    def close_loop(self, min_matches: int = 40, exclude_recent: int = 3,
                   exclude_covisible_weight: int = 0):
        """Production loop closure: detect + measure + fuse, then pick the
        better of two closures by measurement. From the same snapshot: (A)
        three rounds of global BA + landmark culling against the fused
        observations; (B) the pose graph over the loop edges first, then the
        same rounds. B wins only when its ``map_consistency`` over the frozen
        post-fusion observations is below 0.9 of A's. Returns {"loop",
        "used_graph", "cost_ba", "cost_graph"}."""
        det = self._detect_loop(min_matches, exclude_recent, exclude_covisible_weight)
        if det is None:
            return {"loop": -1, "used_graph": False}
        idx, edges = det
        m = self.metrics
        snap = self.state
        obs_ref = tuple(_host(x) for x in (snap.obs.kf, snap.obs.lm, snap.obs.uv,
                                           snap.obs.valid))

        def refine():
            for _ in range(3):
                self.global_ba()
                self.cull_landmarks()

        refine()                                     # branch A: geometry only
        cost_ba, _ = self.map_consistency(obs_ref)
        state_ba = self.state
        self.set_state(snap)                         # branch B: graph first
        with m.timer("pose_graph"):
            self.optimise_pose_graph(loop_edges=edges)
        refine()
        cost_graph, _ = self.map_consistency(obs_ref)
        used_graph = cost_graph < 0.9 * cost_ba
        if not used_graph:
            self.set_state(state_ba)
        m.count("loops_closed")
        if used_graph:
            m.count("loops_closed_graph")
        return {"loop": idx, "used_graph": used_graph, "cost_ba": cost_ba,
                "cost_graph": cost_graph}

    def _relocalise_feats(self, feats, pts, min_matches: int = 30):
        """Localise extracted features against the keyframe map. Returns
        (R, t, kf_ordinal) or None."""
        idx, R_rel, t_unit, _ = self.match_keyframe(feats, pts, min_matches=min_matches)
        if idx < 0:
            return None
        slot = idx % self.capacity
        R_kf, t_kf = _host(self._st.store.R[slot]), _host(self._st.store.t[slot])
        R = R_rel @ R_kf
        t = R_rel @ t_kf + t_unit
        if self.cfg.map.track_map and self._num_lm > 0:
            Rm, tm, n_map, _ = self._track_map(self._st.lmap, feats, pts, self._tensor(R),
                                               self._tensor(t))
            if int(n_map) >= self.cfg.map.min_map_inliers:
                R, t = _host(Rm), _host(tm)
        return R, t, idx

    def relocalise(self, frame, min_matches: int = 30):
        """Localise a frame against the keyframe map (kidnapped-robot case).
        Returns (R, t) world->camera, or None if no keyframe matches."""
        feats, pts = self._features(frame)
        rec = self._relocalise_feats(feats, pts, min_matches=min_matches)
        return None if rec is None else (rec[0], rec[1])

    def optimise_pose_graph(self, loop_edges=()):
        """Global pose-graph GN over the stored keyframes: consecutive
        odometry edges weighted by covisibility, plus ``loop_edges`` =
        [(ordinal_i, ordinal_j, R_ij, t_ij[, weight]), ...]. Afterwards every
        landmark moves with its anchor keyframe (its earliest in-graph
        observer), keeping its camera-frame coordinates."""
        views = self.keyframes
        n = len(views)
        if n < 2:
            return
        dev = self.device
        slots = np.int64([v.slot for v in views])
        node_of_ordinal = {v.index: i for i, v in enumerate(views)}
        R_host = np.stack([v.R for v in views])
        t_host = np.stack([v.t for v in views])
        R, t = torch.as_tensor(R_host, device=dev), torch.as_tensor(t_host, device=dev)
        # consecutive odometry edges in one batched call
        Rij, tij = se3.compose(*se3.inverse(R[:-1], t[:-1]), R[1:], t[1:])
        ei, ej = list(range(n - 1)), list(range(1, n))
        eR, et = [_host(Rij)], [_host(tij)]
        # odometry weights: shared-landmark counts, at least 1
        covis = self.covisibility()
        ew = [max(1.0, float(covis[slots[k], slots[k + 1]])) for k in range(n - 1)]
        extra_R, extra_t = [], []
        for edge in loop_edges:
            i, j, Rl, tl = edge[:4]
            wl = float(edge[4]) if len(edge) > 4 else 1.0
            if i not in node_of_ordinal or j not in node_of_ordinal:
                continue
            ei.append(node_of_ordinal[i])
            ej.append(node_of_ordinal[j])
            extra_R.append(np.asarray(Rl, np.float32))
            extra_t.append(np.asarray(tl, np.float32))
            ew.append(max(1.0, wl))
        if extra_R:
            eR.append(np.stack(extra_R))
            et.append(np.stack(extra_t))
        g = pose_graph.PoseGraph(
            R=R, t=t,
            edge_i=torch.as_tensor(np.int64(ei), device=dev),
            edge_j=torch.as_tensor(np.int64(ej), device=dev),
            edge_R=torch.as_tensor(np.concatenate(eR), device=dev),
            edge_t=torch.as_tensor(np.concatenate(et), device=dev),
            edge_valid=torch.ones(len(ei), dtype=torch.bool, device=dev),
            node_valid=torch.ones(n, dtype=torch.bool, device=dev),
            edge_weight=torch.as_tensor(np.float32(ew), device=dev))
        sim3 = bool(self.cfg.map.pose_graph_sim3)
        g2, _ = pose_graph.optimize(g, iters=8, damping=1e-5, sim3=sim3)
        g2R, g2t = _host(g2.R), _host(g2.t)
        if not (np.isfinite(g2R).all() and np.isfinite(g2t).all()):
            # degenerate normal equations: keep the current poses
            self.metrics.count("pose_graph_nonfinite_rejected")
            return
        if sim3:
            # SE(3) poses from the Sim(3) solution: T_iw = [R_i | t_i / s_i]
            s_node = np.exp(_host(g2.node_logs))
        else:
            s_node = np.ones(n, np.float32)
        st = self._st
        sl = torch.as_tensor(slots, device=dev)
        store = st.store._replace(
            R=st.store.R.index_copy(0, sl, g2.R),
            t=st.store.t.index_copy(0, sl, torch.as_tensor(
                (g2t / s_node[:, None]).astype(np.float32), device=dev)))

        # transport landmarks with their anchor keyframe's correction
        obs_kf, obs_lm, obs_valid = _host(st.obs.kf), _host(st.obs.lm), _host(st.obs.valid)
        node_of_slot = np.full(self.capacity, -1, np.int64)
        node_of_slot[slots] = np.arange(n)
        rows = obs_valid & (node_of_slot[obs_kf] >= 0)
        L = st.lmap.capacity
        anchor = np.full(L, n, np.int64)  # n = "no in-graph observer"
        np.minimum.at(anchor, obs_lm[rows], node_of_slot[obs_kf[rows]])
        lm_rows = np.where(_host(st.lmap.valid) & (anchor < n))[0]
        lmap = st.lmap
        if lm_rows.size:
            a = anchor[lm_rows]
            X = _host(st.lmap.xyz)[lm_rows]
            xc = np.einsum("nij,nj->ni", R_host[a], X) + t_host[a]
            # X' = R1^T (xc - t1) / s1 (SE(3): s1 = 1)
            Xn = (np.einsum("nji,nj->ni", g2R[a], xc - g2t[a])
                  / s_node[a, None]).astype(np.float32)
            lmap = st.lmap._replace(xyz=st.lmap.xyz.index_copy(
                0, torch.as_tensor(lm_rows, device=dev), torch.as_tensor(Xn, device=dev)))
        self._st = st._replace(store=store, lmap=lmap)
        self._cache_last((self._num_kf - 1) % self.capacity)

    # -- introspection ----------------------------------------------------------

    @property
    def keyframes(self):
        """Host views of stored keyframes, ordered by insertion ordinal."""
        st = self._st.store
        ordinal, valid, frame_id = _host(st.ordinal), _host(st.valid), _host(st.frame_id)
        R, t = _host(st.R), _host(st.t)
        order = [int(s) for s in np.argsort(ordinal) if valid[s]]
        return [KeyframeView(index=int(ordinal[s]), frame=int(frame_id[s]), slot=s,
                             R=R[s], t=t[s]) for s in order]

    @property
    def num_keyframes(self) -> int:
        return min(self._num_kf, self.capacity) - len(self._culled_slots)

    @property
    def keyframes_inserted(self) -> int:
        """Total keyframes ever inserted (monotonic)."""
        return self._num_kf

    @property
    def num_landmarks(self) -> int:
        return self._num_lm

    def landmark_positions(self) -> np.ndarray:
        """(N, 3) world positions of live landmarks."""
        return _host(self._st.lmap.xyz)[_host(self._st.lmap.valid)]

    def keyframe_positions(self) -> np.ndarray:
        return np.stack([-v.R.T @ v.t for v in self.keyframes])

    @property
    def keyframe_frames(self):
        """Source frame number of each keyframe."""
        return [v.frame for v in self.keyframes]


def slam_state_from_numpy(state, device="cuda", seed: int = 7) -> SlamState:
    """The port's ``SlamState`` from a JAX ``SlamState`` given as numpy arrays.

    ``state`` has ``store``, ``lmap``, ``obs`` (the JAX package's uint32,
    bool, int32 and float32 arrays, field for field) and ``counters``; its
    ``key`` is not carried (``jax.random`` draws cannot be reproduced), a
    generator seeded with ``seed`` takes its place.
    """
    def tensor(a, dtype):     # a copy: arrays from JAX are read-only
        return torch.tensor(np.asarray(a, dtype), device=device)

    def words(a):             # uint32 words -> their int32 bit patterns
        return tensor(np.asarray(a, np.uint32).view(np.int32), np.int32)

    s, lm, ob = state.store, state.lmap, state.obs
    store = kfs.KeyframeStore(
        R=tensor(s.R, np.float32), t=tensor(s.t, np.float32),
        codes=tensor(np.asarray(s.codes, np.uint32), np.int64),
        kp_valid=tensor(s.kp_valid, bool), descriptors=words(s.descriptors),
        pts=tensor(s.pts, np.float32), frame_id=tensor(s.frame_id, np.int32),
        ordinal=tensor(s.ordinal, np.int32), valid=tensor(s.valid, bool))
    lmap = kfs.LandmarkMap(xyz=tensor(lm.xyz, np.float32), descriptors=words(lm.descriptors),
                           obs_count=tensor(lm.obs_count, np.int32),
                           valid=tensor(lm.valid, bool))
    obs = kfs.ObservationTable(kf=tensor(ob.kf, np.int32), lm=tensor(ob.lm, np.int32),
                               uv=tensor(ob.uv, np.float32), valid=tensor(ob.valid, bool))
    return SlamState(store, lmap, obs, tensor(state.counters, np.int32),
                     _generator(device, seed))
