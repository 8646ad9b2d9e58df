"""The comparisons that decide ``correct``, run once the window has closed.

What the timed path produced is held against plain references that import
nothing of the port (``reference/``):

* every keyframe in the final map that a window frame made: its stored
  codes, validity, descriptors and normalised points against the reference
  frontend on the same rendered frame (the pyramid, FAST, Harris, NMS, the
  top-k, orientation and BRIEF), bit for bit;
* every landmark that such a keyframe triangulated: its two observations
  must be a pair that the reference matcher (K5's Hamming match with the
  ratio test and the cross-check) makes between the previous keyframe and
  this one;
* every pose the window returned, against the scene's exact poses: the
  rotation from each pose to the one four frames later. The camera centres
  after a Sim(3) alignment are printed, not compared: on this scene the
  port's monocular translation does not follow the camera, and a run that
  returns no translation at all reads like a sound one.

Each number is printed beside its limit; the limits of a cell are
``limits/<cell>.json``: {"name": [lowest allowed, highest allowed]}.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from portbench import roofline
from portbench.reference import lens, orb, trajectory

HERE = Path(__file__).resolve().parent


def load_limits(workload: str) -> dict:
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def reference_frontend(cfg: dict, device, precision: str = "exact") -> orb.Frontend:
    return orb.Frontend(cfg["width"], cfg["height"], cfg["levels"], 1.0 / cfg["scale_factor"],
                        cfg["max_keypoints"], cfg["fast_threshold"], cfg["harris_threshold"],
                        border=16, words=8,
                        intrinsics=(cfg["fx"], cfg["fy"], cfg["cx"], cfg["cy"]),
                        lens=lens.terms(cfg), device=device, precision=precision)


def _np(x):
    return x.detach().cpu().numpy()


class Host:
    """The final SlamState's tables as numpy arrays."""

    def __init__(self, state):
        st, lm, ob = state.store, state.lmap, state.obs
        self.codes, self.kp_valid = _np(st.codes), _np(st.kp_valid)
        self.desc, self.pts = _np(st.descriptors), _np(st.pts)
        self.frame_id, self.ordinal, self.valid = _np(st.frame_id), _np(st.ordinal), _np(st.valid)
        self.lm_desc, self.lm_valid = _np(lm.descriptors), _np(lm.valid)
        self.okf, self.olm, self.ouv, self.ovalid = (_np(ob.kf), _np(ob.lm),
                                                     _np(ob.uv), _np(ob.valid))

    def slot_of(self, ordinal: int):
        s = np.nonzero(self.valid & (self.ordinal == ordinal))[0]
        return int(s[0]) if len(s) else None


def rows_off(codes, valid, desc, pts, ref: orb.Frame) -> int:
    """Keypoint rows that differ from the reference frame's: in code,
    validity, descriptor words, or normalised point by more than 1e-5 (a
    fiftieth of a pixel)."""
    rvalid = _np(ref.valid)
    off = (codes != _np(ref.codes)) | (valid != rvalid)
    off |= rvalid & ((desc != _np(ref.descriptors)).any(1)
                     | (np.abs(pts - _np(ref.pts)) > 1e-5).any(1))
    return int(off.sum())


def frontend_rows_off(host: Host, slot: int, ref: orb.Frame) -> int:
    """``rows_off`` of a keyframe stored in the final map."""
    return rows_off(host.codes[slot], host.kp_valid[slot], host.desc[slot], host.pts[slot], ref)


def control_rows_off(stream, cfg: dict, frames, device) -> int:
    """The control's reading of ``feature_rows_off``: the reference frontend
    with its pyramid resampled in bfloat16, put in the program's place on
    the given stream frames and judged against the exact reference."""
    exact = reference_frontend(cfg, device)
    low = reference_frontend(cfg, device, precision="bfloat16")
    off = 0
    for k in frames:
        b = low(stream.frame(k))
        off += rows_off(_np(b.codes), _np(b.valid), _np(b.descriptors), _np(b.pts),
                        exact(stream.frame(k)))
    return off


def _first_two_rows(host: Host):
    """For each landmark with at least two valid observation rows: its
    first two rows in table order (the order they were appended)."""
    rows = np.nonzero(host.ovalid & host.lm_valid[host.olm])[0]
    order = rows[np.argsort(host.olm[rows], kind="stable")]
    lms, first, counts = np.unique(host.olm[order], return_index=True, return_counts=True)
    two = counts >= 2
    return lms[two], order[first[two]], order[first[two] + 1]


def _index_of(pts: np.ndarray, valid: np.ndarray):
    """{point bytes: [keypoint indices]}: keypoints of two levels can land on
    one level-0 point."""
    table = {}
    for i in np.nonzero(valid)[0]:
        table.setdefault(pts[i].tobytes(), []).append(int(i))
    return table


def new_landmark_pairs(host: Host, o: int, sa: int, sb: int, ref_prev: orb.Frame,
                       ref_cur: orb.Frame, matcher: dict, first2=None):
    """(pairs checked, pairs that are not reference matches) over the
    landmarks keyframe ``o`` (slot sb) triangulated against keyframe o - 1
    (slot sa): those whose first two observations are at sa then sb and
    whose anchor descriptor is the one keyframe o stored for that point."""
    lms, r1, r2 = first2 if first2 is not None else _first_two_rows(host)
    sel = (host.okf[r1] == sa) & (host.okf[r2] == sb)
    if not sel.any():
        return 0, 0
    idx2 = _np(orb.match(ref_prev.descriptors, ref_prev.valid, ref_cur.descriptors,
                         ref_cur.valid, matcher["max_distance"], matcher["ratio"],
                         matcher["cross_check"]))
    where_a = _index_of(host.pts[sa], host.kp_valid[sa])
    where_b = _index_of(host.pts[sb], host.kp_valid[sb])
    checked = off = 0
    for lm, a, b in zip(lms[sel], r1[sel], r2[sel]):
        js = [j for j in where_b.get(host.ouv[b].tobytes(), ())
              if np.array_equal(host.lm_desc[lm], host.desc[sb, j])]
        if not js:
            continue            # not made at this insertion: an association
        checked += 1
        if not any(idx2[i] in js for i in where_a.get(host.ouv[a].tobytes(), ())):
            off += 1
    return checked, off


def map_checks(state, stream, cfg: dict, matcher: dict, first_frame: int, device):
    """The keyframe and landmark comparisons over the keyframes that window
    frames made. Returns ({number: value}, reference frames by ordinal)."""
    host = Host(state)
    fe = reference_frontend(cfg, device)
    refs = {}

    def ref(o):
        if o not in refs:
            slot = host.slot_of(o)
            refs[o] = fe(stream.frame(int(host.frame_id[slot])))
        return refs[o]

    window = [int(o) for o in sorted(host.ordinal[host.valid & (host.frame_id >= first_frame)])]
    rows_off = sum(frontend_rows_off(host, host.slot_of(o), ref(o)) for o in window)
    first2 = _first_two_rows(host)
    checked = off = 0
    for o in window:
        sa, sb, s0 = host.slot_of(o - 1), host.slot_of(o), host.slot_of(o - 2)
        if sa is None or s0 is None:
            continue
        c, f = new_landmark_pairs(host, o, sa, sb, ref(o - 1), ref(o), matcher, first2)
        checked += c
        off += f
    return {"keyframes_checked": len(window), "feature_rows_off": rows_off,
            "landmark_pairs_checked": checked, "landmark_pairs_off": off}, refs


def pose_checks(poses: dict, stream):
    """Position errors of every returned pose, as shares of the true
    trajectory's spread: their RMS and their largest."""
    ks = sorted(poses)
    R = np.stack([poses[k][0] for k in ks])
    t = np.stack([poses[k][1] for k in ks])
    gR, gt = stream.truth(ks)
    err = trajectory.position_errors(R, t, gR, gt)
    rot = trajectory.relative_rotation_errors(R, gR, ks)
    return {"pose_rms_share": float(np.sqrt(np.mean(err ** 2))),
            "pose_max_share": float(np.max(err)),
            "rel_rot_rms_deg": float(np.sqrt(np.mean(rot ** 2))) if len(rot) else None,
            "rel_rot_max_deg": float(np.max(rot)) if len(rot) else None}


def judge(numbers: dict, limits: dict):
    """[(name, value, [lo, hi], ok)] for every limit; a number that is
    missing or not finite fails."""
    out = []
    for name, (lo, hi) in limits.items():
        v = numbers.get(name)
        ok = v is not None and np.isfinite(v) and lo <= v <= hi
        out.append((name, v, [lo, hi], bool(ok)))
    return out


@torch.no_grad()
def describe_bounds(refs: dict, h: int, w: int):
    """Mean least time (s) of ``orb_describe`` over the reference frames."""
    vals = [roofline.describe_bound(h, w, f.codes, f.valid, f.angles, 8) for f in refs.values()]
    return float(np.mean(vals)) if vals else None
