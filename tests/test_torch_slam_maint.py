"""The map's housekeeping and multi-session merging of ``KeyframeSLAM``: the
port on the CPU against ``pislam_tpu.models.slam.KeyframeSLAM`` from one
state, on the synthetic projector worlds of tests/test_models.py
(``cull_keyframes``, ``compact``, ``evict_stale_landmarks``,
``retriangulate_landmarks``, ``merge_map``).

The port adopts the JAX package's state (``slam_state_from_numpy``) and
draws the JAX package's RANSAC samples (``torch_parity.JaxDraws``), then
runs the same method. Tolerances: integer tables (validity, slots,
ordinals, counts, cursors) and culled ordinals exactly; landmark positions
within 1e-4 plus 1e-5 of their size (re-triangulated points lie up to ~50
map units out, where a float32 ulp is 4e-6 and the two packages' products
round apart by a few dozen ulps); merged keyframe positions within 1e-3
(the anchors' poses come from relocalisation: RANSAC refit SVDs and
motion-only BA in float32).
"""

import jax
import numpy as np
import pytest
import torch

import pislam_tpu_torch as pt
from pislam_tpu.evaluation import ate_rmse
from pislam_tpu.models import slam as jslam
from pislam_tpu_torch.geometry import ransac as transac
from test_models import CX, CY, FX, FY, make_trajectory, make_world, projector, tiny_cfg
from torch_parity import JaxDraws, port_config

torch.set_num_threads(1)

XYZ_TOL = 1e-4
XYZ_RTOL = 1e-5
MERGE_TOL = 1e-3


def numpy_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def port_features(jf):
    """JAX Features (numpy-able) -> the port's, on the CPU."""
    return pt.Features(
        codes=torch.from_numpy(np.asarray(jf.codes).astype(np.int64)),
        valid=torch.from_numpy(np.array(jf.valid)),
        angles=torch.from_numpy(np.array(jf.angles)),
        descriptors=torch.from_numpy(np.asarray(jf.descriptors).view(np.int32).copy()))


def port_slam(cfg, features_fn, **kw):
    return pt.KeyframeSLAM(port_config(cfg), FX, FY, CX, CY,
                           features_fn=lambda i: port_features(features_fn(i)),
                           device="cpu", **kw)


def adopt(slam, jstate, monkeypatch):
    """The port takes over a JAX state and draws the JAX package's samples."""
    slam.set_state(pt.slam_state_from_numpy(jstate, device="cpu"))
    monkeypatch.setattr(transac, "sample_indices", JaxDraws(jstate.key))
    return slam


def assert_tables_equal(st, ref):
    """Every integer table and cursor of a port state equals the JAX one's;
    landmark positions within XYZ_TOL + XYZ_RTOL of their size."""
    for name in ("valid", "ordinal", "frame_id", "kp_valid"):
        assert np.array_equal(getattr(st.store, name).numpy(), getattr(ref.store, name)), name
    for name in ("valid", "obs_count"):
        assert np.array_equal(getattr(st.lmap, name).numpy(), getattr(ref.lmap, name)), name
    assert np.array_equal(st.lmap.descriptors.numpy().view(np.uint32), ref.lmap.descriptors)
    for name in ("kf", "lm", "valid"):
        assert np.array_equal(getattr(st.obs, name).numpy(), getattr(ref.obs, name)), name
    assert np.array_equal(st.counters.numpy(), ref.counters)
    np.testing.assert_allclose(st.lmap.xyz.numpy(), ref.lmap.xyz, rtol=XYZ_RTOL, atol=XYZ_TOL)


@pytest.fixture(scope="module")
def culling_world():
    """tests/test_models.py's culling world: 24 frames, a keyframe every
    second frame; the JAX package's state after them, and after each
    housekeeping step."""
    xyz, desc = make_world(seed=3)
    Rs, ts = make_trajectory(24)
    proj = projector(xyz, desc, Rs, ts)
    slam = jslam.KeyframeSLAM(tiny_cfg(), FX, FY, CX, CY, features_fn=proj,
                              keyframe_min_inliers=220, keyframe_max_gap=2)
    for i in range(24):
        slam.process(i)
    out = {"proj": proj, "before": numpy_tree(slam.state)}
    out["culled"] = slam.cull_keyframes(max_cull=3, protect_recent=2, min_other_obs=2,
                                        redundant_fraction=0.5)
    out["after_cull"] = numpy_tree(slam.state)
    out["compact"] = slam.compact()
    out["after_compact"] = numpy_tree(slam.state)
    live = int(np.asarray(slam.state.lmap.valid).sum())
    out["min_free"] = slam.state.lmap.capacity - live + 40
    out["evicted"] = slam.evict_stale_landmarks(min_free=out["min_free"])
    out["after_evict"] = numpy_tree(slam.state)
    out["lm_hi"] = slam.num_landmarks
    out["moved"] = slam.retriangulate_landmarks(0, out["lm_hi"])
    out["after_retri"] = numpy_tree(slam.state)
    out["track"] = slam.process(23)
    return out


def _port_at(world, name, monkeypatch):
    return adopt(port_slam(tiny_cfg(), world["proj"], keyframe_min_inliers=220,
                           keyframe_max_gap=2), world[name], monkeypatch)


def test_cull_keyframes_vs_jax(culling_world, monkeypatch):
    slam = _port_at(culling_world, "before", monkeypatch)
    n_before = slam.num_keyframes
    culled = slam.cull_keyframes(max_cull=3, protect_recent=2, min_other_obs=2,
                                 redundant_fraction=0.5)
    assert culled == culling_world["culled"] and culled
    assert slam.num_keyframes == n_before - len(culled) == len(slam.keyframes)
    assert not set(culled) & {v.index for v in slam.keyframes}
    assert_tables_equal(slam.state, culling_world["after_cull"])
    # the culling bookkeeping survives a state round trip
    slam2 = port_slam(tiny_cfg(), culling_world["proj"])
    slam2.set_state(slam.state)
    assert slam2.num_keyframes == slam.num_keyframes


def test_compact_vs_jax(culling_world, monkeypatch):
    slam = _port_at(culling_world, "after_cull", monkeypatch)
    assert slam.compact() == culling_world["compact"]
    st = slam.state
    assert culling_world["compact"] == (int(st.lmap.valid.sum()), int(st.obs.valid.sum()))
    assert_tables_equal(st, culling_world["after_compact"])


def test_evict_stale_landmarks_vs_jax(culling_world, monkeypatch):
    slam = _port_at(culling_world, "after_compact", monkeypatch)
    n = slam.evict_stale_landmarks(min_free=culling_world["min_free"])
    assert n == culling_world["evicted"] == 40
    assert_tables_equal(slam.state, culling_world["after_evict"])
    # nothing to do when enough slots are free
    assert slam.evict_stale_landmarks(min_free=1) == 0


def test_retriangulate_landmarks_vs_jax(culling_world, monkeypatch):
    slam = _port_at(culling_world, "after_evict", monkeypatch)
    moved = slam.retriangulate_landmarks(0, culling_world["lm_hi"])
    assert moved == culling_world["moved"] > 0
    assert_tables_equal(slam.state, culling_world["after_retri"])
    assert slam.retriangulate_landmarks(5, 5) == 0


def test_tracking_after_housekeeping_vs_jax(culling_world, monkeypatch):
    """The next frame after cull, compact, evict and re-triangulation: not
    lost, the JAX package's decision and map inliers."""
    slam = _port_at(culling_world, "after_retri", monkeypatch)
    got, want = slam.process(23), culling_world["track"]
    assert not got["lost"] and not want["lost"]
    for k in ("keyframe", "num_inliers", "map_inliers"):
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# merge_map: tests/test_models.py's multi-session world
# ---------------------------------------------------------------------------

def _sessions(proj, session):
    """Session A over world frames 0-7 and B over 6-15 with its own origin
    (its frame 0 is world frame 6), seed 99 (tests/test_models.py)."""
    a = session(proj, keyframe_min_inliers=220, keyframe_max_gap=2)
    for i in range(8):
        a.process(i)
    b = session(lambda i: proj(int(i) + 6), keyframe_min_inliers=220, keyframe_max_gap=2,
                seed=99)
    for i in range(10):
        b.process(i)
    return a, b


def _anchors(slam_cls, log):
    """Wrap ``_relocalise_feats`` to log which keyframes relocalise."""
    orig = slam_cls._relocalise_feats

    def logging(self, feats, pts, min_matches=30):
        rec = orig(self, feats, pts, min_matches=min_matches)
        log.append(None if rec is None else int(rec[2]))
        return rec

    return orig, logging


def _merged_ate(slam, na, Rs, ts):
    gt = [-Rs[v.frame if v.index < na else v.frame + 6].T @ ts[v.frame if v.index < na
                                                               else v.frame + 6]
          for v in slam.keyframes]
    return ate_rmse(slam.keyframe_positions(), np.stack(gt), with_scale=True)


@pytest.fixture(scope="module")
def merge_world():
    xyz, desc = make_world(seed=71)
    Rs, ts = make_trajectory(16)
    proj = projector(xyz, desc, Rs, ts)

    def session(fn, **kw):
        return jslam.KeyframeSLAM(tiny_cfg(), FX, FY, CX, CY, features_fn=fn, **kw)

    a, b = _sessions(proj, session)
    out = {"proj": proj, "Rs": Rs, "ts": ts, "a": numpy_tree(a.state),
           "b": numpy_tree(b.state), "na": a.num_keyframes, "nb": b.num_keyframes,
           "la": a.num_landmarks, "anchors": []}
    orig, logging = _anchors(jslam.KeyframeSLAM, out["anchors"])
    jslam.KeyframeSLAM._relocalise_feats = logging
    try:
        out["merged"] = a.merge_map(b.state)
    finally:
        jslam.KeyframeSLAM._relocalise_feats = orig
    out["after"] = numpy_tree(a.state)
    out["positions"] = a.keyframe_positions()
    return out


def test_merge_map_vs_jax(merge_world, monkeypatch):
    """From the JAX package's session A and B states: the same anchors,
    merged count and tables, keyframe positions within 1e-3."""
    w = merge_world
    slam = adopt(port_slam(tiny_cfg(), w["proj"], keyframe_min_inliers=220, keyframe_max_gap=2),
                 w["a"], monkeypatch)
    log = []
    orig, logging = _anchors(pt.KeyframeSLAM, log)
    monkeypatch.setattr(pt.KeyframeSLAM, "_relocalise_feats", logging)
    merged = slam.merge_map(pt.slam_state_from_numpy(w["b"], device="cpu"))
    monkeypatch.setattr(pt.KeyframeSLAM, "_relocalise_feats", orig)
    assert log == w["anchors"] and sum(x is not None for x in log) >= 3
    assert merged == w["merged"] == w["nb"]
    st, ref = slam.state, w["after"]
    for name in ("valid", "ordinal", "frame_id", "kp_valid"):
        assert np.array_equal(getattr(st.store, name).numpy(), getattr(ref.store, name)), name
    for name in ("valid", "obs_count"):
        assert np.array_equal(getattr(st.lmap, name).numpy(), getattr(ref.lmap, name)), name
    for name in ("kf", "lm", "valid"):
        assert np.array_equal(getattr(st.obs, name).numpy(), getattr(ref.obs, name)), name
    assert np.array_equal(st.counters.numpy(), ref.counters)
    np.testing.assert_allclose(slam.keyframe_positions(), w["positions"], rtol=0,
                               atol=MERGE_TOL)
    assert _merged_ate(slam, w["na"], w["Rs"], w["ts"]) < 0.2


def test_merge_map_port_sessions(merge_world):
    """tests/test_models.py's merge run by the port alone, with its own
    draws: B merges whole, the fused trajectory matches ground truth up to
    scale, the fused map relocalises a view only B mapped, tracking goes on,
    and an empty state is refused."""
    w = merge_world
    proj, Rs, ts = w["proj"], w["Rs"], w["ts"]

    def session(fn, **kw):
        return port_slam(tiny_cfg(), fn, **kw)

    a, b = _sessions(proj, session)
    na, nb, la = a.num_keyframes, b.num_keyframes, a.num_landmarks
    assert na >= 4 and nb >= 5
    assert a.merge_map(b.state) == nb
    assert a.num_keyframes == na + nb and a.num_landmarks > la
    assert _merged_ate(a, na, Rs, ts) < 0.2
    pose = a.relocalise(15, min_matches=30)
    assert pose is not None and np.linalg.norm(np.asarray(pose[0]) - Rs[15]) < 0.12
    assert not a.process(15)["lost"]
    empty = pt.models.slam.init_state(port_config(tiny_cfg()), device="cpu")
    assert a.merge_map(empty) == -1


def test_housekeeping_on_a_port_session():
    """tests/test_models.py's culling and compaction test, the port alone:
    a dense keyframe run has redundant keyframes, compaction pulls the
    cursors to the live rows, tracking survives, and an eviction frees the
    requested slots."""
    xyz, desc = make_world(seed=3)
    Rs, ts = make_trajectory(24)
    slam = port_slam(tiny_cfg(), projector(xyz, desc, Rs, ts), keyframe_min_inliers=220,
                     keyframe_max_gap=2)
    for i in range(24):
        slam.process(i)
    n_before = slam.num_keyframes
    culled = slam.cull_keyframes(max_cull=3, protect_recent=2, min_other_obs=2,
                                 redundant_fraction=0.5)
    assert culled and slam.num_keyframes == n_before - len(culled)
    live = (int(slam.state.lmap.valid.sum()), int(slam.state.obs.valid.sum()))
    assert slam.compact() == live
    assert not slam.process(23)["lost"]
    cap, live_lm = slam.state.lmap.capacity, int(slam.state.lmap.valid.sum())
    assert slam.evict_stale_landmarks(min_free=cap - live_lm + 25) == 25
    assert slam.num_landmarks == int(slam.state.lmap.valid.sum()) == live_lm - 25
    assert not slam.process(22)["lost"]
