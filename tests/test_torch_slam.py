"""The SLAM slice as a whole: ``KeyframeSLAM.process`` over the first 16
frames of eval_seq, then ``close_loop``, the port on the CPU against
``pislam_tpu.models.slam.KeyframeSLAM``, at tools/eval_ate.py's
``slam_config`` with the keyframe ring cut to 16 slots.

The port draws its RANSAC samples from a ``torch.Generator``; here it draws
the JAX package's instead: ``geometry/ransac.sample_indices`` is replaced by
the next ``jax.random.split`` of the JAX state's key and
``jax.random.categorical`` over the same valid mask
(pislam_tpu/geometry/ransac.py:31, models/slam.py:382).

Step by step: for each frame the port starts from the JAX package's state
before it (``slam_state_from_numpy``) with the JAX draws, and its keyframe
decision, map counters, observation table and match counts are identical;
poses agree within 1e-3 (measured <= 4e-4: the two LAPACKs' SVDs differ by
~5e-7 and BA sums in another order), landmarks within 1e-3 of their
reprojection into the new keyframe. The one exception is frame 3, the first
BA window: its two cameras are both pinned, the points are solved alone,
and those seen with little parallax are nearly free in depth, so the 5e-7
pose difference moves their start by up to 0.03 and flips LM's first
accept/reject (the JAX package rejects three steps where the port accepts
one). Its landmark positions are not compared; tests/test_torch_backend.py
holds BA itself to the JAX package on fixed problems.

Run free, the same flip makes the two runs take different keyframes from
frame 4 on (the JAX package's map-inlier count lands at 20, the port's at
27, against the threshold of 25): a free run is held to the same number of
keyframes, the same loop target and branch, no lost frame and a map of the
same size, not to the JAX package's ATE.
``close_loop`` from the JAX state after frame 16 gives the same loop,
branch and keyframe positions within 1e-3.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pislam_tpu_torch as pt
from pislam_tpu.config import (BAConfig, FrontendConfig, MapConfig, MatcherConfig,
                               PislamConfig, PyramidConfig, VOConfig)
from pislam_tpu.models import slam as jslam
from pislam_tpu_torch.geometry import ransac as transac
from torch_parity import DATA, JaxDraws, port_config

torch.set_num_threads(1)

FRAMES = 16
CAPACITY = 16
SEED = 7
BOOTSTRAP_WINDOW = 3   # the frame whose BA holds only the two pinned cameras
POSE_TOL = 1e-3
INLIER_TOL = 2


def slam_config():
    """tools/eval_ate.py's slam_config, keyframe ring cut to 16 slots."""
    return PislamConfig(
        pyramid=PyramidConfig(base_width=384, base_height=256, num_levels=4),
        frontend=FrontendConfig(fast_threshold=14, harris_threshold=1 << 9, border=16,
                                max_keypoints=512),
        matcher=MatcherConfig(max_distance=64, ratio=0.85),
        vo=VOConfig(ransac_iters=256, inlier_threshold=2e-3, min_inliers=20),
        ba=BAConfig(window=6, max_points=1024, max_obs=4096, gn_iters=4),
        map=MapConfig(gate_radius=0.06, keyframe_capacity=CAPACITY))


def numpy_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def seq():
    d = np.load(DATA / "eval_seq.npz")
    return d["frames"][:FRAMES], tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy"))


def _record(slam, out):
    return {"keyframe": bool(out["keyframe"]), "num_inliers": int(out["num_inliers"]),
            "map_inliers": int(out["map_inliers"]), "lost": bool(out["lost"]),
            "counters": np.asarray(slam.state.counters).tolist(),
            "R": np.asarray(out["pose_R"], np.float32),
            "t": np.asarray(out["pose_t"], np.float32)}


def _closure(slam):
    pre = slam.keyframe_positions()
    closure = slam.close_loop(min_matches=40, exclude_recent=3)
    return {"kf_frames": slam.keyframe_frames, "pre": pre, "closure": closure,
            "post": slam.keyframe_positions()}


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX package's run: each frame's outputs, and its state (key
    included) before each frame and after the last."""
    frames, intr = seq
    slam = jslam.KeyframeSLAM(slam_config(), *intr, keyframe_min_inliers=60,
                              keyframe_max_gap=3, seed=SEED)
    per_frame, states = [], []
    for f in frames:
        states.append(numpy_tree(slam.state))
        per_frame.append(_record(slam, slam.process(jnp.asarray(f))))
    states.append(numpy_tree(slam.state))
    return {"per_frame": per_frame, "states": states, **_closure(slam)}


def port_slam(intr):
    return pt.KeyframeSLAM(port_config(slam_config()), *intr, keyframe_min_inliers=60,
                           keyframe_max_gap=3, seed=SEED, device="cpu")


def port_from(intr, jstate, monkeypatch):
    """The port adopting a JAX state, drawing the JAX package's samples."""
    slam = port_slam(intr)
    slam.set_state(pt.slam_state_from_numpy(jstate, device="cpu", seed=SEED))
    monkeypatch.setattr(transac, "sample_indices", JaxDraws(jstate.key))
    return slam


@pytest.mark.parametrize("frame", range(1, FRAMES))
def test_step_vs_jax(seq, jax_run, frame, monkeypatch):
    """One frame from the JAX package's state before it: the same decision,
    counters and tables, poses and the map's geometry within tolerance."""
    frames, intr = seq
    slam = port_from(intr, jax_run["states"][frame], monkeypatch)
    got = _record(slam, slam.process(frames[frame]))
    want = jax_run["per_frame"][frame]
    for k in ("keyframe", "map_inliers", "lost", "counters"):
        assert got[k] == want[k], k
    assert abs(got["num_inliers"] - want["num_inliers"]) <= INLIER_TOL
    np.testing.assert_allclose(got["R"], want["R"], rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(got["t"], want["t"], rtol=0, atol=POSE_TOL)

    st, ref = slam.state, jax_run["states"][frame + 1]
    for name in ("valid", "ordinal", "frame_id", "kp_valid"):
        assert np.array_equal(getattr(st.store, name).numpy(), getattr(ref.store, name))
    assert np.array_equal(st.store.codes.numpy(), ref.store.codes.astype(np.int64))
    assert np.array_equal(st.store.descriptors.numpy().view(np.uint32), ref.store.descriptors)
    for name in ("valid", "obs_count"):
        assert np.array_equal(getattr(st.lmap, name).numpy(), getattr(ref.lmap, name))
    assert np.array_equal(st.lmap.descriptors.numpy().view(np.uint32), ref.lmap.descriptors)
    for name in ("kf", "lm", "valid"):
        assert np.array_equal(getattr(st.obs, name).numpy(), getattr(ref.obs, name))
    np.testing.assert_allclose(st.obs.uv.numpy(), ref.obs.uv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.store.R.numpy(), ref.store.R, rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(st.store.t.numpy(), ref.store.t, rtol=0, atol=POSE_TOL)
    if frame != BOOTSTRAP_WINDOW and ref.lmap.valid.any():
        slot = (int(ref.counters[0]) - 1) % CAPACITY
        R, t = ref.store.R[slot], ref.store.t[slot]

        def uv(X):
            xc = X[ref.lmap.valid] @ R.T + t
            return xc[:, :2] / xc[:, 2:]

        np.testing.assert_allclose(uv(st.lmap.xyz.numpy()), uv(ref.lmap.xyz), rtol=0,
                                   atol=POSE_TOL)


def test_close_loop_from_a_jax_state(seq, jax_run, monkeypatch):
    _, intr = seq
    slam = port_from(intr, jax_run["states"][-1], monkeypatch)
    got = _closure(slam)
    assert got["kf_frames"] == jax_run["kf_frames"]
    np.testing.assert_array_equal(got["pre"], jax_run["pre"])
    want = jax_run["closure"]
    assert got["closure"]["loop"] == want["loop"] >= 0
    assert got["closure"]["used_graph"] == want["used_graph"]
    np.testing.assert_allclose(got["closure"]["cost_ba"], want["cost_ba"], rtol=1e-2)
    np.testing.assert_allclose(got["closure"]["cost_graph"], want["cost_graph"], rtol=1e-2)
    np.testing.assert_allclose(got["post"], jax_run["post"], rtol=0, atol=POSE_TOL)


@pytest.fixture(scope="module")
def port_run(seq):
    """The port run free over the 16 frames, with the JAX package's draws."""
    frames, intr = seq
    slam = port_slam(intr)
    draws = JaxDraws(jax.random.PRNGKey(SEED))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transac, "sample_indices", draws)
        per_frame = [_record(slam, slam.process(f)) for f in frames]
        out = _closure(slam)
    return {"per_frame": per_frame, "slam": slam, "draws": draws.calls, **out}


def test_free_run_vs_jax(seq, jax_run, port_run):
    """Run free, frame 3's flip moves the keyframes from frame 4 on; the
    run keeps the JAX package's keyframe count, loop and branch."""
    assert port_run["draws"] >= FRAMES
    assert port_run["kf_frames"][:2] == jax_run["kf_frames"][:2]
    assert len(port_run["kf_frames"]) == len(jax_run["kf_frames"]) >= 5
    assert not any(r["lost"] for r in port_run["per_frame"])
    assert port_run["per_frame"][-1]["counters"][1] > 500      # landmarks
    got, want = port_run["closure"], jax_run["closure"]
    assert got["loop"] == want["loop"] >= 0 and got["used_graph"] == want["used_graph"]


def test_slam_state_from_numpy_round_trip(jax_run):
    jstate = jax_run["states"][8]
    st = pt.slam_state_from_numpy(jstate, device="cpu", seed=3)
    assert isinstance(st, pt.SlamState)
    assert st.store.codes.dtype == torch.int64 and st.store.descriptors.dtype == torch.int32
    assert np.array_equal(st.store.descriptors.numpy().view(np.uint32), jstate.store.descriptors)
    assert np.array_equal(st.lmap.xyz.numpy(), jstate.lmap.xyz)
    assert st.counters.dtype == torch.int32 and st.generator.initial_seed() == 3
    assert set(st._fields) == set(jstate._fields) - {"key"} | {"generator"}


def test_unported_options_raise(seq, tmp_path):
    """Every part of KeyframeSLAM is ported: checkpoints (held in
    tests/test_torch_checkpoint.py), the E/H bootstrap and the chunk path,
    which refuses what the JAX package refuses (tests/test_torch_slam_scan.py
    holds both), and ``mesh`` (tests/test_torch_parallel.py)."""
    _, intr = seq
    cfg = port_config(slam_config())
    slam = pt.KeyframeSLAM(dataclasses.replace(cfg, vo=dataclasses.replace(
        cfg.vo, bootstrap_model_select=True)), *intr, device="cpu")
    assert inspect.signature(pt.KeyframeSLAM).parameters["mesh"].default is None
    slam.save_checkpoint(str(tmp_path / "map.pt"))
    slam.restore_checkpoint(str(tmp_path / "map.pt"))
    assert slam.num_keyframes == 0 and slam.keyframes_inserted == 0
    with pytest.raises(ValueError, match="image frontend"):
        pt.KeyframeSLAM(cfg, *intr, features_fn=lambda f: None,
                        device="cpu").process_chunk(np.zeros((2, 256, 384), np.uint8))


def test_keyframe_slam_defaults_to_the_card(seq):
    assert inspect.signature(pt.KeyframeSLAM).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, intr = seq
    # torch built without CUDA raises AssertionError, with no device RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        pt.KeyframeSLAM(port_config(slam_config()), *intr)


def test_host_api(port_run):
    slam = port_run["slam"]
    views = slam.keyframes
    assert [v.index for v in views] == sorted(v.index for v in views)
    assert slam.num_keyframes == len(views) == len(slam.keyframe_frames)
    assert slam.keyframes_inserted >= slam.num_keyframes
    assert slam.landmark_positions().shape == (int(slam.state.lmap.valid.sum()), 3)
    w = slam.covisibility()
    assert w.shape == (CAPACITY, CAPACITY) and (w == w.T).all() and (np.diag(w) == 0).all()
    cost, n = slam.map_consistency()
    assert n > 0 and np.isfinite(cost)
    assert slam.frames_lost == 0 and slam.relocalisations == 0
