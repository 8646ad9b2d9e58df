"""``KeyframeSLAM.process_chunk`` (models/slam_scan.py), the port on the CPU.

Against the JAX package: ``process_chunk`` at chunk 1 and chunk 4 over the
first 12 eval_seq frames, the port drawing the JAX package's RANSAC samples
(``torch_parity.JaxDraws``), at tools/eval_ate.py's ``slam_config`` with a
16-slot ring and Huber BA off (ROADMAP R3: Huber LM's accept/reject turns
float noise into different maps). Every keyframe decision, inlier count,
keyframe frame and the map's size are equal; map inliers within 2 and the
trajectory within 5e-2, tests/test_slam_scan.py's own tolerances.

Against the port's own ``process``: chunk 1 makes its decisions with the
step-magnitude prior on and with the E/H bootstrap on; chunks of 8 keep the
trajectory in family; a chunk that ends lost relocalises at the boundary;
the scan's frame loop reads nothing back to the host.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pislam_tpu_torch as pt
from pislam_tpu.models import slam as jslam
from pislam_tpu_torch.evaluation import ate_rmse
from pislam_tpu_torch.geometry import ransac as transac
from pislam_tpu_torch.utils.metrics import Metrics
from test_torch_slam import slam_config
from torch_parity import DATA, JaxDraws, port_config

torch.set_num_threads(1)

FRAMES = 12
SEED = 7
INLIER_TOL = 2
TRAJ_TOL = 5e-2


def _config(huber=None, **vo):
    cfg = slam_config()
    if huber is not None:
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba, huber=huber))
    if vo:
        cfg = dataclasses.replace(cfg, vo=dataclasses.replace(cfg.vo, **vo))
    return cfg


@pytest.fixture(scope="module")
def seq():
    d = np.load(DATA / "eval_seq.npz")
    gt = np.stack([-R.T @ t for R, t in zip(d["Rs"], d["ts"])])
    return d["frames"], tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy")), gt


def port_slam(cfg, intr, **kw):
    return pt.KeyframeSLAM(port_config(cfg), *intr, keyframe_min_inliers=60,
                           keyframe_max_gap=3, seed=SEED, device="cpu", **kw)


def run_chunks(slam, frames, chunk, to_frames=lambda f: f):
    outs = [slam.process_chunk(to_frames(frames[i: i + chunk]))
            for i in range(0, len(frames), chunk)]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunks_vs_jax(seq, chunk, monkeypatch):
    frames, intr, _ = seq
    frames = frames[:FRAMES]
    cfg = _config(huber=0.0)
    jax_slam = jslam.KeyframeSLAM(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                                  seed=SEED)
    want = run_chunks(jax_slam, frames, chunk, jnp.asarray)

    draws = JaxDraws(jax.random.PRNGKey(SEED))
    monkeypatch.setattr(transac, "sample_indices", draws)
    slam = port_slam(cfg, intr)
    got = run_chunks(slam, frames, chunk)

    assert draws.calls == FRAMES - 1
    for k in ("keyframe", "num_inliers"):
        assert np.array_equal(got[k], want[k]), k
    assert np.abs(got["map_inliers"] - want["map_inliers"]).max() <= INLIER_TOL
    assert slam.keyframe_frames == jax_slam.keyframe_frames
    assert slam.num_keyframes == jax_slam.num_keyframes >= 4
    assert slam.num_landmarks == jax_slam.num_landmarks > 0
    np.testing.assert_allclose(np.stack(slam.trajectory), np.stack(jax_slam.trajectory),
                               rtol=0, atol=TRAJ_TOL)


@pytest.mark.parametrize("case", ["step_prior", "model_select"])
def test_chunk1_matches_process(seq, case):
    """Chunk 1 makes process's decisions from the same generator seed: with
    the step-magnitude prior's fallback firing (tests/test_slam_scan.py's
    config; maturity gate 2 so it fires within 12 frames), and with the
    E/H bootstrap, whose homography samples both draw on every tracked
    frame."""
    frames, intr, _ = seq
    frames = frames[:FRAMES]
    if case == "step_prior":
        cfg = _config(huber=0.0, step_magnitude_prior=True, step_prior_min_kf=2)
        tol = 0.2     # tests/test_slam_scan.py: the fallback's normalised step
    else:
        cfg = _config(huber=0.0, bootstrap_model_select=True)
        tol = TRAJ_TOL
    metrics = Metrics(sink=lambda line: None)
    loop = port_slam(cfg, intr, metrics=metrics)
    infos = [loop.process(f) for f in frames]
    if case == "step_prior":
        assert metrics.snapshot().get("count.step_prior_fallbacks", 0) > 0
    scan = port_slam(cfg, intr)
    got = run_chunks(scan, frames, 1)
    for k in ("keyframe", "num_inliers", "map_inliers"):
        assert got[k].tolist() == [info[k] for info in infos], k
    assert scan.keyframe_frames == loop.keyframe_frames
    assert scan.num_landmarks == loop.num_landmarks
    assert np.array_equal(scan.state.counters.numpy(), loop.state.counters.numpy())
    np.testing.assert_allclose(np.stack(scan.trajectory), np.stack(loop.trajectory),
                               rtol=0, atol=tol)


def test_bootstrap_selection_in_the_scan(seq, monkeypatch):
    """With the E/H bootstrap on, a chunk that starts with no keyframe runs
    the selection on every tracked frame and takes it while one keyframe
    exists (process's poses up to the second keyframe); a chunk that starts
    with two keyframes runs none. Every tracked frame draws E's samples,
    then H's."""
    frames, intr, _ = seq
    cfg = _config(bootstrap_model_select=True)
    loop = port_slam(cfg, intr)
    infos = [loop.process(f) for f in frames[:6]]

    sizes, chosen = [], []
    draw, choose = transac.sample_indices, pt.homography.choose_model

    def logging(valid, iters, sample_size, generator=None):
        sizes.append(sample_size)
        return draw(valid, iters, sample_size, generator)

    def log_choice(*a):
        chosen.append(choose(*a))
        return chosen[-1]

    monkeypatch.setattr(transac, "sample_indices", logging)
    monkeypatch.setattr(pt.homography, "choose_model", log_choice)
    slam = port_slam(cfg, intr)
    got = slam.process_chunk(frames[:6])
    assert sizes == [8, 4] * 5 and len(chosen) == 5
    second = [i["keyframe"] for i in infos].index(True, 1)
    assert got["keyframe"].tolist()[: second + 1] == [i["keyframe"] for i in infos[: second + 1]]
    for i in range(1, second + 1):
        assert got["num_inliers"][i] == infos[i]["num_inliers"]
        np.testing.assert_allclose(got["pose_R"][i], infos[i]["pose_R"], rtol=0, atol=TRAJ_TOL)
        np.testing.assert_allclose(got["pose_t"][i], infos[i]["pose_t"], rtol=0, atol=TRAJ_TOL)
    assert slam.num_keyframes >= 2
    slam.process_chunk(frames[6:9])
    assert sizes == [8, 4] * 8 and len(chosen) == 5


def test_chunked_tracking_accuracy(seq):
    """Chunks of 8 (BA at chunk boundaries): ATE stays in family with the
    per-frame loop (tests/test_slam_scan.py's bound), and the chunk emits
    the JAX package's metric names."""
    frames, intr, gt = seq
    frames, gt = frames[:24], gt[:24]
    cfg = _config()
    loop = port_slam(cfg, intr)
    for f in frames:
        loop.process(f)
    ate_loop = ate_rmse(np.stack(loop.trajectory), gt)
    metrics = Metrics(sink=lambda line: None)
    scan = port_slam(cfg, intr, metrics=metrics)
    for i in range(0, len(frames), 8):
        out = scan.process_chunk(frames[i: i + 8])
        assert out["pose_R"].shape == (8, 3, 3) and out["keyframe"].dtype == bool
    assert len(scan.trajectory) == len(frames)
    ate_scan = ate_rmse(np.stack(scan.trajectory), gt)
    assert ate_scan < max(2.5 * ate_loop, 0.15), (ate_loop, ate_scan)
    snap = metrics.snapshot()
    assert snap["calls.scan_chunk"] == 3 and snap["calls.insert_ba"] >= 1
    assert snap["count.frames"] == 24
    assert snap["count.keyframes_inserted"] == scan.keyframes_inserted


def test_chunk_boundary_lost_recovery(seq):
    """tests/test_slam_scan.py's kidnap: a camera pans across a wide
    texture with a keyframe every frame; a jump back to the start of the
    pan is lost in the scan and relocalised at the chunk's end against
    keyframe 0 as a recovery keyframe; the next chunk tracks against it; a
    noise frame stays lost without inserting."""
    _, intr, _ = seq
    rng = np.random.default_rng(3)
    h, w, step = 256, 384, 64
    pan = rng.integers(0, 256, (h, w + 10 * step), np.uint8)

    def window(off):
        return np.ascontiguousarray(pan[:, off: off + w])

    cfg = _config()
    slam = pt.KeyframeSLAM(port_config(cfg), *intr, keyframe_min_inliers=10 ** 6,
                           keyframe_max_gap=1, seed=SEED, device="cpu")
    for i in range(11):
        assert bool(slam.process_chunk(window(i * step)[None])["keyframe"][0]), i
    assert slam.num_keyframes == 11

    out = slam.process_chunk(window(2)[None])
    assert slam.frames_lost >= 1 and slam.relocalisations == 1
    assert slam.num_keyframes == 12 and bool(out["keyframe"][0])
    assert np.allclose(slam.trajectory[-1], -out["pose_R"][0].T @ out["pose_t"][0])

    out = slam.process_chunk(window(6)[None])
    assert int(out["num_inliers"][0]) >= cfg.vo.min_inliers

    kf_now = slam.num_keyframes
    out = slam.process_chunk(rng.integers(0, 256, (h, w), np.uint8)[None])
    assert not bool(out["keyframe"][0])
    assert slam.num_keyframes == kf_now


@pytest.mark.parametrize("mode", ["features_fn", "localization"])
def test_process_chunk_refuses(seq, mode):
    _, intr, _ = seq
    kw = {"features_fn": lambda f: None} if mode == "features_fn" else {"mapping": False}
    slam = port_slam(_config(), intr, **kw)
    with pytest.raises(ValueError, match="image frontend" if mode == "features_fn"
                       else "localization"):
        slam.process_chunk(np.zeros((1, 256, 384), np.uint8))


def test_scan_reads_nothing_back(seq, monkeypatch):
    """The chunk loop takes no host decision: every way a tensor becomes a
    Python value raises while the scan runs (bootstrap, tracking, map
    tracking and inserts over 6 frames)."""
    frames, intr, _ = seq
    cfg = port_config(_config(bootstrap_model_select=True))
    run = pt.make_slam_track_scan(cfg, *intr, keyframe_min_inliers=60, keyframe_max_gap=3,
                                  device="cpu")
    st = pt.models.slam.init_state(cfg, SEED, device="cpu")
    on_device = torch.from_numpy(frames[:6].copy())

    def refuse(*a, **k):
        raise AssertionError("the scan read a tensor back")

    with monkeypatch.context() as mp:
        for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
                     "numpy", "nonzero"):
            mp.setattr(torch.Tensor, name, refuse)
        st, outs = run(st, on_device, 0)
    assert outs["keyframe"].tolist()[0] and outs["keyframe"].sum() >= 2
    assert st.counters.tolist()[3] == 6
