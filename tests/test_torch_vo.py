"""The VO slice as a whole: frame -> pyramid -> extraction -> normalise_points
-> match -> RANSAC essential -> pose chaining, the port on the CPU against
``pislam_tpu.models.visual_odometry`` on the committed eval_seq frames, at
tools/eval_ate.py's config with 128 RANSAC iterations.

The two draw their RANSAC samples from different generators (``jax.random``
cannot be reproduced in torch). On these frames the refit on the winning
inlier set covers every match, so the runs agree all the same: per frame
``num_matches`` and ``accepted`` equal, ``num_inliers`` within 2 and R, t
within 1e-4 (tests/test_vo_scan.py's tolerance; measured about 3e-6 for R
and 5e-5 for t). Single steps from a JAX state (``vo_state_from_numpy``)
draw the JAX package's own samples and are held to the same tolerance.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pislam_tpu_torch as pt
from pislam_tpu import matching as jm
from pislam_tpu.models import visual_odometry as jvo
from pislam_tpu_torch.models import visual_odometry as tvo
from pislam_tpu_torch.ops.pyramid import build_pyramid
from torch_parity import (DATA, eval_config, jax_build_pyramid, jax_extract_fn, port_config, t,
                          vo_config)

torch.set_num_threads(1)

FRAMES = 10
SEED = 3


@pytest.fixture(scope="module")
def seq():
    d = np.load(DATA / "eval_seq.npz")
    return d["frames"][:FRAMES], tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy"))


def jax_features(frame):
    jcfg = eval_config()
    return jax_extract_fn(jcfg)(jax_build_pyramid(jnp.asarray(frame), jcfg.pyramid))


def jax_vo(jcfg, intr):
    """The JAX VisualOdometry, its extraction shared across configs."""
    return jvo.VisualOdometry(jcfg, *intr, features_fn=jax_features)


def numpy_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def jax_run(seq):
    frames, intr = seq
    vo = jax_vo(vo_config(), intr)
    state = vo.init(jnp.asarray(frames[0]), seed=SEED)
    infos, poses = [], []
    for f in frames[1:]:
        state, info = vo.process(state, jnp.asarray(f))
        infos.append({k: int(v) for k, v in info.items()})
        poses.append((np.asarray(state.R), np.asarray(state.t)))
    return infos, poses


def test_visual_odometry_vs_jax(seq, jax_run):
    frames, intr = seq
    vo = pt.VisualOdometry(port_config(vo_config()), *intr, device="cpu")
    state = vo.init(frames[0], seed=SEED)
    for f, want, (jR, jt) in zip(frames[1:], *jax_run):
        state, info = vo.process(state, f)
        assert int(info["num_matches"]) == want["num_matches"] > 250
        assert bool(info["accepted"]) == bool(want["accepted"])
        assert abs(int(info["num_inliers"]) - want["num_inliers"]) <= 2
        np.testing.assert_allclose(state.R.numpy(), jR, rtol=0, atol=1e-4)
        np.testing.assert_allclose(state.t.numpy(), jt, rtol=0, atol=1e-4)
    assert state.R.dtype == state.t.dtype == torch.float32
    pos = vo.camera_position(state)
    np.testing.assert_allclose(pos, -jax_run[1][-1][0].T @ jax_run[1][-1][1], atol=1e-4)


def test_make_vo_scan_equals_the_loop(seq):
    frames, intr = seq
    cfg = port_config(vo_config())
    out = pt.make_vo_scan(cfg, *intr, device="cpu")(frames[:6],
                                                    torch.Generator().manual_seed(SEED))
    vo = pt.VisualOdometry(cfg, *intr, device="cpu")
    state = vo.init(frames[0], seed=SEED)
    assert torch.equal(out["R"][0], torch.eye(3)) and not out["t"][0].any()
    for i, f in enumerate(frames[1:6]):
        state, info = vo.process(state, f)
        assert torch.equal(out["R"][i + 1], state.R) and torch.equal(out["t"][i + 1], state.t)
        for k in ("num_inliers", "accepted", "idx2", "dist"):
            assert torch.equal(out[k][i], info[k])
    assert out["R"].shape == (6, 3, 3) and out["accepted"].shape == (5,)
    assert out["idx2"].shape == out["dist"].shape == (5, 512)


@pytest.mark.parametrize("dist", [None, (-0.1, 0.01, 0.001, 0.0)])
def test_normalise_points_vs_jax(seq, dist):
    frames, intr = seq
    pc = port_config(eval_config()).pyramid
    scales = tuple(pc.base_width / w for (w, _h) in pc.level_sizes)
    feats = pt.make_extract_fn(port_config(eval_config()), device="cpu")(
        build_pyramid(t(frames[4]), pc))
    got = tvo.normalise_points(feats, *intr, pc.level_rows, scales, dist=dist)
    want = jvo.normalise_points(jax_features(frames[4]), *intr, pc.level_rows, scales,
                                dist=dist)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=0 if dist is None else 1e-7)


def _jax_match_and_draws(jcfg, state, feats, pts):
    """The match and the RANSAC samples of jax's vo_step for this step."""
    mc, vc = jcfg.matcher, jcfg.vo
    kw = dict(max_distance=mc.max_distance, ratio=mc.ratio, cross_check=mc.cross_check)
    if vc.guided_radius > 0:
        idx2, dist = jm.match_gated(state.prev.descriptors, feats.descriptors,
                                    state.prev.valid, feats.valid, state.prev_pts, pts,
                                    vc.guided_radius, **kw)
    else:
        idx2, dist = jm.match(state.prev.descriptors, feats.descriptors, state.prev.valid,
                              feats.valid, **kw)
    _, sub = jax.random.split(state.key)
    logits = jnp.where(idx2 >= 0, 0.0, -jnp.inf)
    draws = jax.random.categorical(sub, logits[None, :],
                                   shape=(vc.ransac_iters, vc.sample_size))
    return np.asarray(idx2), np.asarray(dist), np.asarray(draws)


@pytest.mark.parametrize("option", [{"guided_radius": 0.06}, {"scale_propagation": True},
                                    {"refine_two_view": True}])
def test_one_step_from_a_jax_state(seq, option, monkeypatch):
    frames, intr = seq
    jcfg = vo_config(**option)
    vo = jax_vo(jcfg, intr)
    state = vo.init(jnp.asarray(frames[0]), seed=SEED)
    for f in frames[1:3]:
        state, _ = vo.process(state, jnp.asarray(f))
    jfeats = jax_features(frames[3])
    jpts = jvo.normalise_points(jfeats, *intr, vo.level_rows, vo.level_scales)
    idx2, dist, idx = _jax_match_and_draws(jcfg, state, jfeats, jpts)
    want_state, want = vo.process(state, jnp.asarray(frames[3]))

    tcfg = port_config(jcfg)
    tstate = pt.vo_state_from_numpy(numpy_tree(state), device="cpu")
    tvo_ = pt.VisualOdometry(tcfg, *intr, device="cpu")
    feats, pts = tvo_.frontend(frames[3])
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    # the port draws JAX's samples for this step
    monkeypatch.setattr(tvo.ransac, "sample_indices", lambda *a: t(idx))
    got_state, got = tvo.vo_step(tcfg.matcher, tcfg.vo, tstate, feats, pts)
    assert int(got["num_matches"]) == int(want["num_matches"]) > 250
    assert np.array_equal(got["idx2"].numpy(), idx2)
    assert np.array_equal(got["dist"].numpy(), dist)
    assert bool(got["accepted"]) == bool(want["accepted"])
    assert abs(int(got["num_inliers"]) - int(want["num_inliers"])) <= 2
    for name in ("R", "t", "step_scale"):
        np.testing.assert_allclose(getattr(got_state, name).numpy(),
                                   np.asarray(getattr(want_state, name)), rtol=0, atol=1e-4)
    # the same features carry a depth; a triangulated depth divides by the
    # pair's parallax, so at the smallest parallaxes R, t differences of
    # ~1e-5 move it by up to ~2 % (measured 1.9 %): rtol 5e-2
    got_d, want_d = got_state.prev_depths.numpy(), np.asarray(want_state.prev_depths)
    assert np.array_equal(got_d > 0, want_d > 0)
    np.testing.assert_allclose(got_d, want_d, rtol=5e-2, atol=1e-5)
    if option.get("scale_propagation"):
        assert (got_state.prev_depths > 0).sum() > 100


def test_vo_state_from_numpy_round_trip(seq):
    frames, intr = seq
    vo = jax_vo(vo_config(), intr)
    state = numpy_tree(vo.init(jnp.asarray(frames[0]), seed=SEED))
    ts = pt.vo_state_from_numpy(state, device="cpu", seed=1)
    assert np.array_equal(ts.prev.codes.numpy(), state.prev.codes.astype(np.int64))
    assert np.array_equal(ts.prev.descriptors.numpy().view(np.uint32), state.prev.descriptors)
    assert np.array_equal(ts.prev.valid.numpy(), state.prev.valid)
    assert ts.R.dtype == ts.prev_pts.dtype == ts.step_scale.dtype == torch.float32
    assert ts.generator.initial_seed() == 1


def test_zero_match_frame_holds_the_pose(seq):
    """A blank frame has no features: no match, no raise, the pose is held."""
    frames, intr = seq
    vo = pt.VisualOdometry(port_config(vo_config()), *intr, device="cpu")
    state = vo.init(frames[0], seed=0)
    state, _ = vo.process(state, frames[1])
    held = (state.R.clone(), state.t.clone())
    state, info = vo.process(state, np.zeros_like(frames[2]))
    assert int(info["num_matches"]) == 0 and int(info["num_inliers"]) == 0
    assert not bool(info["accepted"])
    assert torch.equal(state.R, held[0]) and torch.equal(state.t, held[1])
    state, info = vo.process(state, frames[3])      # no features before: still held
    assert int(info["num_matches"]) == 0 and not bool(info["accepted"])


def test_features_fn_replaces_the_image_frontend(seq):
    frames, intr = seq
    cfg = port_config(vo_config())
    extract = pt.make_extract_fn(cfg, device="cpu")
    calls = []

    def features_fn(pyr):
        calls.append(pyr.shape)
        return extract(pyr)

    vo = pt.VisualOdometry(cfg, *intr, features_fn=features_fn, device="cpu")
    ref = pt.VisualOdometry(cfg, *intr, device="cpu")
    pyrs = [build_pyramid(t(f), cfg.pyramid) for f in frames[:2]]
    a, ia = vo.process(vo.init(pyrs[0]), pyrs[1])
    b, ib = ref.process(ref.init(frames[0]), frames[1])
    assert len(calls) == 2 and torch.equal(a.R, b.R) and torch.equal(a.t, b.t)


@pytest.mark.parametrize("entry", [pt.make_extract_fn, pt.make_vo_scan, pt.VisualOdometry])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_entry_points_without_a_card_raise(seq):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, intr = seq
    cfg = port_config(vo_config())
    # torch built without CUDA raises AssertionError, with no device RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        pt.VisualOdometry(cfg, *intr)
    with pytest.raises((RuntimeError, AssertionError)):
        pt.make_vo_scan(cfg, *intr)


def test_config_copy_matches(seq):
    """The port's VO and matcher configs are field-for-field the JAX ones."""
    cfg = port_config(vo_config(guided_radius=0.05))
    assert dataclasses.asdict(cfg.vo) == dataclasses.asdict(vo_config(guided_radius=0.05).vo)
    assert cfg.matcher.ratio == 0.85 and cfg.vo.ransac_iters == 128
