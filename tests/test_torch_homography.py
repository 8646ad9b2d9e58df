"""geometry/homography.py: the port on the CPU against
``pislam_tpu.geometry.homography`` on the same inputs, the planar and
general scenes of tests/test_homography.py, with the JAX package's sample
indices passed as ``idx`` (``jax.random.categorical`` from the same keys).

Tolerances: H is compared up to sign (LAPACK builds choose singular-vector
signs freely) within 1e-5, float32 rounding through two different SVD
codes; the 4-point hypotheses, from the same Householder QR, within 1e-4
(tests/test_torch_geometry.py's tolerance for the essential ones); R, t, n
within 1e-4;
inlier masks, counts, ``used_homography`` and ``ambiguous`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pislam_tpu.geometry import homography as jh
from pislam_tpu.geometry import se3
from pislam_tpu_torch.geometry import homography as th
from test_homography import planar_scene
from torch_parity import t

torch.set_num_threads(1)

H_TOL = 1e-5
POSE_TOL = 1e-4


def jax_idx(key, valid, iters, sample_size):
    """The JAX package's RANSAC sample rows for ``key``."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    idx = jax.random.categorical(key, logits[None, :], shape=(iters, sample_size))
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


def up_to_sign(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    s = 1.0 if np.sum(a * b) >= 0 else -1.0
    np.testing.assert_allclose(s * a, b, rtol=0, atol=tol)


def outlier_scene(seed=2, noise=2e-4):
    p1, p2, R, tr, _ = planar_scene(seed=seed, noise=noise)
    n = len(p1)
    rng = np.random.default_rng(5)
    bad = rng.permutation(n)[: n // 4]
    p2 = p2.copy()
    p2[bad] += rng.uniform(0.03, 0.2, (len(bad), 2)).astype(np.float32) * \
        rng.choice([-1, 1], (len(bad), 2))
    return p1, p2, R, tr, bad


def general_scene(seed=13):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 3], [3, 2, 12], (160, 3)).astype(np.float32)
    R = np.asarray(se3.so3_exp(jnp.asarray(np.float32([0.05, -0.08, 0.03])))).astype(np.float32)
    tr = np.float32([0.3, -0.1, 0.15])
    X2 = X @ R.T + tr
    return ((X[:, :2] / X[:, 2:]).astype(np.float32), (X2[:, :2] / X2[:, 2:]).astype(np.float32),
            R, tr)


def rotation_scene():
    rng = np.random.default_rng(7)
    X = rng.uniform([-3, -2, 4], [3, 2, 8], (100, 3)).astype(np.float32)
    R = np.asarray(se3.so3_exp(jnp.asarray(np.float32([0.02, 0.1, -0.04])))).astype(np.float32)
    X2 = X @ R.T
    return (X[:, :2] / X[:, 2:]).astype(np.float32), (X2[:, :2] / X2[:, 2:]).astype(np.float32), R


@pytest.mark.parametrize("n,weighted", [(4, False), (5, True), (40, False), (160, True)])
def test_dlt_vs_jax(n, weighted):
    """Exact up to sign, below nine rows (the full V) and above."""
    p1, p2, *_ = planar_scene(seed=0, noise=1e-4)
    p1, p2 = p1[:n], p2[:n]
    w = np.random.default_rng(n).uniform(0.5, 1.5, n).astype(np.float32) if weighted else None
    want = jh.homography_dlt(jnp.asarray(p1), jnp.asarray(p2),
                             None if w is None else jnp.asarray(w))
    got = th.homography_dlt(t(p1), t(p2), None if w is None else t(w))
    up_to_sign(got.numpy(), want, H_TOL)


def test_dlt_fast_and_transfer_error_vs_jax():
    p1, p2, *_ = planar_scene(seed=4, noise=2e-4)
    # distinct rows: a sample with a repeated row has no unique null vector
    rng = np.random.default_rng(0)
    idx = np.stack([rng.choice(len(p1), 4, replace=False) for _ in range(64)])
    want = np.asarray(jh.homography_dlt_fast(jnp.asarray(p1[idx]), jnp.asarray(p2[idx])))
    got = th.homography_dlt_fast(t(p1[idx]), t(p2[idx])).numpy()
    for g, w in zip(got, want):
        up_to_sign(g, w, POSE_TOL)
    err_want = np.asarray(jax.vmap(lambda h: jh.transfer_error(h, jnp.asarray(p1),
                                                              jnp.asarray(p2)))(jnp.asarray(want)))
    err_got = th.transfer_error(t(want), t(p1), t(p2)).numpy()
    np.testing.assert_allclose(err_got, err_want, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("seed", [1, 3, 11])
def test_decomposition_and_pose_vs_jax(seed):
    p1, p2, R, tr, nrm = planar_scene(seed=seed)
    H = np.asarray(jh.homography_dlt(jnp.asarray(p1), jnp.asarray(p2)))
    for g, w in zip(th.decompose_homography(t(H)), jh.decompose_homography(jnp.asarray(H))):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=POSE_TOL)
    w = np.ones(len(p1), np.float32)
    got = th.recover_pose_homography(t(H), t(p1), t(p2), t(w))
    want = jh.recover_pose_homography(jnp.asarray(H), jnp.asarray(p1), jnp.asarray(p2),
                                      jnp.asarray(w))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=0, atol=POSE_TOL)
    # and the pose itself (tests/test_homography.py's check)
    assert float(got[3]) > 0.9 * len(p1)
    assert np.linalg.norm(got[0].numpy() - R) < 1e-3
    assert np.linalg.norm(got[1].numpy() - tr / np.linalg.norm(tr)) < 1e-3
    assert abs(abs(float(got[2].numpy() @ nrm)) - 1.0) < 1e-3


def test_pure_rotation_vs_jax():
    p1, p2, R = rotation_scene()
    H = np.asarray(jh.homography_dlt(jnp.asarray(p1), jnp.asarray(p2)))
    Rc, tc, nc = th.decompose_homography(t(H))
    Rw, tw, nw = jh.decompose_homography(jnp.asarray(H))
    np.testing.assert_allclose(Rc.numpy(), Rw, rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(tc.numpy(), np.zeros((8, 3), np.float32))
    assert np.linalg.norm(Rc[0].numpy() - R) < 1e-3


def _ransac_pair(p1, p2, key, iters, thr):
    valid = np.ones(len(p1), bool)
    want = jh.ransac_homography(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                iters=iters, inlier_threshold=thr)
    got = th.ransac_homography(t(p1), t(p2), t(valid), iters=iters, inlier_threshold=thr,
                               idx=jax_idx(key, valid, iters, 4))
    return got, want


@pytest.mark.parametrize("scene", ["outliers", "clean"])
def test_ransac_homography_vs_jax(scene):
    if scene == "outliers":
        p1, p2, R, tr, bad = outlier_scene()
        key, iters = jax.random.PRNGKey(0), 256
    else:
        p1, p2, R, tr, _ = planar_scene(seed=3)
        bad, key, iters = [], jax.random.PRNGKey(1), 128
    got, want = _ransac_pair(p1, p2, key, iters, 2e-3)
    assert np.array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    assert int(got["num_inliers"]) == int(want["num_inliers"])
    assert bool(got["ambiguous"]) == bool(want["ambiguous"])
    up_to_sign(got["H"].numpy(), want["H"], H_TOL)
    for k in ("R", "t", "n", "R2", "t2", "n2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=POSE_TOL)
    for k in ("cheirality_support", "cheirality_support2"):
        assert float(got[k]) == float(want[k])
    assert not got["inliers"].numpy()[bad].any()


@pytest.mark.parametrize("scene", ["planar", "general"])
def test_select_model_vs_jax(scene):
    """E/H selection: the planar scene routes to the homography, the
    general one stays with the essential pose, in both packages."""
    if scene == "planar":
        p1, p2, R, tr, _ = planar_scene(seed=11)
        key = jax.random.PRNGKey(2)
    else:
        p1, p2, R, tr = general_scene()
        key = jax.random.PRNGKey(3)
    valid = np.ones(len(p1), bool)
    want = jh.select_model(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), iters=128)
    k_e, k_h = jax.random.split(key)
    got = th.select_model(t(p1), t(p2), t(valid), iters=128,
                          idx_e=jax_idx(k_e, valid, 128, 8), idx_h=jax_idx(k_h, valid, 128, 4))
    for k in ("used_homography", "ambiguous"):
        assert bool(got[k]) == bool(want[k]), k
    assert bool(got["used_homography"]) == (scene == "planar")
    assert np.array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    assert int(got["num_inliers"]) == int(want["num_inliers"])
    for k in ("R", "t", "R2", "t2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=POSE_TOL)
    if scene == "general":
        assert np.linalg.norm(got["R"].numpy() - R) < 5e-3


def test_ransac_homography_draws_from_a_generator():
    """Without ``idx`` the samples come from the generator: the planar pose
    is found, and one seed repeats itself."""
    p1, p2, R, tr, bad = outlier_scene(seed=6)
    valid = torch.ones(len(p1), dtype=torch.bool)
    runs = [th.ransac_homography(t(p1), t(p2), valid, iters=256,
                                 generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert np.array_equal(runs[0]["inliers"].numpy(), runs[1]["inliers"].numpy())
    out = runs[0]
    assert not out["inliers"].numpy()[bad].any()
    d = min(np.linalg.norm(out[k].numpy() - R) for k in ("R", "R2"))
    assert d < 2e-2
    sel = th.select_model(t(p1), t(p2), valid, iters=128,
                          generator=torch.Generator().manual_seed(5))
    assert bool(sel["used_homography"])
