"""The port's geometry, RANSAC, motion-only BA and evaluation against the JAX
package, float32 on the CPU, on the same seeded numpy inputs.

Tolerances: elementwise formulas are compared to a few float32 ulps
(1e-6 absolute at unit scale); solves through an SVD or a Householder chain
to 1e-4 (the order of float32 sums differs between torch and XLA). E is
defined up to sign (LAPACK and cuSOLVER pick singular-vector signs freely),
so E is compared up to sign and R, t after ``recover_pose``. RANSAC is fed
the JAX package's own ``jax.random.categorical`` draws and held to
``tests/test_vo_scan.py``'s tolerance: inlier counts within 2, R and t
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pislam_tpu import evaluation as jeval
from pislam_tpu.backend import pnp as jpnp
from pislam_tpu.geometry import camera as jcam
from pislam_tpu.geometry import epipolar as jepi
from pislam_tpu.geometry import ransac as jransac
from pislam_tpu.geometry import se3 as jse3
from pislam_tpu_torch import evaluation as teval
from pislam_tpu_torch.backend import pnp as tpnp
from pislam_tpu_torch.geometry import camera as tcam
from pislam_tpu_torch.geometry import epipolar as tepi
from pislam_tpu_torch.geometry import ransac as transac
from pislam_tpu_torch.geometry import se3 as tse3
from torch_parity import t

torch.set_num_threads(1)


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def rotvecs(seed):
    """Axis-angles from the Taylor branch through the closed form to near pi."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return (axes * np.array([0.0, 1e-4, 0.05, 0.5, 2.0, 3.1])[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def test_so3_exp_log():
    w = rotvecs(0)
    close(tse3.hat(t(w)), jse3.hat(jnp.asarray(w)), 0)
    R = tse3.so3_exp(t(w))
    close(R, jse3.so3_exp(jnp.asarray(w)), 1e-6)
    close(tse3.so3_log(R), jse3.so3_log(jnp.asarray(R.numpy())), 1e-5)


def test_se3_exp_log_compose_inverse_transform():
    rng = np.random.default_rng(1)
    xi = np.concatenate([rng.normal(size=(6, 3)), rotvecs(1)], 1).astype(np.float32)
    R, tt = tse3.se3_exp(t(xi))
    jR, jt = jse3.se3_exp(jnp.asarray(xi))
    close(R, jR, 1e-6)
    close(tt, jt, 1e-5)
    close(tse3.se3_log(R, tt), jse3.se3_log(jR, jt), 1e-4)
    for got, want in zip(tse3.compose(R, tt, R.flip(0), tt.flip(0)),
                         jse3.compose(jR, jt, jR[::-1], jt[::-1])):
        close(got, want, 1e-5)
    for got, want in zip(tse3.inverse(R, tt), jse3.inverse(jR, jt)):
        close(got, want, 1e-6)
    X = rng.normal(size=(6, 5, 3)).astype(np.float32)
    close(tse3.transform(R, tt, t(X)), jse3.transform(jR, jt, jnp.asarray(X)), 1e-5)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", [(-0.3, 0.1, 0.001, -0.002), (0.05, 0.0, 0.0, 0.0)])
def test_distort_undistort(dist):
    pts = np.random.default_rng(2).uniform(-0.6, 0.6, (200, 2)).astype(np.float32)
    d = tcam.distort_normalised(t(pts), *dist)
    close(d, jcam.distort_normalised(jnp.asarray(pts), *dist), 1e-6)
    u = tcam.undistort_normalised(d, *dist)
    close(u, jcam.undistort_normalised(jnp.asarray(d.numpy()), *dist), 1e-6)


# ---------------------------------------------------------------------------
# epipolar
# ---------------------------------------------------------------------------

def two_view(seed, n=200, noise=1e-4, outliers=0.2):
    """Correspondences of a known (R, t) with pixel noise and outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 6, n)], 1)
    w = rng.normal(size=3)
    R = np.asarray(jse3.so3_exp(jnp.asarray(0.1 * w / np.linalg.norm(w), jnp.float32)),
                   np.float64)
    tr = rng.normal(size=3) * 0.3
    X2 = X @ R.T + tr
    p1 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    p2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] = rng.uniform(-0.4, 0.4, (int(bad.sum()), 2))
    valid = rng.random(n) < 0.9
    return p1.astype(np.float32), p2.astype(np.float32), valid


def test_constraint_rows_and_fast_hypotheses():
    p1, p2, valid = two_view(3)
    w = valid.astype(np.float32)
    close(tepi._constraint_rows(t(p1), t(p2), t(w)),
          jepi._constraint_rows(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)), 0)
    # distinct rows: a sample with a repeated row has no unique nullvector
    rng = np.random.default_rng(4)
    idx = np.stack([rng.choice(200, 8, replace=False) for _ in range(16)])
    got = tepi.essential_8pt_fast(t(p1[idx]), t(p2[idx]))
    want = jepi.essential_8pt_fast(jnp.asarray(p1[idx]), jnp.asarray(p2[idx]))
    close(got, want, 1e-4)
    close(tepi.sampson_error(got, t(p1), t(p2)),
          jax.vmap(lambda e: jepi.sampson_error(e, jnp.asarray(p1), jnp.asarray(p2)))(
              jnp.asarray(got.numpy())), 1e-7)


def test_essential_8pt_up_to_sign_and_recover_pose():
    p1, p2, _ = two_view(5, outliers=0.0)
    w = np.ones(200, np.float32)
    E = tepi.essential_8pt(t(p1), t(p2), t(w))
    jE = np.asarray(jepi.essential_8pt(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w)))
    assert min(np.abs(E.numpy() - jE).max(), np.abs(E.numpy() + jE).max()) < 1e-4
    R, tt, n = tepi.recover_pose(E, t(p1), t(p2), t(w))
    jR, jt, jn = jepi.recover_pose(jnp.asarray(jE), jnp.asarray(p1), jnp.asarray(p2),
                                   jnp.asarray(w))
    close(R, jR, 1e-4)
    close(tt, jt, 1e-4)
    assert float(n) == float(jn) > 190
    z1, z2 = tepi.triangulate_depths(R, tt, t(p1), t(p2))
    jz1, jz2 = jepi.triangulate_depths(jR, jt, jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_allclose(z1.numpy(), np.asarray(jz1), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(z2.numpy(), np.asarray(jz2), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,iters", [(6, 256), (7, 64)])
def test_ransac_with_jax_draws(seed, iters):
    p1, p2, valid = two_view(seed)
    key = jax.random.PRNGKey(seed)
    logits = jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)
    idx = np.asarray(jax.random.categorical(key, logits[None, :], shape=(iters, 8)))
    want = jransac.ransac_essential(key, jnp.asarray(p1), jnp.asarray(p2),
                                    jnp.asarray(valid), iters=iters, inlier_threshold=2e-3)
    got = transac.ransac_essential(t(p1), t(p2), t(valid), iters, 8, 2e-3, idx=t(idx))
    assert abs(int(got["num_inliers"]) - int(want["num_inliers"])) <= 2
    assert int(got["num_inliers"]) > 100
    close(got["R"], want["R"], 1e-4)
    close(got["t"], want["t"], 1e-4)


def test_ransac_zero_valid_does_not_raise():
    p1, p2, _ = two_view(8)
    valid = np.zeros(200, bool)
    g = torch.Generator().manual_seed(0)
    out = transac.ransac_essential(t(p1), t(p2), t(valid), 32, 8, 2e-3, generator=g)
    assert int(out["num_inliers"]) == 0 and out["R"].shape == (3, 3)
    jout = jransac.ransac_essential(jax.random.PRNGKey(0), jnp.asarray(p1), jnp.asarray(p2),
                                    jnp.asarray(valid), iters=32, inlier_threshold=2e-3)
    assert int(jout["num_inliers"]) == 0


def test_sample_indices_uniform_over_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 10, 11, 40]] = True
    idx = transac.sample_indices(valid, 4000, 8, torch.Generator().manual_seed(1))
    assert idx.shape == (4000, 8) and valid[idx].all()
    counts = torch.bincount(idx.reshape(-1), minlength=50)[[3, 10, 11, 40]].float()
    assert (counts / counts.sum() - 0.25).abs().max() < 0.02
    none = transac.sample_indices(torch.zeros(50, dtype=torch.bool), 4, 8,
                                  torch.Generator().manual_seed(1))
    assert not none.any()            # jax.random.categorical over all -inf gives 0


# ---------------------------------------------------------------------------
# motion-only BA
# ---------------------------------------------------------------------------

def test_motion_only_ba():
    rng = np.random.default_rng(9)
    n = 150
    xyz = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)],
                   1).astype(np.float32)
    Rt = np.asarray(jse3.so3_exp(jnp.asarray([0.02, -0.05, 0.03], jnp.float32)))
    tt = np.array([0.1, -0.05, 0.2], np.float32)
    xc = xyz @ Rt.T + tt
    uv = (xc[:, :2] / xc[:, 2:] + rng.normal(0, 1e-3, (n, 2))).astype(np.float32)
    uv[:10] += 0.05                                  # outliers for the Huber weights
    valid = rng.random(n) < 0.95
    R0 = np.eye(3, dtype=np.float32)
    t0 = np.zeros(3, np.float32)
    want = jpnp.motion_only_ba(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(xyz),
                               jnp.asarray(uv), jnp.asarray(valid), iters=6)
    got = tpnp.motion_only_ba(t(R0), t(t0), t(xyz), t(uv), t(valid), iters=6)
    close(got["R"], want["R"], 1e-5)
    close(got["t"], want["t"], 1e-5)
    assert np.array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    np.testing.assert_allclose(got["costs"].numpy(), np.asarray(want["costs"]), rtol=1e-3)
    r, z = tpnp._project_residuals(t(Rt), t(tt), t(xyz), t(uv))
    jr, jz = jpnp._project_residuals(jnp.asarray(Rt), jnp.asarray(tt), jnp.asarray(xyz),
                                     jnp.asarray(uv))
    close(r, jr, 1e-6)
    close(z, jz, 1e-6)


def test_motion_only_ba_jacobian_is_jacfwd():
    """The written-out PnP Jacobian is the JAX package's jax.jacfwd of the
    residual at the identity perturbation, behind-camera points included."""
    rng = np.random.default_rng(10)
    n = 64
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    xyz[:8, 2] = -2.0                                # behind the camera
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.3, -0.2, 0.1], jnp.float32)))
    tv = np.array([0.2, -0.1, 4.0], np.float32)
    uv = rng.normal(0, 0.3, (n, 2)).astype(np.float32)

    def res(xi):
        dR, dt = jse3.se3_exp(xi)
        return jpnp._project_residuals(dR @ R, dR @ tv + dt, xyz, uv)[0]

    want = jax.jacfwd(res)(jnp.zeros(6, jnp.float32))
    got = tpnp._jacobian(*tpnp._camera_points(t(R), t(tv), t(xyz)))
    close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_scale", [True, False])
def test_evaluation_is_the_same_numpy(with_scale):
    rng = np.random.default_rng(10)
    gt = np.cumsum(rng.normal(size=(40, 3)), 0)
    est = 0.5 * gt @ np.asarray(jse3.so3_exp(jnp.asarray([0.3, 0.1, -0.2]))).T + 1.0
    est += rng.normal(0, 0.05, est.shape)
    for got, want in zip(teval.umeyama_align(est, gt, with_scale),
                         jeval.umeyama_align(est, gt, with_scale)):
        np.testing.assert_array_equal(got, want)
    assert teval.ate_rmse(est, gt, with_scale) == jeval.ate_rmse(est, gt, with_scale)
    assert teval.rpe_rmse(est, gt, 2) == jeval.rpe_rmse(est, gt, 2)
