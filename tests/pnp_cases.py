"""Seeded numpy inputs of motion-only BA (``backend/pnp.py``) shared by its
CPU tests (tests/test_torch_motion_only_ba.py) and its card tests
(tests/test_torch_cuda.py). numpy only: the card's machine has no jax.

Each case is a scene of world points seen from a true pose, observed with
noise, and a start pose off the true one; ``CASES`` gives the callers'
parameters (map tracking's, relocalisation's two stages, VO's two-view
refinement) and the edge shapes.
"""

import numpy as np


def rodrigues(w):
    """(3,) axis-angle -> (3, 3) float64 rotation."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


# keyword arguments of motion_only_ba at each caller
MAP_TRACK = dict(iters=8, huber=5e-3, inlier_threshold=6e-3, damping=1e-6)
RELOC_COARSE = dict(iters=15, huber=5e-2, inlier_threshold=6e-3, damping=1e-6)
RELOC_FINE = dict(iters=15, huber=5e-3, inlier_threshold=6e-3, damping=1e-6)
VO_REFINE = dict(iters=6, huber=5e-3, inlier_threshold=2e-3, damping=1e-6)

# name -> (points, parameters, scene options)
CASES = {
    "map tracking 1000": (1000, MAP_TRACK, {}),
    "N=0": (0, MAP_TRACK, {}),
    "N=1": (1, MAP_TRACK, {}),
    "N=1001": (1001, MAP_TRACK, {}),
    "N=2000 (KITTI)": (2000, MAP_TRACK, {}),
    "N=3000": (3000, MAP_TRACK, {}),
    "all invalid": (1000, MAP_TRACK, {"valid": 0.0}),
    "behind the camera": (1000, MAP_TRACK, {"behind": 0.3}),
    "beyond the Huber corner": (1000, MAP_TRACK, {"noise": 2e-2}),
    "relocalise coarse": (1000, RELOC_COARSE, {"valid": 0.4, "pad": True, "start": 0.08}),
    "relocalise fine": (1000, RELOC_FINE, {"valid": 0.4, "pad": True}),
    "VO refine": (512, VO_REFINE, {"outliers": 0.2}),
}


def make_case(n, seed, valid=0.95, behind=0.0, noise=1e-3, outliers=0.1, pad=False,
              start=0.02):
    """(R0, t0, xyz, uv, valid) float32 / bool numpy arrays: n world points
    at depths 2-8 in front of a true pose, their normalised observations
    with Gaussian ``noise``, a share ``outliers`` moved by 0.05 (beyond the
    Huber corner), a share ``behind`` put behind the camera (depths -8 to
    -2), a share ``valid`` valid (``pad``: the rest zero, as
    relocalisation pads its rows), and a start pose off the true one by
    about ``start`` in rotation (rad) and translation."""
    rng = np.random.default_rng(seed)
    Rt = rodrigues(rng.normal(0, 0.1, 3))
    tt = rng.normal(0, 0.2, 3)
    xc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 8, n)], 1)
    xc[:int(round(behind * n)), 2] *= -1.0
    xyz = (xc - tt) @ Rt                      # world points: xc = Rt xyz + tt
    uv = xc[:, :2] / xc[:, 2:] + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    uv[bad] += 0.05
    ok = rng.random(n) < valid
    if pad:
        xyz[~ok] = 0.0
        uv[~ok] = 0.0
    R0 = rodrigues(rng.normal(0, start, 3)) @ Rt
    t0 = tt + rng.normal(0, start, 3)
    return (R0.astype(np.float32), t0.astype(np.float32), xyz.astype(np.float32),
            uv.astype(np.float32), ok)


def case(name, seed=None):
    """(arrays, parameters) of the case ``name``, seeded by its place in
    CASES unless ``seed`` is given."""
    n, params, opts = CASES[name]
    return make_case(n, list(CASES).index(name) + 31 if seed is None else seed, **opts), params


# How far the kernel may lie from the plain version on the same inputs: its
# sums are taken in another order (per thread, then a shuffle tree, then
# over the warps) and its 6x6 solve is its own LU, so it agrees to float32
# rounding, amplified by the normal equations' conditioning.
POSE_TOL = 1e-5            # R and t (chip_smoke.DIST_TRACK_TOL's precedent)
INLIER_TOL = 2             # num_inliers, and inlier flags that differ
COST_RTOL = 1e-5           # each iteration's cost, relative, with an absolute floor
                           # of COST_RTOL x the first cost (costs that fall to ~0)
# With fewer than 3 valid points in front (fewer than 6 residuals) the normal
# equations are singular but for the damping (1e-6): the rounding of either
# version, amplified by 1 / damping, moves the pose in the unobserved
# directions by ~1e-4 (the plain version against itself in float64: up to
# 6.6e-5 at N = 1 over three seeds; this thread model: up to 1.8e-4).
UNDERDETERMINED_POSE_TOL = 1e-3


def mismatches(got, want, arrays):
    """What differs beyond the tolerances between two outputs of
    motion_only_ba (dicts of numpy arrays) on the inputs ``arrays``: a
    list of messages, empty where they agree."""
    R0, t0, xyz, uv, ok = arrays
    front = (xyz.astype(np.float64) @ R0.T.astype(np.float64) + t0)[:, 2] > 0
    tol = POSE_TOL if (ok & front).sum() >= 3 else UNDERDETERMINED_POSE_TOL
    out = []
    for k in ("R", "t"):
        d = float(np.abs(got[k].astype(np.float64) - want[k]).max())
        if not d <= tol:
            out.append(f"{k} differs by {d:.3g} (tolerance {tol:g})")
    d_num = abs(int(got["num_inliers"]) - int(want["num_inliers"]))
    d_flags = int((got["inliers"] != want["inliers"]).sum())
    if d_num > INLIER_TOL or d_flags > INLIER_TOL:
        out.append(f"inliers {int(got['num_inliers'])} vs {int(want['num_inliers'])}, "
                   f"{d_flags} flags differ")
    gc, wc = got["costs"].astype(np.float64), want["costs"].astype(np.float64)
    if gc.shape != wc.shape or (wc.size and not np.all(
            np.abs(gc - wc) <= COST_RTOL * (np.abs(wc) + abs(wc[0])))):
        out.append(f"costs {gc} vs {wc}")
    return out
