"""Motion-only BA's kernel (csrc/motion_only_ba.cu) as far as the CPU
reaches it; the kernel itself runs only on the card (test_torch_cuda.py).

- ``pnp.motion_only_ba`` on CPU tensors is ``motion_only_ba_plain`` bit for
  bit, and launches nothing.
- The kernel's wrapper is counted (``kernels.COUNTED``, ``launch_counts``)
  and its argument checks raise on a wrong dtype, shape, device or
  iteration count before any launch.
- The kernel's arithmetic modelled in numpy float32, thread by thread (each
  thread's points in its order, the xor-shuffle tree within a warp, the
  warps in order, LU with partial pivoting, se3_exp on the left), agrees with
  the plain version within the tolerances the card tests hold the kernel to
  (tests/pnp_cases.py), on every case of the card tests.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import pnp_cases
from pislam_tpu_torch.backend import pnp
from pislam_tpu_torch.ops import kernels

torch.set_num_threads(1)

F = np.float32
# the block the kernel is built with (csrc/motion_only_ba.cu kThreads)
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", (
    Path(kernels.__file__).resolve().parent.parent / "csrc" / "motion_only_ba.cu").read_text()
).group(1))
WARPS = THREADS // 32


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy(out):
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", list(pnp_cases.CASES))
def test_cpu_is_plain_bit_for_bit(name):
    arrays, params = pnp_cases.case(name)
    kernels.reset_launch_counts()
    got = pnp.motion_only_ba(*map(t, arrays), **params)
    want = pnp.motion_only_ba_plain(*map(t, arrays), **params)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert kernels.launch_counts()["motion_only_ba"] == 0


def test_kernel_is_counted():
    assert pnp.motion_only_ba_kernel in kernels.COUNTED
    assert "motion_only_ba" in kernels.launch_counts()
    assert pnp.motion_only_ba_kernel.plain is pnp.motion_only_ba_plain
    assert pnp.motion_only_ba_kernel.launch is kernels.motion_only_ba
    assert pnp.motion_only_ba_kernel.source == "pislam_tpu_torch/csrc/motion_only_ba.cu"


def _good():
    (R0, t0, xyz, uv, ok), _ = pnp_cases.case("N=1001")
    return [t(R0), t(t0), t(xyz), t(uv), t(ok)]


def _bad(which):
    args = _good()
    if which == "R0 float64":
        args[0] = args[0].double()
    elif which == "xyz float64":
        args[2] = args[2].double()
    elif which == "valid uint8":
        args[4] = args[4].to(torch.uint8)
    elif which == "R0 (9,)":
        args[0] = args[0].reshape(9)
    elif which == "t0 (1, 3)":
        args[1] = args[1].reshape(1, 3)
    elif which == "xyz (N, 4)":
        args[2] = torch.cat([args[2], args[2][:, :1]], 1)
    elif which == "uv short":
        args[3] = args[3][:-1].contiguous()
    elif which == "valid short":
        args[4] = args[4][:-1].contiguous()
    elif which == "uv not contiguous":
        args[3] = args[3].t().contiguous().t()
    elif which == "xyz on meta":
        args[2] = torch.empty(args[2].shape, device="meta")
    return args


@pytest.mark.parametrize("which,error", [
    ("R0 float64", TypeError), ("xyz float64", TypeError), ("valid uint8", TypeError),
    ("R0 (9,)", ValueError), ("t0 (1, 3)", ValueError), ("xyz (N, 4)", ValueError),
    ("uv short", ValueError), ("valid short", ValueError), ("uv not contiguous", ValueError),
    ("xyz on meta", ValueError)])
def test_launch_checks_raise(which, error):
    """The wrapper's checks, reached through ``launch`` with CPU tensors: a
    bad argument raises before the library is loaded (which needs a card)."""
    with pytest.raises(error):
        kernels.motion_only_ba(*_bad(which), 8, 5e-3, 6e-3, 1e-6)


@pytest.mark.parametrize("iters", [0, -1])
def test_launch_checks_iterations(iters):
    with pytest.raises(ValueError):
        kernels.motion_only_ba(*_good(), iters, 5e-3, 6e-3, 1e-6)


def test_no_kernel_for_other_devices():
    args = [torch.empty(a.shape, dtype=a.dtype, device="meta") for a in _good()]
    with pytest.raises(ValueError):
        pnp.motion_only_ba(*args)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, thread by thread
# ---------------------------------------------------------------------------

def _terms(R, tv, xyz, uv, ok, huber):
    """Each point's 28 terms (J^T W J's upper triangle, J^T W r, the cost)
    as csrc/motion_only_ba.cu accumulate() forms them, and its camera
    coordinates and residual norm."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    xc = [R[i, 0] * x + R[i, 1] * y + R[i, 2] * z + tv[i] for i in range(3)]
    front = xc[2] > F(1e-6)
    zs = np.where(front, xc[2], F(1))
    inv = F(1) / zs
    r0 = xc[0] / zs - uv[:, 0]
    r1 = xc[1] / zs - uv[:, 1]
    rn = np.sqrt(r0 * r0 + r1 * r1)
    w = np.where(rn > F(huber), F(huber) / np.maximum(rn, F(1e-12)), F(1))
    w = np.where(ok & front, w, F(0))
    fr = front.astype(F)
    a = -xc[0] * inv * inv * fr
    b = -xc[1] * inv * inv * fr
    zero = np.zeros_like(inv)
    j0 = [inv, zero, a, a * xc[1], inv * xc[2] - a * xc[0], -inv * xc[1]]
    j1 = [zero, inv, b, b * xc[1] - inv * xc[2], -b * xc[0], inv * xc[0]]
    w0, w1 = [j * w for j in j0], [j * w for j in j1]
    out = [w0[i] * j0[j] + w1[i] * j1[j] for i in range(6) for j in range(i, 6)]
    out += [w0[i] * r0 + w1[i] * r1 for i in range(6)]
    out.append(w * rn * rn)
    return np.stack(out, 1).astype(F), xc, rn


def _block_sum(terms):
    """Thread p % 256 adds point p's terms in order of p; each warp's xor
    butterfly (every lane ends with the same sums); warp 0's sums plus warp
    1's, ... in warp order."""
    acc = np.zeros((THREADS, terms.shape[1]), F)
    for lo in range(0, terms.shape[0], THREADS):
        part = terms[lo:lo + THREADS]
        acc[:part.shape[0]] = acc[:part.shape[0]] + part
    acc = acc.reshape(WARPS, 32, -1)
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    assert (acc == acc[:, :1]).all() or not np.isfinite(acc).all()
    s = acc[0, 0]
    for w in range(1, WARPS):
        s = s + acc[w, 0]
    return s


def _solve(sums, damping):
    """LU with partial pivoting (the first largest pivot), the column scaled
    by the pivot's reciprocal, then the two triangular solves."""
    A = np.zeros((6, 6), F)
    A[np.triu_indices(6)] = sums[:21]
    A = A + np.triu(A, 1).T
    A[np.arange(6), np.arange(6)] += F(damping)
    b = -sums[21:27]
    for j in range(6):
        p = j + int(np.argmax(np.abs(A[j:, j])))
        A[[j, p]], b[[j, p]] = A[[p, j]], b[[p, j]]
        if A[j, j] != 0:
            A[j + 1:, j] = A[j + 1:, j] * (F(1) / A[j, j])
        A[j + 1:, j + 1:] = A[j + 1:, j + 1:] - np.outer(A[j + 1:, j], A[j, j + 1:])
    for j in range(6):
        b[j + 1:] = b[j + 1:] - b[j] * A[j + 1:, j]
    for j in range(5, -1, -1):
        b[j] = b[j] / A[j, j]
        b[:j] = b[:j] - b[j] * A[:j, j]
    return b


def _apply_twist(xi, R, tv):
    """se3.se3_exp(xi) applied on the left, with se3._coefficients' forms."""
    rho, w = xi[:3], xi[3:]
    th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    if th2 < F(5e-3):
        a = F(1) - th2 / F(6) + th2 * th2 / F(120)
        b = F(0.5) - th2 / F(24) + th2 * th2 / F(720)
        c = F(1 / 6) - th2 / F(120) + th2 * th2 / F(5040)
    else:
        ts = np.sqrt(th2)
        sh, s = np.sin(F(0.5) * ts), np.sin(ts)
        a, b, c = s / ts, F(2) * sh * sh / (ts * ts), (ts - s) / (ts * ts * ts)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], F)
    K2 = K @ K
    eye = np.eye(3, dtype=F)
    dR = eye + a * K + b * K2
    V = eye + b * K + c * K2
    return (dR @ R).astype(F), (dR @ tv + V @ rho).astype(F)


def kernel_model(R0, t0, xyz, uv, ok, iters, huber, inlier_threshold, damping):
    """csrc/motion_only_ba.cu in numpy float32: every iteration's sums,
    solve and update, then the inliers at the final pose."""
    R, tv, costs = R0.astype(F), t0.astype(F), []
    with np.errstate(all="ignore"):
        for _ in range(iters):
            sums = _block_sum(_terms(R, tv, xyz, uv, ok, huber)[0])
            R, tv = _apply_twist(_solve(sums, damping), R, tv)
            costs.append(sums[27])
        _, xc, rn = _terms(R, tv, xyz, uv, ok, huber)
    inl = ok & (xc[2] > F(1e-6)) & (rn < F(inlier_threshold))
    return {"R": R, "t": tv, "inliers": inl, "num_inliers": np.int64(inl.sum()),
            "costs": np.array(costs, F)}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(pnp_cases.CASES))
def test_thread_model_within_tolerance_of_plain(name, seed):
    arrays, params = pnp_cases.case(name, 100 * list(pnp_cases.CASES).index(name) + seed)
    got = kernel_model(*arrays, **params)
    want = _numpy(pnp.motion_only_ba_plain(*map(t, arrays), **params))
    assert not pnp_cases.mismatches(got, want, arrays)
    if name in ("N=0", "all invalid"):          # H = damping I, b = 0: the pose stays
        for k in ("R", "t", "costs"):
            assert np.array_equal(got[k], want[k])
