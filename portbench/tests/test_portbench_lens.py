"""A configuration's ``lens``: without one the lap renders as it always did;
with one the renderer bends each pixel's ray by the inverse solved to
convergence, the port gets the lens as its ``dist``, the reference undoes
it to convergence, and ``feature_rows_off`` tells a port that inverts the
lens short of convergence from one that does not. A lens with a term that
the port's model lacks is refused."""

import hashlib

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.reference import lens
from portbench.scene import render
from pislam_tpu_torch.geometry import camera

# ORB-SLAM2's Examples/Monocular/EuRoC.yaml: the EuRoC MAV cam0 at 752x480
EUROC_LENS = {"model": "radtan", "k1": -0.28340811, "k2": 0.07395907,
              "p1": 0.00019359, "p2": 1.76187114e-05}
EUROC_CAMERA = {"width": 752, "height": 480, "fx": 458.654, "fy": 457.296,
                "cx": 367.215, "cy": 248.375}
# sha256 of the TUM lap's frames (300 x 480 x 640 uint8) rendered on the CPU
# by the renderer as it was before a configuration could state a lens
TUM_LAP_SHA256 = "8e2d16c35b8f551f8f8872c357b9453bcba62026f2d4a124decccba38a52289d"
SHORT_LAP = {"lap": {"frames": 4, "sx_amp": 0.3, "sx_cycles": 1, "dz_amp": 0.2,
                     "dz_cycles": 2, "roll_deg": 8.0, "roll_cycles": 2}}


def _euroc(lens_entry=EUROC_LENS):
    return dict(harness.load_json("configs", "tum_fr1_vga"), **EUROC_CAMERA, lens=lens_entry)


def test_no_lens_lap_is_unchanged():
    cfg = harness.load_json("configs", "tum_fr1_vga")
    assert "lens" not in cfg
    laps = {str(harness.load_json("traffic", w["traffic"])["lap"]): w["traffic"]
            for w in harness.load_spec()["workloads"] if w["config"] == "tum_fr1_vga"}
    for traffic in laps.values():
        s = harness.Stream(cfg, harness.load_json("traffic", traffic), 5, "cpu")
        assert hashlib.sha256(s.frames.numpy().tobytes()).hexdigest() == TUM_LAP_SHA256


def test_euroc_inverse_round_trips_every_pixel():
    c = EUROC_CAMERA
    terms = lens.terms({"lens": EUROC_LENS})
    u, v = np.meshgrid(np.arange(c["width"], dtype=np.float64),
                       np.arange(c["height"], dtype=np.float64))
    xd, yd = (u - c["cx"]) / c["fx"], (v - c["cy"]) / c["fy"]
    x, y = lens.undistort(xd, yd, *terms)
    rx, ry = lens.distort(x, y, *terms)
    assert max(np.abs(rx - xd).max(), np.abs(ry - yd).max()) <= 1e-9
    # barrel distortion: the corners see farther out than their pixels say
    assert abs(x[0, 0]) > abs(xd[0, 0]) + 0.1


def test_rendered_point_lands_at_its_distorted_pixel():
    """A bright texel at a known ideal pixel near a corner, seen at the
    identity pose through EuRoC's lens, peaks at the pixel the lens moves it
    to (about 20 px from where it would be without the lens)."""
    c = EUROC_CAMERA
    w, h, fx, fy, cx, cy = (c[k] for k in ("width", "height", "fx", "fy", "cx", "cy"))
    m = 120
    X, Y = 60.0, 40.0                           # the ideal pixel
    tex = torch.zeros((h + 2 * m, w + 2 * m))
    tex[int(Y) + m, int(X) + m] = 255.0         # at the identity pose a texel's
    terms = lens.terms({"lens": EUROC_LENS})    # ideal pixel is its own place
    rays = render.lens_rays(w, h, fx, fy, cx, cy, terms, "cpu")
    scene = render.PlaneScene(w, h, fx, fy, cx, cy, 8.0, 4.0, m, m, tex, tex.clone(), rays)
    frame = scene.render(torch.zeros(1), torch.zeros(1), torch.zeros(1))[0]
    xd, yd = lens.distort((X - cx) / fx, (Y - cy) / fy, *terms)
    u, v = fx * xd + cx, fy * yd + cy
    peak = np.unravel_index(int(frame.float().argmax()), frame.shape)
    assert abs(peak[1] - u) <= 1.0 and abs(peak[0] - v) <= 1.0
    assert np.hypot(u - X, v - Y) > 15.0
    plain = render.PlaneScene(w, h, fx, fy, cx, cy, 8.0, 4.0, m, m, tex, tex.clone())
    frame0 = plain.render(torch.zeros(1), torch.zeros(1), torch.zeros(1))[0]
    assert np.unravel_index(int(frame0.float().argmax()), frame0.shape) == (int(Y), int(X))


def test_rows_off_tells_five_iterations_from_convergence():
    """On a rendered EuRoC frame, the port (built by ``build_slam``, with the
    configuration's lens as its ``dist``) undistorts its points with a fixed
    5 iterations: ``rows_off`` counts the rows they leave more than 1e-5
    from the reference's converged points, and counts none where the same
    rows carry the reference's inverse."""
    cfg = _euroc()
    stream = harness.Stream(cfg, SHORT_LAP, 2**31 + 9, "cpu")
    slam = harness.build_slam(cfg, 2**31 + 9, "cpu")
    terms = lens.terms(cfg)
    assert slam.vo.frontend.dist == terms
    feats, pts = slam.vo.frontend(stream.frame(0))
    ref = check.reference_frontend(cfg, "cpu")(stream.frame(0))
    codes, valid, desc = (x.numpy() for x in (feats.codes, feats.valid, feats.descriptors))
    n = int(valid.sum())
    assert n > 100
    five = check.rows_off(codes, valid, desc, pts.numpy(), ref)
    assert five > n // 10, (five, n)
    # the port's own arithmetic, from the same distorted points
    plain = check.reference_frontend(dict(cfg, lens=None), "cpu")(stream.frame(0))
    assert torch.allclose(camera.undistort_normalised(plain.pts, *terms), pts, atol=1e-6)
    assert check.rows_off(codes, valid, desc, ref.pts.numpy(), ref) == 0


OUTSIDE = {"k3": dict(EUROC_LENS, k3=1.163314),
           "model": dict(EUROC_LENS, model="equidistant"),
           "missing": {k: v for k, v in EUROC_LENS.items() if k != "k1"}}


@pytest.mark.parametrize("case", OUTSIDE)
def test_lens_outside_the_ports_model_is_refused(case):
    cfg = _euroc(OUTSIDE[case])
    with pytest.raises(ValueError, match=case):
        lens.terms(cfg)
    with pytest.raises(ValueError):
        harness.Stream(cfg, SHORT_LAP, 1, "cpu")
    with pytest.raises(ValueError):
        harness.build_slam(cfg, 1, "cpu")
    with pytest.raises(ValueError):
        check.reference_frontend(cfg, "cpu")


def test_lens_that_folds_inside_the_frame_is_refused():
    """TUM1.yaml's four terms without its k3: the model folds over inside
    the frame, and no inverse meets 1e-9 there."""
    cfg = dict(harness.load_json("configs", "tum_fr1_vga"))
    cfg["lens"] = {"model": "radtan", "k1": 0.262383, "k2": -0.953104,
                   "p1": -0.005358, "p2": 0.002628}
    with pytest.raises(ValueError, match="does not invert"):
        harness.Stream(cfg, SHORT_LAP, 1, "cpu")
