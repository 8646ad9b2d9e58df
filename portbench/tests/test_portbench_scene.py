"""The rendered stream: the same seed gives the same frames, the lap closes on
itself, and the ground truth is the camera model the renderer uses."""

import numpy as np
import torch

from portbench import harness
from portbench.scene import render

CFG = {"width": 160, "height": 128, "fx": 130.0, "fy": 130.0, "cx": 79.5, "cy": 63.5,
       "scene": {"z_bg": 8.0, "z_fg": 4.0, "margin_x": 48, "margin_y": 48, "gain": 3.0, "texture_seed": 11}}
MIX = {"lap": {"frames": 12, "sx_amp": 0.3, "sx_cycles": 1, "dz_amp": 0.2, "dz_cycles": 2,
               "roll_deg": 8.0, "roll_cycles": 2}}


def test_same_seed_same_frames():
    """The seed orders the cell's frames; the scene is the configuration's."""
    a = harness.Stream(CFG, MIX, 2**31 + 5, "cpu")
    b = harness.Stream(CFG, MIX, 2**31 + 5, "cpu")
    c = harness.Stream(CFG, MIX, 2**31 + 6, "cpu")
    assert torch.equal(a.frames, b.frames) and a.offset == b.offset
    assert torch.equal(a.frames, c.frames) and a.offset != c.offset
    assert not torch.equal(a.frame(0), c.frame(0))
    other = harness.Stream(dict(CFG, scene=dict(CFG["scene"], texture_seed=12)), MIX,
                           2**31 + 5, "cpu")
    assert not torch.equal(a.frames, other.frames)
    assert a.frames.dtype == torch.uint8 and a.frames.shape == (12, 128, 160)
    assert a.frames.float().std() > 20          # photo content, not a flat field


def test_lap_closes():
    """Frame n of the trajectory would be frame 0 again: the pose after the
    last frame continues into the first, and the replay wraps."""
    n = 12
    roll, sx, dz = render.loop_trajectory(n + 1, 0.3, 1, 0.2, 2, 8.0, 2)
    roll_n, sx_n, dz_n = (np.asarray(a) for a in render.loop_trajectory(n, 0.3, 1, 0.2, 2,
                                                                         8.0, 2))
    ph = np.arange(n + 1) / n
    assert np.allclose(0.3 * np.sin(2 * np.pi * ph), np.r_[sx_n, sx_n[0]])
    assert np.allclose(np.deg2rad(8.0) * np.sin(4 * np.pi * ph), np.r_[roll_n, roll_n[0]])
    assert (dz_n >= 0).all()
    s = harness.Stream(CFG, MIX, 7, "cpu")
    assert torch.equal(s.frame(3), s.frame(3 + n))
    R0, t0 = s.truth([0])
    Rn, tn = s.truth([n])
    assert np.array_equal(R0, Rn) and np.array_equal(t0, tn)


def test_ground_truth_projects_like_the_renderer():
    """A texel of the background plane, projected by the true pose of a
    rolled, shifted, dollied frame, lands where the renderer samples it."""
    h, w, m, fx = 64, 96, 40, 80.0
    cx, cy = (w - 1) / 2, (h - 1) / 2
    tex = torch.zeros((h + 2 * m, w + 2 * m))
    ty, tx = 50, 90              # one bright texel of the background, above the band
    tex[ty, tx] = 255.0
    fg = torch.zeros_like(tex)
    scene = render.PlaneScene(w, h, fx, fx, cx, cy, 8.0, 4.0, m, m, tex, fg)
    roll, sx, dz = 0.1, 0.4, 0.5
    frame = scene.render(torch.tensor([roll]), torch.tensor([sx]), torch.tensor([dz]))[0]
    # the texel as a world point on the plane Z = 8, then the true pose
    X = np.array([(tx - m - cx) * 8.0 / fx, (ty - m - cy) * 8.0 / fx, 8.0])
    R, t = render.poses([roll], [sx], [dz])
    xc = R[0] @ X + t[0]
    u, v = fx * xc[0] / xc[2] + cx, fx * xc[1] / xc[2] + cy
    assert 0 <= v < h / 4 and 0 <= u < w     # seen, and not behind the foreground band
    peak = np.unravel_index(int(frame.float().argmax()), frame.shape)
    assert abs(peak[1] - u) <= 1.0 and abs(peak[0] - v) <= 1.0


def test_textures_are_photo_crops():
    photos = np.load(harness.ROOT / "data" / "eval_seq.npz")["frames"][:4]
    bg, fg, picks = render.texture_pair(photos, 3, (100, 120), "cpu", gain=1.0)
    assert bg.shape == fg.shape == (100, 120) and picks[0] != picks[1]
    assert 0 <= float(bg.min()) and float(bg.max()) <= 255
