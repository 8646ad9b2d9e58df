"""The benchmark's copy of the roofline arithmetic agrees with the port's card
check (``chip_smoke.py``) at the evaluation and VGA shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from portbench import harness, roofline
from portbench.reference import orb

SHAPES = {"eval": (384, 256, 4, 512), "vga": (640, 480, 8, 1000)}


def test_peaks():
    assert (roofline.HBM_BYTES_S, roofline.INT8_OPS_S, roofline.SCALAR_OPS_S,
            roofline.K1_OPS_PER_PIXEL) == (chip_smoke.HBM_BYTES_S, chip_smoke.INT8_OPS_S,
                                           chip_smoke.SCALAR_OPS_S,
                                           chip_smoke.K1_OPS_PER_PIXEL)
    assert set(roofline.KERNELS.values()) == set(chip_smoke.HOPPER_KERNEL_FUNCTIONS)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_k1_k2_k5(shape):
    w, h, levels, k = SHAPES[shape]
    fe = orb.Frontend(w, h, levels, 5 / 6, k, 20, 1 << 10, 16, 8, (w, w, w / 2, h / 2), "cpu")
    ph, pw = fe.padded_height, fe.stride
    n_px = ph * pw
    want = chip_smoke.bound_ms(2 * n_px + (ph + 1) // 2 * ((pw + 1) // 2) * 4,
                               (chip_smoke.K1_OPS_PER_PIXEL * n_px, chip_smoke.SCALAR_OPS_S))[0]
    assert roofline.k1_bound(ph, pw) * 1e3 == pytest.approx(want, rel=1e-12)
    n = (ph + 1) // 2 * ((pw + 1) // 2)
    want = chip_smoke.bound_ms(n * 4 + k * 4, (4 * n, chip_smoke.SCALAR_OPS_S))[0]
    assert roofline.k2_bound(n, k) * 1e3 == pytest.approx(want, rel=1e-12)
    for k2, gated in ((k, False), (8192, False), (8192, True)):
        args = (torch.zeros(k, 8), torch.zeros(k2, 8), 0, 0) + ((0, 0, 0) if gated else ())
        want = chip_smoke.k5_bound(args)[0]
        assert roofline.k5_bound(k, k2, 8, gated) * 1e3 == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_describe(shape):
    w, h, levels, k = SHAPES[shape]
    frames = np.load(harness.ROOT / "data" / "eval_seq3.npz")["frames"]
    img = torch.nn.functional.interpolate(torch.as_tensor(frames[7])[None, None].float(),
                                          size=(h, w), mode="bilinear")[0, 0]
    img = img.round().to(torch.uint8)
    fe = orb.Frontend(w, h, levels, 5 / 6, k, 20, 1 << 10, 16, 8, (w, w, w / 2, h / 2), "cpu")
    f = fe(img)
    pyr = fe.pyramid(img)
    want = chip_smoke.describe_bound(pyr, f.codes, f.valid, f.angles, 8)[0]
    got = roofline.describe_bound(fe.padded_height, fe.stride, f.codes, f.valid, f.angles, 8)
    assert got * 1e3 == pytest.approx(want, rel=1e-12)
