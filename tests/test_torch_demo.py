"""``pislam_tpu_torch.demo`` against ``pislam_tpu.demo``, on the CPU.

A seeded 640x480 frame goes through the JAX package's pyramid, cropped to
the stacked 640x2210 PNG the reference demo reads. The JAX demo and the
port's demo (``--cpu``, the kernels' plain versions) read that PNG and
must write byte-equal ``out.png`` files and print the same feature count;
the port's ``--build-pyramid`` on the frame itself must write the same
bytes (the JAX demo's own ``--build-pyramid`` raises NameError, ROADMAP R7).
Tolerance 0 throughout. Two frames: ``torch_parity.textured_image``, whose
corners fill all 2048 keypoint slots, and one of flat discs, which does not.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pislam_tpu import demo as jdemo
from pislam_tpu.config import PyramidConfig
from pislam_tpu_torch import demo
from pislam_tpu_torch.frontend import make_extract_fn
from pislam_tpu_torch.io import write_png
from torch_parity import jax_build_pyramid, textured_image

torch.set_num_threads(1)


def _discs(h, w, seed, n=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w), 20.0)
    for _ in range(n):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(10, 60)
        img += rng.uniform(60, 200) * ((xx - cx) ** 2 + (yy - cy) ** 2 < r * r)
    return np.clip(img, 0, 255).astype(np.uint8)


def _count(out):
    return int(re.search(r"^(\d+) features$", out, re.M).group(1))


@pytest.mark.parametrize("frame", ["textured", "discs"])
def test_demo_against_jax(tmp_path, capsys, frame):
    pc = PyramidConfig()
    img = (textured_image(pc.base_height, pc.base_width, seed=3) if frame == "textured"
           else _discs(pc.base_height, pc.base_width, seed=4))
    stacked = np.asarray(jax_build_pyramid(jnp.asarray(img), pc))
    write_png(str(tmp_path / "pyramid.png"), stacked[: pc.total_height, : pc.base_width])
    write_png(str(tmp_path / "frame.png"), img)

    jdemo.main([str(tmp_path / "pyramid.png"), "--out", str(tmp_path / "jax.png")])
    want = _count(capsys.readouterr().out)
    demo.main([str(tmp_path / "pyramid.png"), "--cpu", "--out", str(tmp_path / "port.png")])
    got = capsys.readouterr().out
    demo.main([str(tmp_path / "frame.png"), "--cpu", "--build-pyramid",
               "--out", str(tmp_path / "built.png")])
    built = capsys.readouterr().out

    assert "CPU Time:" in got and "CPU Time:" in built
    assert _count(got) == _count(built) == want
    assert (want == 2048) == (frame == "textured") and want > 100
    jax_png = (tmp_path / "jax.png").read_bytes()
    assert (tmp_path / "port.png").read_bytes() == jax_png
    assert (tmp_path / "built.png").read_bytes() == jax_png


def test_annotate_checks_the_input_shape():
    ex = make_extract_fn(demo.demo_config(), "cpu")
    with pytest.raises(ValueError, match="frame must be 480x640"):
        demo.annotate(np.zeros((2210, 640), np.uint8), ex, build_pyramid=True)
    with pytest.raises(ValueError, match="pyramid must be 2210x640"):
        demo.annotate(np.zeros((480, 640), np.uint8), ex)
    out, n, _ = demo.annotate(np.zeros((480, 640), np.uint8), ex, build_pyramid=True)
    assert n == 0 and out.shape == (2210, 640) and not out.any()


def test_demo_needs_a_card_or_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        demo.main([str(tmp_path / "none.png")])
    assert e.value.code == 2 and "--cpu" in capsys.readouterr().err
