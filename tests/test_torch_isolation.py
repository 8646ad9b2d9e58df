"""The port stands alone: it never imports jax, and its CUDA paths raise
instead of falling back to the plain versions."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pislam_tpu_torch
from pislam_tpu_torch.ops import _build, kernels, nms
from torch_parity import eval_config, port_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "pislam_tpu_torch"


def test_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, pislam_tpu_torch\n"
            "for m in pkgutil.walk_packages(pislam_tpu_torch.__path__, 'pislam_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'pislam_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in PKG.rglob("*.py")) + ["chip_smoke.py"])
def test_no_jax_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "pislam_tpu"), (path, name)


def test_source_check_covers_the_chunk_path():
    """The chunk scan and the homography bootstrap are among the sources
    test_no_jax_import_in_source reads."""
    sources = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    assert {"pislam_tpu_torch/models/slam_scan.py",
            "pislam_tpu_torch/geometry/homography.py"} <= sources
    assert pislam_tpu_torch.make_slam_track_scan.__module__ == "pislam_tpu_torch.models.slam_scan"
    assert pislam_tpu_torch.homography.__name__ == "pislam_tpu_torch.geometry.homography"


def test_source_check_covers_the_service():
    """The service, the demo, their I/O, the checkpoints and the runner are
    among the sources test_no_jax_import_in_source reads."""
    sources = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    assert {f"pislam_tpu_torch/{name}.py" for name in (
        "service", "demo", "io/native", "io/datasets", "utils/checkpoint",
        "parallel/elastic")} <= sources


def test_source_check_covers_the_distributed_layer():
    """The mesh, the sharded match / map / BA and the streams, and the dry
    run are among the sources test_no_jax_import_in_source reads."""
    sources = {p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")}
    assert {f"pislam_tpu_torch/parallel/{name}.py" for name in (
        "mesh", "dist", "dryrun", "elastic")} <= sources


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


WRAPPER_ARGS = {
    "fused_frontend_codes": lambda: (_meta((64, 64), torch.uint8),
                                     _meta((64, 64), torch.uint8), 20, 1 << 10),
    "topk_keys": lambda: (_meta((1000,), torch.int32), 256),
    "gather_windows_packed": lambda: (_meta((64, 64), torch.uint8),
                                      _meta((8,), torch.int32), _meta((8,), torch.int32),
                                      _meta((8,), torch.bool)),
    "orb_select": lambda: (_meta((8, 1024), torch.int8), _meta((30, 256), torch.int16),
                           _meta((30, 256), torch.int16), _meta((1024, 2), torch.int8), 8),
    "atan2_bins": lambda: (_meta((8,), torch.int32), _meta((8,), torch.int32)),
    "match_reduce": lambda: (_meta((40, 8), torch.int32), _meta((50, 8), torch.int32),
                             _meta((40,), torch.bool), _meta((50,), torch.bool)),
    "reduce_codes_4x": lambda: (_meta((64, 64), torch.uint8),),
    "orb_select_bits": lambda: (_meta((8, 1024), torch.int8),
                                _meta((1024, kernels.GM_COLS), torch.int8)),
    "realign_windows": lambda: (_meta((8, 9, 256), torch.int32), _meta((8,), torch.int32),
                                _meta((8,), torch.int32)),
}


@pytest.mark.parametrize("name", WRAPPER_ARGS)
def test_wrapper_off_cpu_never_runs_plain(name, monkeypatch):
    """A tensor that is not on the CPU never reaches the plain version, and
    a refused call counts no launch."""
    wrapper = getattr(kernels, name)
    calls = []
    monkeypatch.setattr(wrapper, "plain", lambda *a: calls.append(a))
    before = wrapper.launches
    with pytest.raises((ValueError, RuntimeError)):
        wrapper(*WRAPPER_ARGS[name]())
    assert calls == [] and wrapper.launches == before


@pytest.mark.parametrize("name", WRAPPER_ARGS)
def test_wrapper_cuda_launch_without_cuda_raises(name, monkeypatch):
    """The launch path itself raises where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wrapper = getattr(kernels, name)
    monkeypatch.setattr(wrapper, "plain", lambda *a: pytest.fail("plain version ran"))
    with pytest.raises((RuntimeError, ValueError)):
        wrapper.launch(*WRAPPER_ARGS[name]())


def test_build_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _build.load.cache_clear()
    with pytest.raises(RuntimeError):
        _build.load()
    # torch built without CUDA raises AssertionError, with no device RuntimeError
    with pytest.raises((RuntimeError, AssertionError)):
        pislam_tpu_torch.make_extract_fn(port_config(eval_config()), device="cuda")


def test_k6_path_raises_off_cpu():
    """The unfused selection goes through K6's wrapper, which has no kernel
    for a device other than CUDA and no fallback."""
    with pytest.raises(ValueError, match="reduce_codes_4x: no kernel for device meta"):
        nms.select_topk_scored(torch.empty((64, 64), dtype=torch.uint8, device="meta"), 16)


def test_library_path_tracks_sources(tmp_path, monkeypatch):
    first = _build.library_path()
    assert first.parent.parent == _build.BUILD_DIR and first.name == _build.LIB_NAME
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    assert _build.library_path() == first
    (src / "orb_select.cu").write_text((src / "orb_select.cu").read_text() + "\n")
    assert _build.library_path() != first


def _run_chip_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
