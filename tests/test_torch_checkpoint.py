"""Checkpoints of the port's SLAM state (``utils/checkpoint.py``,
``KeyframeSLAM.save_checkpoint`` / ``restore_checkpoint``) and the
single-process ``parallel/elastic.CheckpointedRunner``, on the CPU.

A state after 8 eval_seq frames in chunks of 4, at the service's config,
survives a round trip bit for bit (tolerance 0): every table, the
counters, the culled slots and the generator's state.
"""

import dataclasses

import numpy as np
import pytest
import torch

import pislam_tpu_torch as pt
from pislam_tpu_torch import service
from pislam_tpu_torch.models.slam import init_state
from pislam_tpu_torch.parallel.elastic import CheckpointedRunner
from pislam_tpu_torch.utils import checkpoint as ckpt
from torch_parity import DATA

torch.set_num_threads(1)

FRAMES, CHUNK = 8, 4


def _slam(cfg=None):
    d = np.load(DATA / "eval_seq.npz")
    intr = tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy"))
    return pt.KeyframeSLAM(cfg or service.build_config(384, 256), *intr,
                           keyframe_min_inliers=60, keyframe_max_gap=3, device="cpu")


@pytest.fixture(scope="module")
def tracked():
    """A SLAM after 8 frames in chunks of 4, with one keyframe slot culled
    (invalid, ordinal kept) so that the culled set is not empty."""
    slam = _slam()
    frames = np.load(DATA / "eval_seq.npz")["frames"][:FRAMES]
    for i in range(0, FRAMES, CHUNK):
        slam.process_chunk(frames[i:i + CHUNK])
    st = slam.state
    valid = st.store.valid.clone()
    valid[1] = False
    slam.set_state(st._replace(store=st.store._replace(valid=valid)))
    assert slam.num_keyframes >= 2 and slam.num_landmarks > 0
    assert slam._culled_slots == {1}
    torch.rand(3, generator=slam.state.generator)     # a generator not at its seed
    return slam


def assert_states_equal(a, b):
    la, lb = ckpt.leaves(a), ckpt.leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        x, y = la[name], lb[name]
        if isinstance(x, dict):
            assert x["generator"] == y["generator"], name
            assert torch.equal(x["state"], y["state"]), name
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def test_slam_state_round_trip(tracked, tmp_path):
    path = str(tmp_path / "map.pt")
    tracked.save_checkpoint(path)
    back = _slam()
    back.restore_checkpoint(path)
    assert_states_equal(back.state, tracked.state)
    for attr in ("_num_kf", "_num_lm", "_num_obs", "_frame_idx", "_since_kf",
                 "_culled_slots", "num_keyframes", "keyframes_inserted"):
        assert getattr(back, attr) == getattr(tracked, attr), attr
    a, b = torch.rand(5, generator=back.state.generator), \
        torch.rand(5, generator=tracked.state.generator)
    assert torch.equal(a, b)                   # the draws continue alike
    # the file loads with weights_only=True: no pickled code
    blob = torch.load(path, weights_only=True)
    assert blob["format"] == ckpt.FORMAT
    assert "lmap.xyz" in blob["leaves"] and "generator" in blob["leaves"]


def test_another_config_raises_naming_the_field(tracked, tmp_path):
    path = str(tmp_path / "map.pt")
    tracked.save_checkpoint(path)
    cfg = service.build_config(384, 256)
    other = _slam(dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, max_landmarks=768)))
    with pytest.raises(ValueError, match=r"lmap\.xyz.*\(8192, 3\).*\(768, 3\)"):
        other.restore_checkpoint(path)


def test_failed_save_keeps_the_previous_checkpoint(tracked, tmp_path, monkeypatch):
    path = tmp_path / "map.pt"
    tracked.save_checkpoint(str(path))
    before = path.read_bytes()
    real = torch.save

    def torn(obj, f, *a, **kw):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(str(path), init_state(service.build_config(384, 256), device="cpu"))
    monkeypatch.setattr(torch, "save", real)
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["map.pt"]     # no temporary left
    back = _slam()
    back.restore_checkpoint(str(path))
    assert_states_equal(back.state, tracked.state)


def test_generator_of_another_device_type(tracked, tmp_path):
    """A generator saved on another device type raises on restore; with
    strict_generator=False the tables load and a generator seeded with the
    SLAM's seed takes its place."""
    path = tmp_path / "map.pt"
    tracked.save_checkpoint(str(path))
    blob = torch.load(path, weights_only=True)
    blob["leaves"]["generator"] = {"generator": "cuda",
                                   "state": torch.zeros(16, dtype=torch.uint8)}
    torch.save(blob, path)
    back = _slam()
    with pytest.raises(ValueError, match="generator: a cuda generator cannot be restored onto cpu"):
        back.restore_checkpoint(str(path))
    back.restore_checkpoint(str(path), strict_generator=False)
    want = tracked.state._replace(generator=torch.Generator().manual_seed(back.seed))
    assert_states_equal(back.state, want)


def test_restore_without_like_and_structure_checks(tracked, tmp_path):
    path = str(tmp_path / "run.pt")
    ckpt.save(path, {"state": tracked.state, "steps_done": 3})
    leaves = ckpt.restore(path)
    assert leaves["steps_done"] == 3
    assert torch.equal(leaves["state.counters"], tracked.state.counters)
    assert leaves["state.generator"]["generator"] == "cpu"
    with pytest.raises(ValueError, match="steps_done"):
        ckpt.restore(path, like={"state": tracked.state})
    with pytest.raises(ValueError, match="state.extra: missing"):
        ckpt.restore(path, like={"state": {"extra": torch.zeros(1)}, "steps_done": 0})
    with pytest.raises(TypeError):
        ckpt.save(path, {"x": 1.5})


def test_checkpointed_runner(tmp_path, monkeypatch):
    """resume restores the state and steps_done together; run skips what the
    checkpoint covers and saves every `every` steps and at the end."""
    seen, saves = [], []
    real_save = ckpt.save

    def spy(path, payload):
        saves.append(payload["steps_done"])
        real_save(path, payload)

    monkeypatch.setattr(ckpt, "save", spy)

    def step(state, item):
        seen.append(item)
        return {"total": state["total"] + item}

    init = {"total": torch.zeros(2, dtype=torch.int64)}
    first = CheckpointedRunner(step, str(tmp_path / "ck"), every=2)
    assert first.resume(init) is init and first.steps_done == 0
    first.run(init, [torch.tensor([1, 1]), torch.tensor([2, 2]), torch.tensor([3, 3])])
    assert first.steps_done == 3 and saves == [2, 3]
    # a killed process: the checkpoint at step 2 is rewritten to model a kill
    # between the save at step 2 and the end
    real_save(str(tmp_path / "ck" / "state"),
              {"state": {"total": torch.tensor([3, 3])}, "steps_done": 2})
    seen.clear()
    saves.clear()
    second = CheckpointedRunner(step, str(tmp_path / "ck"), every=2)
    state = second.resume(init)
    assert second.steps_done == 2 and torch.equal(state["total"], torch.tensor([3, 3]))
    out = second.run(state, [torch.tensor([1, 1]), torch.tensor([2, 2]),
                             torch.tensor([3, 3]), torch.tensor([4, 4])])
    assert [int(x[0]) for x in seen] == [3, 4] and saves == [4, 4]
    assert torch.equal(out["total"], torch.tensor([10, 10]))
    saved = ckpt.restore(str(tmp_path / "ck" / "state"), like={"state": init, "steps_done": 0})
    assert saved["steps_done"] == 4 and torch.equal(saved["state"]["total"], out["total"])
    with pytest.raises(ValueError):
        CheckpointedRunner(step, str(tmp_path / "ck"), every=0)
