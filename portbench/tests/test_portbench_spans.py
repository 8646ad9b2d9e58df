"""The per-stage readers (``spans.py`` and ``metrics/*_ms_per_*``) on a
synthetic span log and trace, against values worked out by hand; ``None``
with nothing to read and with a program that has no span log."""

import pytest

from portbench import harness, spans
from pislam_tpu_torch.utils import metrics as program
from pislam_tpu_torch.utils.metrics import Span

# (name, start us, end us, parent, frame); two frames, 8 and 9
LOG = [
    ("process_chunk", 2000, 80000, -1, 8),     # 0
    ("scan_chunk", 2100, 60000, 0, 8),         # 1
    ("extract", 3000, 8000, 1, 8),             # 2: 5 ms
    ("pyramid", 3100, 4000, 2, 8),             # 3
    ("track", 8000, 12000, 1, 8),              # 4: 4
    ("map_track", 12000, 14000, 1, 8),         # 5: 2
    ("insert", 14000, 15000, 1, 8),            # 6: 1
    ("extract", 20000, 26000, 1, 9),           # 7: 6
    ("track", 26000, 29000, 1, 9),             # 8: 3
    ("map_track", 29000, 30000, 1, 9),         # 9: 1
    ("insert", 30000, 31000, 1, 9),            # 10: 1
    ("readback", 50000, 60000, 1, 8),          # 11
    ("insert_ba", 60000, 79000, 0, 8),         # 12
    ("local_ba", 60000, 70000, 12, 8),         # 13: 10
    ("retriangulate", 70000, 79000, 12, 8),    # 14: 9
    ("local_ba", 72000, 79000, 14, 8),         # 15: 7, inside 14
    ("cull_keyframes", 82000, 84000, -1, -1),  # 16: 2
    ("compact", 84000, 85000, -1, -1),         # 17: 1
    ("extract", 200000, 210000, -1, 10),       # 18: after the window
]
HOST = [
    ("aten::first", 1000, 10),
    ("cudaLaunchKernel", 3500, 5),             # inside extract / pyramid
    ("cudaMemcpyAsync", 55000, 4000),          # readback: 4 ms
    ("cudaStreamSynchronize", 65000, 1000),    # local_ba: 1 ms
    ("cudaLaunchKernelExC", 81000, 5),         # outside every span
    ("cudaEventSynchronize", 90000, 500),      # outside every span
    ("cudaDeviceSynchronize", 100000, 900),    # the trace's own, outside
    ("aten::last", 100990, 10),
]


class FakeTrace:
    host_ops = HOST
    device_ops = [("k", 1000, 100), ("k", 40000, 100)]
    window_s = 0.1
    syncs = 3


@pytest.fixture
def ctx(monkeypatch):
    log = [Span(n, int(a * 1000), int(b * 1000), p, f) for n, a, b, p, f in LOG]
    monkeypatch.setattr(program, "span_log", lambda clear=False: list(log))
    return {"trace": FakeTrace(), "frames": 2}


WANT = {
    "frontend_ms_per_frame.chunk8": (5 + 6) / 2,
    "tracking_ms_per_frame.chunk8": (4 + 2 + 1 + 3 + 1 + 1) / 2,
    "tracking_ms_per_frame.live": (4 + 2 + 1 + 3 + 1 + 1) / 2,
    "local_ba_ms_per_frame.chunk8": (10 + 9) / 2,       # 15 lies inside 14
    "housekeeping_ms_per_frame.chunk8": (2 + 1) / 2,
    "local_ba_ms_per_insert.live": (10 + 7) / 2,        # two local_ba spans
    "sync_wait_ms_per_frame.chunk8": (4 + 1) / 2,
    "sync_wait_ms_per_frame.live": (4 + 1) / 2,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_by_hand(ctx, name):
    assert harness.load_reader(name).read(ctx) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_spans(ctx, name, monkeypatch):
    reader = harness.load_reader(name)
    assert reader.read({}) is None
    monkeypatch.setattr(program, "span_log", lambda clear=False: [])
    assert reader.read(ctx) is None                 # no span in the window
    monkeypatch.delattr(program, "span_log")
    assert reader.read(ctx) is None                 # a program without spans


def test_traced_frames_per_s(ctx):
    """The traced window's frames over its wall seconds; nothing without
    a trace or frames."""
    reader = harness.load_reader("traced_frames_per_s.live")
    assert reader.read(ctx) == pytest.approx(2 / 0.1)
    assert reader.read({"trace": FakeTrace()}) is None
    assert reader.read({"frames": 2}) is None


def test_breakdown(ctx):
    out = spans.breakdown(ctx)
    assert out["window_ms_per_frame"] == pytest.approx(50.0)
    assert out["groups_ms_per_frame"] == pytest.approx(
        {"frontend": 5.5, "tracking": 6.0, "local_ba": 9.5, "housekeeping": 1.5})
    assert out["groups_share_of_window"] == pytest.approx(22.5 / 50)
    assert (out["kernel_launches"], out["kernel_launches_in_spans"]) == (2, 1)
    assert out["extract_spans"] == 2
    assert out["stages"]["extract"]["launches"] == pytest.approx(0.5)
    assert out["stages"]["readback"]["sync_wait_ms"] == pytest.approx(2.0)
    assert out["stages"]["local_ba"]["ms"] == pytest.approx(8.5)
    assert out["sync_wait_ms_per_frame"] == pytest.approx(2.5)
    assert (out["syncs_per_frame"], out["host_syncs_per_frame"]) == (1.0, 1.5)
    (gap,) = out["idle_gaps"]
    assert gap["span"] == "extract" and gap["frame"] == 9
    assert gap["ms"] == pytest.approx((40000 - 1100) / 1e3)
