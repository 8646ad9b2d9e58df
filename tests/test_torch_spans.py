"""The stage spans of ``pislam_tpu_torch/utils/metrics.py`` on the SLAM path,
on the CPU at tests/test_torch_slam_scan.py's size (eval_seq, 384x256, a
16-slot ring, a keyframe every 3 frames).

* With the profiler off nothing is recorded, under ``Metrics`` or
  ``NullMetrics``.
* Under ``torch.profiler`` a chunk of 8 tracked frames records one
  ``extract`` (with its ``pyramid``), ``track``, ``map_track`` and
  ``insert`` per frame with the frame's id, and one ``process_chunk``,
  ``scan_chunk`` and ``readback``, each under its parent.
* ``process`` records ``insert`` and ``local_ba`` inside ``insert_ba`` on
  an insert frame.
* The spans' ``time.time_ns()`` stamps share the profiler's clock: no
  operator event the profiler records crosses a span's start or end, and
  each span holds the events of the calls inside it.
"""

import bisect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pislam_tpu_torch as pt
from pislam_tpu_torch.utils.metrics import Metrics, NullMetrics, span_log
from test_torch_slam import slam_config
from torch_parity import DATA, port_config

SEED = 7
PER_FRAME = ("extract", "pyramid", "track", "map_track", "insert")


@pytest.fixture(scope="module")
def seq():
    d = np.load(DATA / "eval_seq.npz")
    return d["frames"][:16], tuple(float(d[k]) for k in ("fx", "fy", "cx", "cy"))


def port_slam(intr, metrics):
    return pt.KeyframeSLAM(port_config(slam_config()), *intr, keyframe_min_inliers=60,
                           keyframe_max_gap=3, seed=SEED, device="cpu", metrics=metrics)


def profiled(fn):
    """(fn's result, the spans it recorded, the profiler's operator events)."""
    span_log(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = span_log(clear=True)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::")]
    return out, spans, events


def children(spans, i):
    return [s for s in spans if s.parent == i]


def only(spans, name):
    (i,) = [i for i, s in enumerate(spans) if s.name == name]
    return i


@pytest.fixture(scope="module")
def chunk(seq):
    """The second chunk of 8 (every frame tracked) under the profiler."""
    frames, intr = seq
    slam = port_slam(intr, Metrics(sink=lambda line: None))
    slam.process_chunk(frames[:8])
    _, spans, events = profiled(lambda: slam.process_chunk(frames[8:]))
    return spans, events


@pytest.mark.parametrize("metrics", [Metrics, NullMetrics])
def test_no_spans_without_profiler(seq, metrics):
    frames, intr = seq
    span_log(clear=True)
    m = metrics() if metrics is NullMetrics else metrics(sink=lambda line: None)
    slam = port_slam(intr, m)
    for f in frames[:4]:
        slam.process(f)
    slam.process_chunk(frames[4:8])
    assert span_log() == []
    if metrics is Metrics:
        snap = m.snapshot()
        assert snap["calls.process"] == 4 and snap["calls.process_chunk"] == 1
        assert snap["calls.extract"] == 8 and snap["calls.pyramid"] == 8


def test_chunk_spans(chunk):
    spans, _ = chunk
    assert all(s.end_ns >= s.start_ns for s in spans)
    root = only(spans, "process_chunk")
    assert spans[root].parent == -1 and spans[root].frame == 8
    scan = only(spans, "scan_chunk")
    assert spans[scan].parent == root and spans[scan].frame == 8
    readback = only(spans, "readback")
    assert spans[readback].parent == scan
    for name in PER_FRAME:
        got = [s for s in spans if s.name == name]
        assert sorted(s.frame for s in got) == list(range(8, 16)), name
        for s in got:
            if name == "pyramid":
                assert spans[s.parent].name == "extract" and spans[s.parent].frame == s.frame
            else:
                assert s.parent == scan, name
    for s in spans:                     # every span inside its parent
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    assert {s.name for s in spans} <= {"process_chunk", "scan_chunk", "readback", *PER_FRAME,
                                       "insert_ba", "local_ba", "retriangulate", "relocalise"}
    for s in spans:
        if s.name in ("local_ba", "retriangulate"):
            assert spans[s.parent].name == "insert_ba" and spans[s.parent].parent == root


def test_process_spans(seq):
    frames, intr = seq
    slam = port_slam(intr, NullMetrics())
    outs, spans, _ = profiled(lambda: [slam.process(f) for f in frames[:5]])
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in roots] == ["process"] * 5
    assert [spans[i].frame for i in roots] == list(range(5))
    boot = [s.name for s in children(spans, roots[0])]
    assert boot == ["extract", "insert"]         # the bootstrap: no tracking, no BA
    inserted = [k for k in range(1, 5) if outs[k]["keyframe"]]
    assert inserted
    for k in range(1, 5):
        names = [s.name for s in children(spans, roots[k])]
        assert names[:2] == ["extract", "track"], names
        assert ("insert_ba" in names) == (k in inserted)
    for k in inserted:
        (iba,) = [i for i in range(len(spans)) if spans[i].name == "insert_ba"
                  and spans[i].parent == roots[k]]
        assert [s.name for s in children(spans, iba)] == ["insert", "local_ba"]
        assert all(s.frame == k for s in children(spans, iba))
    for s in spans:
        if s.name == "pyramid":
            assert spans[s.parent].name == "extract"


def _crossing(spans, events):
    """Operator events that start before a span's stamp and end after it."""
    stamps = sorted(t for s in spans for t in (s.start_ns, s.end_ns))
    out = []
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        j = bisect.bisect_right(stamps, a)
        if j < len(stamps) and stamps[j] < b:
            out.append((e.name(), a, b, stamps[j]))
    return out


def test_spans_share_the_profilers_clock(chunk):
    spans, events = chunk
    assert events and not _crossing(spans, events)
    starts = sorted(e.start_ns() for e in events)
    for s in spans:                      # each span holds its calls' events
        assert bisect.bisect_left(starts, s.end_ns) > bisect.bisect_left(starts, s.start_ns), s
    a = torch.ones(64, 64)

    def probe():
        with NullMetrics().timer("probe"):
            torch.mm(a, a)
        torch.mm(a, a)

    _, (span,), events = profiled(probe)
    mm = sorted((e for e in events if e.name() == "aten::mm"), key=lambda e: e.start_ns())
    assert len(mm) == 2
    assert span.start_ns <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= span.end_ns
    assert mm[1].start_ns() >= span.end_ns
