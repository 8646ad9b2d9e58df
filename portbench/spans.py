"""The program's stage spans over a traced window, and the per-stage
reductions that the readers in ``metrics/`` share.

The port records its spans (``pislam_tpu_torch/utils/metrics.py``) while the
profiler is on: a name, a start and an end on ``time.time_ns()`` (the clock
of the profiler's events), the enclosing span and a frame id. A span holds
the host's time in a stage: the launches it made and the waits on the card
inside it. These readers run only in a ``--trace 1`` run, where the profiler
slows the host about 2.3x: every ms they read is a traced-window ms, which
compares with other traced readings and never with ``frames_per_s``.

A program without spans (one older than them) gives no span log, and every
reading is then ``None``.

    python3 portbench/spans.py --workload tum_fr1_vga.chunk8 --seed 7

prints one traced window's breakdown by stage (``breakdown``) as JSON.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

# host runtime calls that wait on the card (or may: a pageable copy)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync"})
# host runtime calls that launch a kernel, and all that put work on the card's stream
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
LAUNCH_CALLS = KERNEL_LAUNCHES + ("cudaMemcpyAsync", "cudaMemsetAsync")
# the four stage groups that make a chunk's host time, by the spans they read
STAGES = {"frontend": ("extract",),
          "tracking": ("track", "map_track", "insert"),
          "local_ba": ("local_ba", "retriangulate"),
          "housekeeping": ("cull_keyframes", "cull", "evict_stale", "compact")}


class Rec(NamedTuple):
    name: str
    start: float       # us, the trace's clock
    end: float
    parent: int        # index in the log, -1 at a root
    frame: int
    inside: bool       # within the traced window


def window_spans(ctx):
    """Every span of the program's log, in us, with ``inside`` set on those
    within the trace's window (the first to the last host operation of
    ``ctx["trace"]``); ``None`` without a trace, without a span log, or
    with no span inside the window."""
    tr = ctx.get("trace")
    if tr is None or not tr.host_ops:
        return None
    try:
        from pislam_tpu_torch.utils.metrics import span_log
    except ImportError:
        return None
    lo = min(s for _, s, _ in tr.host_ops)
    hi = max(s + d for _, s, d in tr.host_ops)
    recs = []
    for s in span_log():
        a, b = s.start_ns / 1e3, s.end_ns / 1e3
        recs.append(Rec(s.name, a, b, s.parent, s.frame, s.end_ns >= 0 and lo <= a and b <= hi))
    return recs if any(r.inside for r in recs) else None


def _outermost(recs, names):
    """The spans inside the window named in ``names`` that no other span of
    ``names`` encloses."""
    out = []
    for r in recs:
        if not r.inside or r.name not in names:
            continue
        p = r.parent
        while p >= 0 and recs[p].name not in names:
            p = recs[p].parent
        if p < 0:
            out.append(r)
    return out


def stage_ms(recs, names):
    """Host ms in the spans of ``names``, a span inside another of them
    counted once."""
    return sum(r.end - r.start for r in _outermost(recs, names)) / 1e3


def per_frame_ms(ctx, names):
    """``stage_ms`` over the traced window's frames."""
    recs, frames = window_spans(ctx), ctx.get("frames", 0)
    if recs is None or not frames:
        return None
    return stage_ms(recs, set(names)) / frames


def _union(intervals):
    """Sorted disjoint (start, end) covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _covered(union, t):
    j = bisect.bisect_right(union, [t, float("inf")]) - 1
    return j >= 0 and union[j][0] <= t <= union[j][1]


def sync_wait_ms(recs, host_ops):
    """Host ms of the synchronizing runtime calls (``SYNC_CALLS``) that start
    inside a span."""
    union = _union((r.start, r.end) for r in recs if r.inside)
    return sum(d for n, s, d in host_ops if n in SYNC_CALLS and _covered(union, s)) / 1e3


def sync_wait_per_frame(ctx):
    recs, frames = window_spans(ctx), ctx.get("frames", 0)
    if recs is None or not frames:
        return None
    return sync_wait_ms(recs, ctx["trace"].host_ops) / frames


def breakdown(ctx, top: int = 10) -> dict:
    """One traced window by stage, per frame: each span name's host ms
    (outermost), calls, launches (``LAUNCH_CALLS`` starting inside it),
    syncs (``SYNC_CALLS``) and sync-wait ms; the four stage groups and their
    share of the window's host ms a frame; the synchronizing calls inside
    spans beside the sync-debug mode's count; the share of kernel launches
    inside some span; and the ``top`` longest idle gaps of the device, each
    under the innermost span covering its middle, beside the shortest host
    operation there."""
    tr, frames = ctx["trace"], ctx["frames"]
    recs = window_spans(ctx) or []
    inside = [r for r in recs if r.inside]
    host = tr.host_ops
    stages = {}
    for name in sorted({r.name for r in inside}):
        union = _union((r.start, r.end) for r in inside if r.name == name)
        launches = sum(1 for n, s, _ in host if n.startswith(LAUNCH_CALLS) and _covered(union, s))
        syncs = [d for n, s, d in host if n in SYNC_CALLS and _covered(union, s)]
        stages[name] = {"ms": stage_ms(recs, {name}) / frames,
                        "calls": sum(1 for r in inside if r.name == name) / frames,
                        "launches": launches / frames, "syncs": len(syncs) / frames,
                        "sync_wait_ms": sum(syncs) / 1e3 / frames}
    window_ms = 1e3 * tr.window_s / frames
    groups = {g: stage_ms(recs, set(n)) / frames for g, n in STAGES.items()}
    every = _union((r.start, r.end) for r in inside)
    kernel_launches = [s for n, s, _ in host if n.startswith(KERNEL_LAUNCHES)]
    in_span = sum(1 for s in kernel_launches if _covered(every, s))

    gaps, end = [], None
    for _, s, d in tr.device_ops:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(reverse=True)
    by_gap = []
    for length, a, b in gaps[:top]:
        mid = (a + b) / 2
        cover = [r for r in inside if r.start <= mid <= r.end]
        span = max(cover, key=lambda r: r.start) if cover else None
        ops = [o for o in host if o[1] <= mid <= o[1] + o[2]]
        op = min(ops, key=lambda o: o[2])[0] if ops else "host (no recorded op)"
        by_gap.append({"ms": length / 1e3, "span": span.name if span else "outside any span",
                       "frame": span.frame if span else -1, "host_op": op[:120]})
    return {"frames": frames, "window_ms_per_frame": window_ms, "stages": stages,
            "groups_ms_per_frame": groups,
            "groups_share_of_window": sum(groups.values()) / window_ms,
            "sync_wait_ms_per_frame": sync_wait_ms(recs, host) / frames if recs else None,
            "syncs_per_frame": sum(1 for n, s, _ in host if n in SYNC_CALLS
                                   and _covered(every, s)) / frames,
            "host_syncs_per_frame": tr.syncs / frames,
            "kernel_launches": len(kernel_launches),
            "kernel_launches_in_spans": in_span,
            "extract_spans": sum(1 for r in inside if r.name == "extract"),
            "idle_gaps": by_gap}


def main(argv=None):
    """A traced window of a cell on the card, as ``run.py --trace 1`` makes
    it, and its breakdown as one JSON line."""
    import argparse
    import json
    import os
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path[0] = str(root)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    cache = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    from pislam_tpu_torch.ops import _build
    from portbench import harness, run
    from portbench.trace import Trace

    spec = harness.load_spec()
    cell = {w["name"]: w for w in spec["workloads"]}[args.workload]
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    _build.load()
    stream = harness.Stream(cfg, mix, args.seed, "cuda:0")
    slam = harness.build_slam(cfg, args.seed, "cuda:0")
    sess = harness.Session(slam, stream, mix)
    res = run.run_tracking(slam, sess, mix, args.seconds, Trace, "cuda:0")
    print(json.dumps(dict(breakdown(res["ctx"]), workload=args.workload, seed=args.seed)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
