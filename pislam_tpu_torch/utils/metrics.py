"""Structured per-frame metrics for keyframe SLAM, and the stage spans.

The port's own copy of ``pislam_tpu/utils/metrics.py``. A registry of
counters, gauges and stage timers that KeyframeSLAM updates every frame and
flushes as JSON lines.

Every stage timer is a span: ``with metrics.timer("track"):`` brackets one
stage of one frame. Its host wall time holds the launches the stage makes
and the waits on the card inside it (a readback, a status check); nothing
synchronizes, so the card's own time per stage is not in it. Under a
``Metrics`` a span adds to ``time_ms.<name>`` and ``calls.<name>``.

While ``torch.profiler`` (or any autograd profiler) is on, every span,
under ``Metrics`` and ``NullMetrics`` alike, also appends one record to a
bounded module-level log: its name, its start and end on ``time.time_ns()``
(the clock of the profiler's own events, so a span lines up with the
launches, copies and idle gaps of the device trace), the index in the log of
the span that encloses it, and its frame id. ``span_log`` reads the log and
clears it. With the profiler off a span costs one check of the profiler's
state; spans add no event to the trace and never synchronize. The log
records the spans of one thread at a time: the SLAM path runs on one.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, NamedTuple, Optional

import torch

SPAN_LOG_CAP = 1 << 18     # records; spans past it are not recorded

_profiling = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """One recorded span. ``end_ns`` is -1 while the span is open;
    ``parent`` is the log index of the enclosing span (-1 at a root);
    ``frame`` the frame id (-1 outside any frame)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    frame: int


_log: list = []     # [name, start_ns, end_ns, parent, frame], in start order
_open: list = []    # (index, record) of the open recorded spans, innermost last


def span_log(clear: bool = False) -> list:
    """The recorded spans as ``Span``s, oldest first; with ``clear`` the log
    starts afresh (spans still open then are not recorded)."""
    out = [Span(*r) for r in _log]
    if clear:
        _log.clear()
        _open.clear()
    return out


class _Timer:
    """A span: records itself while the profiler is on, and adds to a
    ``Metrics``' totals when it has them."""

    __slots__ = ("name", "frame", "totals", "t0", "rec")

    def __init__(self, name: str, frame: Optional[int], totals: Optional[dict]):
        self.name, self.frame, self.totals = name, frame, totals
        self.rec = None

    def __enter__(self):
        if _profiling() and len(_log) < SPAN_LOG_CAP:
            parent, outer = _open[-1] if _open else (-1, None)
            frame = self.frame if self.frame is not None else (
                outer[4] if outer is not None else -1)
            self.rec = [self.name, time.time_ns(), -1, parent, frame]
            _open.append((len(_log), self.rec))
            _log.append(self.rec)
        if self.totals is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.totals is not None:
            tot = self.totals.setdefault(self.name, [0.0, 0])
            tot[0] += time.perf_counter() - self.t0
            tot[1] += 1
        if self.rec is not None:
            self.rec[2] = time.time_ns()
            if _open and _open[-1][1] is self.rec:
                _open.pop()
        return False


class Metrics:
    """Counters + gauges + stage spans with JSON-line emission.

    Counters accumulate (events since the last emit); gauges hold the latest
    value; spans accumulate per-stage wall seconds and call counts between
    emits. ``emit`` writes one JSON line to the sink and resets counters and
    timers (gauges persist: they describe current state, e.g. map size).
    """

    def __init__(self, sink: Optional[Callable[[str], None]] = None):
        self._sink = sink if sink is not None else _stdout_sink
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._timers: dict[str, list] = {}  # name -> [total_s, calls]
        self._t0 = time.perf_counter()

    def count(self, name: str, n: float = 1):
        self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float):
        self._gauges[name] = value

    def timer(self, name: str, frame: Optional[int] = None):
        """The span of stage ``name``; ``frame`` defaults to the enclosing
        span's frame id."""
        return _Timer(name, frame, self._timers)

    def snapshot(self) -> dict:
        """Current values as a flat dict (does not reset)."""
        out = {f"count.{k}": v for k, v in self._counters.items()}
        out.update({f"gauge.{k}": v for k, v in self._gauges.items()})
        for k, (tot, n) in self._timers.items():
            out[f"time_ms.{k}"] = round(tot * 1e3, 3)
            out[f"calls.{k}"] = n
        out["uptime_s"] = round(time.perf_counter() - self._t0, 3)
        return out

    def emit(self, **extra):
        """Write one JSON line (snapshot + extra) and reset counters/timers."""
        rec = self.snapshot()
        rec.update(extra)
        self._sink(json.dumps(rec, sort_keys=True))
        self._counters.clear()
        self._timers.clear()
        return rec


def _stdout_sink(line: str):
    print(line, flush=True)


_NO_SPAN = contextlib.nullcontext()


class NullMetrics(Metrics):
    """No-op drop-in when observability is off; its spans are still
    recorded while the profiler is on."""

    def __init__(self):  # noqa: D401 - no sink
        pass

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def timer(self, name, frame=None):
        return _Timer(name, frame, None) if _profiling() else _NO_SPAN

    def snapshot(self):
        return {}

    def emit(self, **extra):
        return {}
