"""Host ms of one windowed BA over the traced per-frame window: the
program's ``local_ba`` spans over their number, from ``spans.py``. Live's
tail falls on the insert-and-BA frames. A traced-window ms: the profiler
slows the host about 2.3x, so it compares with other traced readings, never
with the host clock's metrics."""

from portbench import spans

LAYER = "Backend"
UNIT = "ms/insert"
BETTER = "lower"
MOVES = "frame_p95_ms"


def read(ctx):
    recs = spans.window_spans(ctx)
    if recs is None:
        return None
    n = sum(1 for r in recs if r.inside and r.name == "local_ba")
    return spans.stage_ms(recs, {"local_ba"}) / n if n else None
