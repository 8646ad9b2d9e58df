"""Host ms a frame in tracking over the traced per-frame window: the
program's ``track`` (match, RANSAC and the inlier readback), ``map_track``
and ``insert`` spans of ``process``, from ``spans.py``. A traced-window ms:
the profiler slows the host about 2.3x, so it compares with other traced
readings, never with the host clock's metrics."""

from portbench import spans

LAYER = "SLAM orchestration"
UNIT = "ms/frame"
BETTER = "lower"
MOVES = "frame_p95_ms"


def read(ctx):
    return spans.per_frame_ms(ctx, spans.STAGES["tracking"])
