"""Host ms a frame in tracking over the traced chunk-8 window: the program's
``track`` (match and RANSAC), ``map_track`` and ``insert`` spans of the
chunk scan, from ``spans.py``. A traced-window ms: the profiler slows the
host about 2.3x, so it compares with other traced readings, never with
``frames_per_s``."""

from portbench import spans

LAYER = "SLAM orchestration"
UNIT = "ms/frame"
BETTER = "lower"
MOVES = "frames_per_s"


def read(ctx):
    return spans.per_frame_ms(ctx, spans.STAGES["tracking"])
