"""Host ms a frame in the session's housekeeping over the traced chunk-8
window: the program's ``cull_keyframes``, ``cull``, ``evict_stale`` and
``compact`` spans, from ``spans.py`` (0 in a window without housekeeping).
A traced-window ms: the profiler slows the host about 2.3x, so it compares
with other traced readings, never with ``frames_per_s``."""

from portbench import spans

LAYER = "Service and housekeeping"
UNIT = "ms/frame"
BETTER = "lower"
MOVES = "frames_per_s"


def read(ctx):
    return spans.per_frame_ms(ctx, spans.STAGES["housekeeping"])
