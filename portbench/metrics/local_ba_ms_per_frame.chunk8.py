"""Host ms a frame in boundary BA over the traced chunk-8 window: the
program's ``local_ba`` and ``retriangulate`` spans, one inside another
counted once, from ``spans.py``. A traced-window ms: the profiler slows the
host about 2.3x, so it compares with other traced readings, never with
``frames_per_s``."""

from portbench import spans

LAYER = "Backend"
UNIT = "ms/frame"
BETTER = "lower"
MOVES = "frames_per_s"


def read(ctx):
    return spans.per_frame_ms(ctx, spans.STAGES["local_ba"])
