"""Frames a second over the traced per-frame window: the frames that
``process`` returned in it over the window's wall seconds, the profiler's
slowing included. Live's ``frames_per_s`` on the host's clock spreads with
the card machine's host speed beyond any bound the gate allows, so live
reports its rate here, beside the other traced readings; it compares with
them, never with chunk8's ``frames_per_s``."""

LAYER = "Service and housekeeping"
UNIT = "frames/s"
BETTER = "higher"
MOVES = "frame_p95_ms"


def read(ctx):
    tr, frames = ctx.get("trace"), ctx.get("frames")
    if tr is None or not frames or tr.window_s <= 0:
        return None
    return frames / tr.window_s
