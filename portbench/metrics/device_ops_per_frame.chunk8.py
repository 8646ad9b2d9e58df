"""Device operations (kernels, copies, memsets) per frame in the traced
chunk-8 window, from the profiler's trace."""

LAYER = "SLAM orchestration"
UNIT = "ops/frame"
BETTER = "lower"
MOVES = "frames_per_s"


def read(ctx):
    tr, frames = ctx.get("trace"), ctx.get("frames", 0)
    return len(tr.device_ops) / frames if tr is not None and frames and tr.device_ops else None
