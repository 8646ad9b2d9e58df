"""Synchronizing calls per frame in the traced per-frame window, as
``torch.cuda.set_sync_debug_mode("warn")`` reports them (each call that
makes the host wait on the card: readbacks, status checks, host copies)."""

LAYER = "SLAM orchestration"
UNIT = "syncs/frame"
BETTER = "lower"
MOVES = "frame_p95_ms"


def read(ctx):
    tr, frames = ctx.get("trace"), ctx.get("frames", 0)
    return tr.syncs / frames if tr is not None and frames else None
