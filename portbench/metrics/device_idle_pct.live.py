"""Device idle share of the traced per-frame window: 1 minus the union of the
device operations' intervals over the window's wall seconds."""

LAYER = "Device"
UNIT = "%"
BETTER = "lower"
MOVES = "frame_p95_ms"


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_pct() if tr is not None and tr.device_ops else None
