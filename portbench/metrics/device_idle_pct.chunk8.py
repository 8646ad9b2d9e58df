"""Device idle share of the traced chunk-8 window: 1 minus the union of the
device operations' intervals over the window's wall seconds."""

LAYER = "Device"
UNIT = "%"
BETTER = "lower"
MOVES = "frames_per_s"


def read(ctx):
    tr = ctx.get("trace")
    return tr.idle_pct() if tr is not None and tr.device_ops else None
