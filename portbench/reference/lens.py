"""A configuration's lens: OpenCV's radial-tangential model on the normalised
image plane, and its inverse solved to convergence in float64.

The model has the four terms of the port's ``geometry/camera.py``:

    r2 = x^2 + y^2,  radial = 1 + k1 r2 + k2 r2^2
    x_d = x radial + 2 p1 x y + p2 (r2 + 2 x^2)
    y_d = y radial + p1 (r2 + 2 y^2) + 2 p2 x y

A configuration states it as ``"lens": {"model": "radtan", "k1": ..., "k2":
..., "p1": ..., "p2": ...}``; a lens with any other term (a k3, say) is
refused, since the port would run without it. The renderer bends each
pixel's ray by the inverse, and the reference frontend undoes it on its
points with the same inverse, so neither depends on how the port inverts it.
"""

from __future__ import annotations

import numpy as np

TERMS = ("k1", "k2", "p1", "p2")
TOLERANCE = 1e-9            # normalised units: how far a re-distorted point may miss
_ITERATIONS = 50


def terms(cfg: dict):
    """(k1, k2, p1, p2) of the configuration's lens, or None without one."""
    lens = cfg.get("lens")
    if lens is None:
        return None
    if lens.get("model") != "radtan":
        raise ValueError(f"lens model {lens.get('model')!r}: only 'radtan' "
                         f"({', '.join(TERMS)}) is the port's")
    extra = sorted(set(lens) - {"model", *TERMS})
    if extra:
        raise ValueError(f"lens terms {extra} are not in the port's four-term model "
                         f"({', '.join(TERMS)}): the port would run without them")
    missing = [k for k in TERMS if k not in lens]
    if missing:
        raise ValueError(f"lens terms {missing} missing")
    return tuple(float(lens[k]) for k in TERMS)


def distort(x, y, k1: float, k2: float, p1: float, p2: float):
    """Ideal normalised coordinates -> distorted ones, float64."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    return (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
            y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)


def undistort(xd, yd, k1: float, k2: float, p1: float, p2: float):
    """Distorted normalised coordinates -> ideal ones, float64: Newton's
    method on the model from the distorted point. Raises where a point,
    distorted again, misses its own by more than ``TOLERANCE``."""
    xd, yd = np.asarray(xd, np.float64), np.asarray(yd, np.float64)
    x, y = xd.copy(), yd.copy()
    for _ in range(_ITERATIONS):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dr = 2.0 * (k1 + 2.0 * k2 * r2)          # d radial / d r2, times 2
        gx, gy = distort(x, y, k1, k2, p1, p2)
        ex, ey = gx - xd, gy - yd
        a = radial + x * x * dr + 2.0 * p1 * y + 6.0 * p2 * x     # d x_d / d x
        b = x * y * dr + 2.0 * p1 * x + 2.0 * p2 * y              # d x_d / d y = d y_d / d x
        d = radial + y * y * dr + 6.0 * p1 * y + 2.0 * p2 * x     # d y_d / d y
        det = a * d - b * b
        sx, sy = (d * ex - b * ey) / det, (a * ey - b * ex) / det
        x, y = x - sx, y - sy
        if not np.any(np.abs(sx) + np.abs(sy) > 1e-15):
            break
    gx, gy = distort(x, y, k1, k2, p1, p2)
    miss = np.maximum(np.abs(gx - xd), np.abs(gy - yd))
    if not (miss.size == 0 or np.nanmax(miss) <= TOLERANCE) or not np.isfinite(miss).all():
        raise ValueError(f"the lens does not invert within {TOLERANCE} (misses by "
                         f"{np.nanmax(miss):.3g}): it folds over inside the frame")
    return x, y
