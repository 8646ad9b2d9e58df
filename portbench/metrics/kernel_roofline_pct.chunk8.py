"""The port's main-path CUDA kernels (K1 ``fused_frontend_codes``, K2
``topk_keys``, ``orb_describe`` and K5 ``match_reduce``) against their
roofline over the traced chunk-8 window: the sum of each launch's least time
over the sum of their device times in the profiler's trace.

Least times come from ``roofline.py`` and the launch's shapes: K1 and K2 on
the stacked pyramid; ``orb_describe`` at the mean bound of the window's
keyframes (their codes and angles, as the reference computes them); K5 once
per frame at keypoints x keypoints (the match against the last keyframe)
and once per frame at keypoints x landmark slots (map tracking), and any
further launch (relocalisation) at the smaller shape, so that the share is
never counted high."""

from portbench import roofline

LAYER = "Kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "frames_per_s"


def read(ctx):
    tr, frames = ctx.get("trace"), ctx.get("frames", 0)
    if tr is None or not frames or ctx.get("describe_bound_s") is None:
        return None
    cfg, (h, w) = ctx["cfg"], ctx["pyramid"]
    k, lm = cfg["max_keypoints"], ctx.get("landmark_slots", 8192)
    dev_s, least_s = 0.0, 0.0
    for name, fn in roofline.KERNELS.items():
        durs = tr.kernel_ops(fn)
        if not durs:
            continue
        dev_s += sum(durs) / 1e6
        n = len(durs)
        if name == "fused_frontend_codes":
            least_s += n * roofline.k1_bound(h, w)
        elif name == "topk_keys":
            least_s += n * roofline.k2_bound(((h + 1) // 2) * ((w + 1) // 2), k)
        elif name == "orb_describe":
            least_s += n * ctx["describe_bound_s"]
        else:
            n_map = min(frames, n // 2)
            least_s += (n_map * roofline.k5_bound(k, lm, 8)
                        + (n - n_map) * roofline.k5_bound(k, k, 8))
    return 100.0 * least_s / dev_s if dev_s else None
