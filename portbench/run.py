#!/usr/bin/env python3
"""The benchmark of ``pislam_tpu_torch``: one run of one cell, on one card.

    python3 portbench/run.py --workload tum_fr1_vga.chunk8 --seed 1 \\
        --seconds 30 --trace 0

A cell (``BENCHMARK.json``'s ``workloads``) is a deployment
(``configs/<config>.json``) under a traffic mix (``traffic/<mix>.json``).
A run builds the port's kernels (or loads them from their cache in the
checkout), renders the cell's frames on the card from the seed, builds the
service's ``KeyframeSLAM`` and warms it up on the cell's own traffic, then
measures for ``--seconds``. With ``--trace 0`` it reports the cell's
end-to-end metrics; with ``--trace 1`` it profiles a shorter window
(``TRACE_SECONDS``) and reports the per-layer metrics, read by
``metrics/<name>.py``. Either way it then checks what the window produced
against the plain references (``check.py``) and prints one JSON line last
on standard output.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the port, or if JAX or the JAX package was
loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the root, not this directory, leads the path: portbench's modules are
# imported as a package and never shadow a library's
if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
    sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "pislam_tpu")
TRACE_SECONDS = 4.0     # the profiled window: 40-50 frames under the profiler, reduced in seconds


def forbidden_modules(names=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``pislam_tpu_torch`` is the port, not the package)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _parser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def quantile95(values):
    """The 95th percentile (Python's inclusive quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_tracking(slam, sess, mix, seconds, trace_cls, device):
    """Warm-up and the window of a chunk or frame mix. Besides the metrics,
    ``info`` says what the window held: the keyframes and landmarks held as
    it opened, the keyframes inserted in it, and the median step with and
    without an insert, so that a run that reads slower can be told to have
    done more work or the same work in more time."""
    while sess.k < mix["warmup_frames"]:
        sess.step()
    _sync(device)
    first, lost0, kf0 = sess.k, slam.frames_lost, slam.keyframes_inserted
    info = {"keyframes_held_at_open": slam.num_keyframes,
            "landmarks_at_open": slam.num_landmarks}
    out = {"setup_s": time.perf_counter() - T_START, "first": first}
    if trace_cls is not None:
        with trace_cls() as tr:
            end = time.perf_counter() + min(seconds, TRACE_SECONDS)
            while time.perf_counter() < end:
                sess.step()
        out["ctx"] = {"trace": tr, "frames": sess.k - first}
    else:
        lat, done, quarters = [], 0, [0, 0, 0, 0]
        steps = {True: [], False: []}       # step seconds, with and without an insert
        start = time.perf_counter()
        end = start + seconds
        while True:
            t_in = time.perf_counter()
            if t_in >= end:
                break
            kf = slam.keyframes_inserted
            n, dt = sess.step()
            if t_in + dt <= end:          # poses on the host inside the window
                lat.extend([dt] * n)
                done += n
                quarters[min(3, int(4 * (t_in + dt - start) / seconds))] += n
                steps[slam.keyframes_inserted > kf].append(dt)
        out["frames_per_s"] = done / seconds
        out["frame_p95_ms"] = quantile95(lat) * 1e3 if lat else None
        if lat:
            info.update({"latency_median_ms": statistics.median(lat) * 1e3,
                         "latency_max_ms": max(lat) * 1e3,
                         "frames_per_s_by_quarter": [4 * q / seconds for q in quarters]})
        for insert, name in ((True, "step_ms_median_insert"),
                             (False, "step_ms_median_no_insert")):
            if steps[insert]:
                info[name] = statistics.median(steps[insert]) * 1e3
    info["keyframes_inserted"] = slam.keyframes_inserted - kf0
    out["info"] = info
    out["attempted"] = sess.k - first
    out["failed"] = slam.frames_lost - lost0
    return out


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            cfg=None, mix=None, spec=None):
    """One run of a cell on ``device``; returns the result line's dict.
    ``cfg`` and ``mix`` replace the cell's files (the CPU tests run a
    cell's code path at a small size)."""
    import torch

    from portbench import check, harness
    from portbench.trace import Trace

    spec = spec or harness.load_spec()
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    cfg = cfg or harness.load_json("configs", cell["config"])
    mix = mix or harness.load_json("traffic", cell["traffic"])
    limits = check.load_limits(workload)
    e2e_names, layer_names = harness.cell_metrics(spec, workload)
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    device = torch.device(device)
    on_card = device.type == "cuda"

    setup = {}
    if on_card:
        from pislam_tpu_torch.ops import _build
        setup["kernels_compiled"] = not _build.library_path().exists()
        t = time.perf_counter()
        _build.load()
        setup["kernel_build_s"] = time.perf_counter() - t
    stream = harness.Stream(cfg, mix, seed, device)
    setup["textures"] = stream.textures
    slam = harness.build_slam(cfg, seed, device)
    sess = harness.Session(slam, stream, mix)
    trace_cls = Trace if trace else None
    res = run_tracking(slam, sess, mix, seconds, trace_cls, device)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    bad = forbidden_modules()
    if bad:
        raise ImportError(f"the run loaded {bad}")

    # -- correctness: after the window, the peak read ----------------------
    numbers = {}
    matcher = {"max_distance": slam.cfg.matcher.max_distance,
               "ratio": slam.cfg.matcher.ratio, "cross_check": slam.cfg.matcher.cross_check}
    with torch.no_grad():
        nums, refs = check.map_checks(slam.state, stream, cfg, matcher, res["first"], device)
        numbers.update(nums)
        window = {k: v for k, v in sess.poses.items() if k >= res["first"]}
        numbers.update(check.pose_checks(window, stream))
    verdict = check.judge(numbers, limits)

    if trace:
        fe = check.reference_frontend(cfg, device)
        ctx = dict(res["ctx"], cfg=cfg, pyramid=(fe.padded_height, fe.stride),
                   landmark_slots=slam.cfg.map.max_landmarks,
                   describe_bound_s=check.describe_bounds(refs, fe.padded_height, fe.stride))
        metrics = {}
        for name in layer_names:
            v = harness.load_reader(name).read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    else:
        metrics = {n: {"value": res[n], "unit": units[n]} for n in e2e_names
                   if res.get(n) is not None}
    out = {"correct": all(ok for *_, ok in verdict), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": {"platform": "gpu" if on_card else device.type,
                      "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)},
           "setup": setup}
    if trace:
        tr = res["ctx"]["trace"]
        out["device"].update({"busy_s": tr.busy_s(), "window_s": tr.window_s})
        out["breakdown"] = {"device_ops": tr.by_name(), "idle_gaps": tr.idle_gaps()}
    out["info"] = dict(res.get("info", {}),
                       **{k: v for k, v in numbers.items() if k not in limits})
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in verdict}
    return out


def main(argv=None):
    args = _parser().parse_args(argv)
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"portbench: {args.workload} needs {cells[args.workload]['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        out = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      spec=spec)
    except ImportError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        lo, hi = c["limit"]
        ok = c["value"] is not None and lo <= c["value"] <= hi
        print(f"check {name} {c['value']} limit [{lo}, {hi}] {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
