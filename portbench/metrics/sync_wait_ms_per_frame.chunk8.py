"""Host ms a frame spent in synchronizing CUDA runtime calls inside the
program's spans over the traced chunk-8 window: the host-side duration of every
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, ``cudaMemcpy`` and ``cudaMemcpyAsync`` event of
the profiler's trace that starts inside a span (``spans.SYNC_CALLS``; the
trace's own synchronizes at the window's ends lie outside every span). A
traced-window ms: the profiler slows the host about 2.3x, so it compares
with other traced readings, never with the host clock's metrics."""

from portbench import spans

LAYER = "SLAM orchestration"
UNIT = "ms/frame"
BETTER = "lower"
MOVES = "frames_per_s"


def read(ctx):
    return spans.sync_wait_per_frame(ctx)
