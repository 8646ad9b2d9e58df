"""Host I/O: native PNG reading and writing, a prefetching frame stream,
dataset layouts (image directories, TUM-RGBD, KITTI) and TUM / PLY export."""

from .native import FrameStream, read_png, write_png  # noqa: F401
