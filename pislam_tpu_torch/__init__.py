"""pislam-tpu-torch: the ORB frontend, visual odometry and keyframe SLAM of
pislam-tpu on PyTorch.

A port of ``pislam_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
Hopper GPU: pyramid construction, FAST-9 + Harris + NMS, top-k selection,
orientation and rotated BRIEF, Hamming matching, RANSAC essential and
frame-to-frame pose chaining, and keyframe SLAM (map tracking, keyframe
insertion with windowed bundle adjustment, the chunked device-resident
tracking scan, the E/H homography bootstrap, map housekeeping, pose graph,
loop closure, multi-session map merging and checkpoints), the SLAM service
(``service.py``: frame sources, checkpoint/resume, TUM and PLY export, on
``io/`` and ``parallel/elastic.CheckpointedRunner``), the demo
(``demo.py``) and the distributed layer on ``torch.distributed``
(``parallel/``: the (data, model) mesh, the sharded match over the landmark
map and the keyframe store behind ``KeyframeSLAM(mesh=...)``, distributed
bundle adjustment, data-parallel streams, the multi-process bootstrap and a
dry run). The TPU kernels are CUDA kernels
written for sm_90a (``ops/kernels.py``, ``csrc/``); every kernel has a plain
PyTorch version, which runs on the CPU and is what the kernels are held to.
Entry points run on the card unless given ``device="cpu"`` (``--cpu`` for
the service and the demo, which this package does not import). This package
never imports jax.
"""

from .config import (  # noqa: F401
    BAConfig,
    FrontendConfig,
    MapConfig,
    MatcherConfig,
    MeshConfig,
    PislamConfig,
    PyramidConfig,
    VOConfig,
)
from .frontend import (  # noqa: F401
    Features,
    OrbExtractor,
    extract_single_level,
    make_extract_fn,
    tables_from_numpy,
)
from .geometry import homography  # noqa: F401
from .matching import match, match_features, match_gated, match_many  # noqa: F401
from .models.slam import KeyframeSLAM, SlamState, slam_state_from_numpy  # noqa: F401
from .models.slam_scan import make_slam_track_scan  # noqa: F401
from .models.visual_odometry import (  # noqa: F401
    VisualOdometry,
    VOState,
    make_vo_scan,
    vo_state_from_numpy,
)

__version__ = "0.1.0"
