"""pislam-tpu-torch: the ORB extraction frontend of pislam-tpu on PyTorch.

A port of ``pislam_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA
Hopper GPU: pyramid construction, FAST-9 + Harris + NMS, top-k selection,
orientation and rotated BRIEF. The four TPU kernels on that path are CUDA
kernels written for sm_90a (``ops/kernels.py``, ``csrc/``); every kernel has
a plain PyTorch version, which runs on the CPU and is what the kernels are
held to. This package never imports jax.
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

__version__ = "0.1.0"
