"""Build the Hopper kernels under ``csrc/`` into one shared library, at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one ``.so`` with a
plain C interface, which ``ctypes`` loads. The library lands in
``pislam_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags, so an edited source rebuilds and an unchanged one loads in
milliseconds. The build takes seconds: no source includes PyTorch's headers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
LIB_NAME = "libpislam_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: pointers and the stream as void*, sizes as int. Each
# returns the cudaError_t of its launches (0 = cudaSuccess).
SIGNATURES = {
    "pislam_fused_frontend": (_P, _P, _P, _I, _I, _I, _I, _P),
    "pislam_topk_keys": (_P, _I, _I, _I, _P, _P, _P),
    "pislam_gather_windows": (_P, _I, _I, _P, _P, _P, _I, _P, _P),
    "pislam_orb_select": (_P, _I, _P, _P, _P, _I, _P, _P, _P),
    "pislam_atan2_bins": (_P, _P, _I, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")


def build() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (lib.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures set."""
    if not torch.cuda.is_available():
        raise RuntimeError("the Hopper kernels need a CUDA device")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
