"""Build the Hopper kernels under ``csrc/`` into one shared library, at first use.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one process per source,
all started together, and links the objects into one ``.so`` with a plain C
interface, which ``ctypes`` loads. The library lands in
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: pointers and the stream as void*, sizes as int. Each
# returns the cudaError_t of its launches (0 = cudaSuccess).
SIGNATURES = {
    "pislam_fused_frontend": (_P, _P, _P, _I, _I, _I, _I, _P),
    "pislam_topk_keys": (_P, _I, _I, _I, _P, _P, _P),
    "pislam_gather_windows": (_P, _I, _I, _P, _P, _P, _I, _P, _P),
    "pislam_orb_select": (_P, _I, _P, _P, _P, _I, _P, _P, _P),
    "pislam_atan2_bins": (_P, _P, _I, _P, _P),
    "pislam_match_reduce": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _F, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P),
    "pislam_reduce_codes": (_P, _I, _I, _P, _P),
    "pislam_orb_select_dense": (_P, _I, _P, _I, _P, _P, _P),
    "pislam_realign_windows": (_P, _P, _P, _I, _P, _P),
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
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = lib.parent / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.name} ({proc.returncode}):\n{out[-3000:]}")
    tmp = lib.with_name(f"{LIB_NAME}.{tag}")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                               *(str(obj) for obj, _ in jobs)],
                              capture_output=True, text=True, check=False)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr[-3000:]}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (lib.parent / "nvcc.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
