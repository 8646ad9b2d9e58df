"""ctypes bindings for the native PNG runtime (``native/pislam_io.cpp``).

The port's own copy of ``pislam_tpu/io/native.py``: it builds the same C++
source with the same g++ line, into the port's git-ignored build directory
(``pislam_tpu_torch/_build/io/``), at first use. Where the toolchain or
libpng is missing it falls back to PIL for PNG decoding and encoding, so the
package stays importable everywhere. This is host I/O; nothing here touches
the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
SRC = _REPO / "native" / "pislam_io.cpp"
BUILD_DIR = _REPO / "pislam_tpu_torch" / "_build" / "io"
SO = BUILD_DIR / "libpislam_io.so"

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a process that loads the
    # library never sees a half-written file
    tmp = SO.with_name(f"{SO.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", str(SRC), "-o", str(tmp),
           "-lpng", "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, SO)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib():
    """Load (building if needed) the native library, or None on failure."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not SO.exists() or SO.stat().st_mtime < SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(SO))
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
            return None
        lib.pio_read_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
        lib.pio_read_png.restype = ctypes.c_int
        lib.pio_write_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
        lib.pio_write_png.restype = ctypes.c_int
        lib.pio_free.argtypes = [ctypes.c_void_p]
        lib.pio_free.restype = None
        lib.pio_stream_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
        lib.pio_stream_open.restype = ctypes.c_void_p
        lib.pio_stream_len.argtypes = [ctypes.c_void_p]
        lib.pio_stream_len.restype = ctypes.c_int
        lib.pio_stream_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.pio_stream_next.restype = ctypes.c_int
        lib.pio_stream_close.argtypes = [ctypes.c_void_p]
        lib.pio_stream_close.restype = None
        _lib = lib
        return _lib


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 grayscale."""
    lib = get_lib()
    if lib is None:
        from PIL import Image
        return np.asarray(Image.open(path).convert("L"))
    data = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_uint32()
    h = ctypes.c_uint32()
    rc = lib.pio_read_png(os.fsencode(path), ctypes.byref(data),
                          ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"pio_read_png({path}) failed: {rc}")
    try:
        arr = np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    finally:
        lib.pio_free(ctypes.cast(data, ctypes.c_void_p))
    return arr


def write_png(path: str, img: np.ndarray):
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got shape {img.shape}")
    lib = get_lib()
    if lib is None:
        from PIL import Image
        Image.fromarray(img, "L").save(path)
        return
    h, w = img.shape
    rc = lib.pio_write_png(os.fsencode(path),
                           img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           w, h, img.strides[0])
    if rc != 0:
        raise IOError(f"pio_write_png({path}) failed: {rc}")


class FrameStream:
    """Background-prefetched PNG frame stream (fixed size, ring buffer).

    Decode runs in a native thread so it overlaps the card's work. Iterating
    yields (H, W) uint8 frames in path order; a decode error or a frame of
    another size raises.
    """

    def __init__(self, paths, width: int, height: int, capacity: int = 8):
        self._handle = None
        self._paths = [os.fspath(p) for p in paths]
        self._w, self._h = width, height
        self._lib = get_lib()
        self._idx = 0
        if self._lib is not None:
            joined = "\n".join(self._paths).encode()
            self._handle = self._lib.pio_stream_open(joined, width, height, capacity)
            if not self._handle:
                raise IOError("pio_stream_open failed")

    def __len__(self):
        return len(self._paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            out = np.empty((self._h, self._w), np.uint8)
            rc = self._lib.pio_stream_next(
                self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            if rc == 1:
                raise StopIteration
            if rc != 0:
                raise IOError(f"frame decode failed (rc={rc})")
            return out
        # PIL fallback
        if self._idx >= len(self._paths):
            raise StopIteration
        img = read_png(self._paths[self._idx])
        self._idx += 1
        if img.shape != (self._h, self._w):
            raise IOError(f"frame size {img.shape} != {(self._h, self._w)}")
        return img

    def close(self):
        if self._handle is not None:
            self._lib.pio_stream_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
