"""ctypes binding for the port's own Zstandard decoder
(``yolo_scratch_tpu_torch/csrc/zstd_decode.cpp``, RFC 8878).

tensorstore compresses every OCDBT manifest, B-tree node and zarr chunk of
an orbax checkpoint as a zstd frame. The decoder is host code, built with
g++ at first use into the port's build directory and linked against nothing
but the C++ runtime, so a checkpoint reads on a machine that has no libzstd,
``zstandard`` or tensorstore. It decodes; it never compresses. There is no
fallback: a frame it cannot decode raises :class:`ZstdError`.
"""

from __future__ import annotations

import ctypes
import threading

from yolo_scratch_tpu_torch.utils.build import BUILD_DIR, PKG, compile_library

SOURCE = PKG / "csrc" / "zstd_decode.cpp"
LIBRARY = BUILD_DIR / "libyst_zstd.so"
_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


class ZstdError(ValueError):
    """A frame that is corrupt, truncated or names a dictionary."""


def load() -> ctypes.CDLL:
    """Build (at first use) and load the decoder."""
    global _lib
    with _lock:
        if _lib is None:
            so = compile_library(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE)],
                                 LIBRARY, [SOURCE], timeout=240)
            lib = ctypes.CDLL(str(so))
            lib.yst_zstd_version.argtypes = []
            lib.yst_zstd_version.restype = ctypes.c_int
            lib.yst_zstd_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_char_p, ctypes.c_size_t]
            lib.yst_zstd_decompress.restype = ctypes.c_int64
            lib.yst_zstd_free.argtypes = [ctypes.c_void_p]
            lib.yst_zstd_free.restype = None
            _lib = lib
    return _lib


def decompress(data: bytes) -> bytes:
    """Decode ``data``: one or more zstd frames, skippable frames among them,
    back to back. Raises :class:`ZstdError` on anything else."""
    lib = load()
    out = ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    n = lib.yst_zstd_decompress(bytes(data), len(data), ctypes.byref(out), err, len(err))
    if n < 0:
        raise ZstdError(err.value.decode(errors="replace"))
    try:
        return ctypes.string_at(out.value, n)
    finally:
        lib.yst_zstd_free(out)
