"""ctypes binding for the native host pipeline (``csrc/yst_host.cpp``: image
decode + letterbox on a thread pool), the port's own copy of
``yolo_scratch_tpu/data/native.py``.

The library is compiled with g++ at first use into the port's build
directory (never into ``csrc/``). There is no cv2 fallback: if it cannot be
built, :func:`prepare_batch` and :func:`decode_file` raise with the
compiler's output, and :func:`available` says False (the dataset readers
then decode through cv2 or PIL, as the JAX package's do).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from yolo_scratch_tpu_torch.utils.build import BUILD_DIR, PKG, compile_library

_SOURCE = PKG.parent / "csrc" / "yst_host.cpp"
_lib: ctypes.CDLL | None = None
_load_error: Exception | None = None


def load() -> ctypes.CDLL:
    """Build (at first use) and load the host library."""
    global _lib
    if _lib is not None:
        return _lib
    if not _SOURCE.exists():
        raise RuntimeError(f"host library source {_SOURCE} not found")
    so = compile_library(
        ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SOURCE),
         "-lpng", "-ljpeg", "-lz", "-pthread"],
        BUILD_DIR / "libyst_host.so", [_SOURCE], timeout=240)
    lib = ctypes.CDLL(str(so))
    lib.yst_version.restype = ctypes.c_int
    if lib.yst_version() < 2:  # the fast_jpeg argument arrived in v2
        raise RuntimeError(f"{so}: host library ABI older than v2")
    args = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint8, ctypes.c_int, ctypes.c_int,
    ]
    outs = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]
    lib.yst_prepare_batch.argtypes = [*args, ctypes.POINTER(ctypes.c_float), *outs]
    lib.yst_prepare_batch.restype = None
    lib.yst_prepare_batch_u8.argtypes = [*args, ctypes.POINTER(ctypes.c_uint8), *outs]
    lib.yst_prepare_batch_u8.restype = None
    lib.yst_decode_file.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.yst_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.yst_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library builds and loads here (tried once)."""
    global _load_error
    if _lib is None and _load_error is None:
        try:
            load()
        except (RuntimeError, OSError) as e:  # no compiler, no libpng/libjpeg
            _load_error = e
    return _lib is not None


def decode_file(path: str, channels: int = 1) -> np.ndarray:
    """Decode one PNG/JPEG -> (h, w, channels) uint8."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = lib.yst_decode_file(str(path).encode(), channels, ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        raise IOError(f"native decode failed: {path}")
    n = w.value * h.value * channels
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(h.value, w.value, channels)
    lib.yst_free(ptr)
    return arr


def prepare_batch(
    paths: Sequence[str],
    img_size: int,
    channels: int = 1,
    letterbox: bool = False,
    pad_value: int = 114,
    threads: int = 4,
    dtype: str = "float32",
    fast_jpeg: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode + resize ``paths`` -> (imgs (N, S, S, C) ``dtype`` — uint8, or
    float32 in [0, 1] — meta (N, 5) [w, h, scale, px, py], status (N,)).

    ``fast_jpeg`` decodes JPEGs at the smallest libjpeg M/8 scale covering
    the canvas (DCT-domain downscale; pixels differ slightly from a full
    decode + bilinear resize). PNGs are unaffected."""
    lib = load()
    n = len(paths)
    meta = np.empty((n, 5), np.float32)
    status = np.empty((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    common = (c_paths, n, img_size, channels, int(letterbox), pad_value, threads,
              int(fast_jpeg))
    tail = (meta.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if dtype == "uint8":
        out = np.empty((n, img_size, img_size, channels), np.uint8)
        lib.yst_prepare_batch_u8(*common, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 *tail)
    elif dtype == "float32":
        out = np.empty((n, img_size, img_size, channels), np.float32)
        lib.yst_prepare_batch(*common, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              *tail)
    else:
        raise ValueError(f"dtype {dtype!r}: 'uint8' or 'float32'")
    return out, meta, status
