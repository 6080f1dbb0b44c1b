"""ctypes binding for the port's native host pipeline
(``yolo_scratch_tpu_torch/csrc/yst_host.cpp``: image decode + letterbox on a
thread pool), the counterpart of ``yolo_scratch_tpu/data/native.py``.

The library is the port's own: its PNG decoder (``yst_png.cpp`` over the
inflate of ``yst_inflate.cpp``) and JPEG decoder (``yst_jpeg.cpp``) give the
bytes that the JAX tier's libpng and libjpeg-turbo give, and it links no
codec library, so it builds wherever g++ does (the card's machine too). It
is compiled at first use into the port's build directory. There is no cv2
fallback inside: if it cannot be built, :func:`prepare_batch` and
:func:`decode_file` raise with the compiler's output, and :func:`available`
says False (callers then decode through cv2 or PIL, as the JAX package's do).
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

from yolo_scratch_tpu_torch.utils.build import BUILD_DIR, PKG, compile_library

CSRC = PKG / "csrc"
SOURCES = [CSRC / f for f in ("yst_host.cpp", "yst_inflate.cpp", "yst_png.cpp", "yst_jpeg.cpp")]
HEADERS = [CSRC / "yst_codecs.h"]
LIBRARY = BUILD_DIR / "libyst_host.so"
OBJ_DIR = BUILD_DIR / "libyst_host.obj"
_lib: ctypes.CDLL | None = None
_load_error: Exception | None = None


def build() -> Path:
    """Compile the sources (one g++ each, started together) and link them
    into ``LIBRARY``; each step is skipped while its output is newer than
    its inputs."""
    missing = [str(p) for p in SOURCES + HEADERS if not p.exists()]
    if missing:
        raise RuntimeError(f"host library sources not found: {missing}")

    def compile_one(src: Path) -> Path:
        return compile_library(["g++", "-O3", "-fPIC", "-std=c++17", "-c", str(src)],
                               OBJ_DIR / f"{src.stem}.o", [src, *HEADERS], timeout=240)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        objs = list(pool.map(compile_one, SOURCES))
    return compile_library(["g++", "-shared", *map(str, objs), "-pthread"], LIBRARY, objs,
                           timeout=120)


def load() -> ctypes.CDLL:
    """Build (at first use) and load the host library."""
    global _lib
    if _lib is not None:
        return _lib
    so = build()
    lib = ctypes.CDLL(str(so))
    lib.yst_version.restype = ctypes.c_int
    if lib.yst_version() < 3:  # v3: the port's own codecs, yst_decode_memory
        raise RuntimeError(f"{so}: host library ABI older than v3")
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
    lib.yst_decode_memory.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.yst_decode_memory.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.yst_inflate.restype = ctypes.c_int
    lib.yst_inflate.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
                                ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.yst_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the host library builds and loads here (tried once)."""
    global _load_error
    if _lib is None and _load_error is None:
        try:
            load()
        except (RuntimeError, OSError) as e:  # no compiler
            _load_error = e
    return _lib is not None


def _take(lib, ptr, w, h, channels: int) -> np.ndarray:
    n = w.value * h.value * channels
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy().reshape(h.value, w.value, channels)
    lib.yst_free(ptr)
    return arr


def decode_file(path: str, channels: int = 1) -> np.ndarray:
    """Decode one PNG/JPEG -> (h, w, channels) uint8."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = lib.yst_decode_file(str(path).encode(), channels, ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        raise IOError(f"native decode failed: {path}")
    return _take(lib, ptr, w, h, channels)


def decode_bytes(data: bytes, channels: int = 1, scale_num: int = 8) -> np.ndarray:
    """Decode PNG/JPEG bytes -> (h, w, channels) uint8; a JPEG at
    ``scale_num``/8 of its size (libjpeg's scaled IDCT), a PNG at full size.

    Every file the JAX tier's libjpeg-turbo and libpng decode, with their
    bytes: Huffman or arithmetic-coded JPEGs, sequential or progressive
    (block-smoothed where a progressive file ends early), and PNGs of any
    type with their gAMA, sRGB, cHRM, iCCP and sBIT chunks applied as
    libpng's simplified API applies them. A file they refuse raises
    ``IOError`` here too."""
    lib = load()
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = lib.yst_decode_memory(bytes(data), len(data), channels, scale_num, ctypes.byref(w),
                                ctypes.byref(h))
    if not ptr:
        raise IOError("native decode failed")
    return _take(lib, ptr, w, h, channels)


INFLATE_STATUS = ("ok", "bad adler32", "truncated", "bad data", "out of room")


def inflate(data: bytes, limit: int) -> Tuple[str, bytes]:
    """Inflate one zlib stream into at most ``limit`` bytes -> (status, out),
    status one of :data:`INFLATE_STATUS`."""
    lib = load()
    out = ctypes.create_string_buffer(max(limit, 1))
    n = ctypes.c_size_t()
    st = lib.yst_inflate(bytes(data), len(data), out, limit, ctypes.byref(n))
    return INFLATE_STATUS[st], out.raw[: n.value]


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

    ``fast_jpeg`` decodes JPEGs at the smallest M/8 scale covering the
    canvas (the scaled IDCTs of libjpeg-turbo; pixels differ slightly from a
    full decode + bilinear resize). PNGs are unaffected."""
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
