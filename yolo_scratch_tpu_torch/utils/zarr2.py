"""Read one zarr v2 array out of a key-value store (the Zarr v2 storage
specification), as tensorstore writes each leaf of an orbax checkpoint.

An array ``name`` is the JSON ``<name>/.zarray`` (``zarr_format`` 2,
``shape``, ``chunks``, ``dtype``, ``compressor``, ``fill_value``, ``order``,
``filters``, ``dimension_separator``) and one value per chunk under
``<name>/<i>.<j>...`` (a scalar's one chunk is ``<name>/0``). A chunk holds
the whole chunk shape even at the array's edge; a chunk that is not stored
takes the fill value. Handled: byte, integer, float and bool dtypes in either
byte order, C order, no filters, and the ``zstd`` compressor or none.
Anything else raises :class:`ZarrError` naming the array.
"""

from __future__ import annotations

import json
import math
from typing import Any, Protocol

import numpy as np

from yolo_scratch_tpu_torch.utils import zstd


class ZarrError(ValueError):
    """An array that is malformed or uses a feature not handled here."""


class Store(Protocol):
    def get(self, key: str) -> bytes: ...

    def __contains__(self, key: str) -> bool: ...


def _fill(value: Any, dtype: np.dtype) -> Any:
    if value is None:  # no fill value: tensorstore reads unwritten chunks as zeros
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity" for floats
        return float(value.replace("Infinity", "inf"))
    return value


def read_array(store: Store, name: str) -> np.ndarray:
    """The array ``name`` of ``store``, as a writable numpy array in native
    byte order."""
    try:
        meta = json.loads(store.get(f"{name}/.zarray"))
    except KeyError:
        raise ZarrError(f"array {name!r}: no .zarray") from None
    except json.JSONDecodeError as e:
        raise ZarrError(f"array {name!r}: .zarray is not JSON ({e})") from None

    def bad(what: str) -> ZarrError:
        return ZarrError(f"array {name!r}: {what}")

    if meta.get("zarr_format") != 2:
        raise bad(f"zarr_format {meta.get('zarr_format')!r}, not 2")
    if meta.get("order", "C") != "C":
        raise bad(f"order {meta['order']!r} (only C)")
    if meta.get("filters"):
        raise bad(f"filters {meta['filters']!r} (none handled)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise bad(f"compressor {comp!r} (only zstd or none)")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError:
        raise bad(f"dtype {meta['dtype']!r}") from None
    if dtype.kind not in "biuf" or dtype.fields is not None:
        raise bad(f"dtype {meta['dtype']!r} (only bool, int, uint, float)")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise bad(f"chunks {chunks} do not fit shape {shape}")
    sep = meta.get("dimension_separator", ".")
    native = dtype.newbyteorder("=")
    out = np.full(shape, _fill(meta.get("fill_value"), native), dtype=native)
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if idx else "0")
        if key not in store:
            continue
        data = store.get(key)
        if comp is not None:
            try:
                data = zstd.decompress(data)
            except zstd.ZstdError as e:
                raise bad(f"chunk {key!r}: {e}") from e
        if len(data) != chunk_bytes:
            raise bad(f"chunk {key!r} holds {len(data)} bytes, {chunk_bytes} expected")
        block = np.frombuffer(data, dtype=dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    return out
