"""A read-only OCDBT key-value store (tensorstore's "OCDBT on-disk format"),
as orbax writes one under every checkpoint directory.

The database is a directory holding ``manifest.ocdbt`` and data files under
``d/`` (a multi-process checkpoint has one sub-database per process,
``ocdbt.process_<i>/``, whose data files the root's B-tree names by path).

* Every manifest and B-tree node is framed: magic (uint32 big-endian), the
  frame's length (uint64 little-endian), format version (varint, 0),
  compression (varint: 0 none, 1 zstd), the body, and a CRC-32C of all the
  bytes before it (uint32 little-endian).
* The manifest's body is the config (uuid, manifest kind, inline value
  limit, node size limit, version tree arity, node compression) and, for a
  manifest of kind "single", the newest versions of the tree inline: a data
  file table, then per version its generation number, root height, root
  node reference (data file, offset, length), statistics and commit time.
  The newest version is the last; older ones (in version tree nodes) are
  never needed to read the data.
* A B-tree node's body is its height, a data file table and its entries,
  column by column. Keys are prefix-coded against the previous key. A leaf
  entry holds its value inline or as (data file, offset, length); an
  interior entry holds a child reference and the length of its subtree's
  common key prefix, which the child's keys omit.

Values are read with ``os.pread`` on file descriptors the store keeps open
until :meth:`OcdbtStore.close`. Anything malformed raises :class:`OcdbtError`
naming the file (and the key, for a value).
"""

from __future__ import annotations

import os
import struct
from bisect import bisect_left
from pathlib import Path
from typing import Dict, List, Tuple, Union

from yolo_scratch_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE


class OcdbtError(ValueError):
    """A database that is malformed or that this reader does not handle."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        crc = t[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Sequential reads of a decoded body; any overrun raises."""

    def __init__(self, data: bytes, where: str):
        self.d, self.p, self.where = data, 0, where

    def fail(self, what: str) -> OcdbtError:
        return OcdbtError(f"{self.where}: {what} (byte {self.p})")

    def u8(self) -> int:
        if self.p >= len(self.d):
            raise self.fail("truncated")
        self.p += 1
        return self.d[self.p - 1]

    def varint(self) -> int:
        r = shift = 0
        d, p = self.d, self.p
        while True:
            if p >= len(d) or shift > 63:
                self.p = p
                raise self.fail("truncated or overlong varint")
            c = d[p]
            p += 1
            r |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                self.p = p
                return r

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.d):
            raise self.fail(f"truncated ({n} bytes wanted)")
        self.p += n
        return self.d[self.p - n:self.p]

    def data_file_table(self) -> List[str]:
        n = self.varint()
        prefix = self.varints(max(n - 1, 0))
        suffix = self.varints(n)
        self.varints(n)  # base path lengths: the path is base + relative, read whole
        paths, prev = [], b""
        for i in range(n):
            keep = prefix[i - 1] if i else 0
            if keep > len(prev):
                raise self.fail("data file path prefix longer than the previous path")
            prev = prev[:keep] + self.take(suffix[i])
            paths.append(prev.decode())
        return paths

    def keys(self, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
        prefix = self.varints(max(n - 1, 0))
        suffix = self.varints(n)
        common = self.varints(n) if interior else []
        keys, prev = [], b""
        for i in range(n):
            keep = prefix[i - 1] if i else 0
            if keep > len(prev):
                raise self.fail("key prefix longer than the previous key")
            prev = prev[:keep] + self.take(suffix[i])
            keys.append(prev)
        return keys, common


def _unframe(raw: bytes, magic: int, where: str) -> bytes:
    """The decoded body of one manifest or node frame."""
    if len(raw) < 18:
        raise OcdbtError(f"{where}: truncated ({len(raw)} bytes)")
    got, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if got != magic:
        raise OcdbtError(f"{where}: bad magic {got:#010x} (want {magic:#010x})")
    if length != len(raw):
        raise OcdbtError(f"{where}: frame says {length} bytes, {len(raw)} read")
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise OcdbtError(f"{where}: CRC-32C mismatch")
    c = _Cursor(raw[:-4], where)
    c.p = 12
    if c.varint() != 0:
        raise OcdbtError(f"{where}: unknown format version")
    comp = c.varint()
    body = raw[c.p:-4]
    if comp == 0:
        return body
    if comp == 1:
        try:
            return zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{where}: {e}") from e
    raise OcdbtError(f"{where}: unknown compression {comp}")


# a value: inline bytes, or (data file path, offset, length)
Value = Union[bytes, Tuple[str, int, int]]


class OcdbtStore:
    """The newest version of the OCDBT database under ``root``: ``list``
    its keys, ``get`` a value. Close it (or use it as a context manager) to
    release the data files it opened."""

    def __init__(self, root):
        self.root = Path(root)
        self._fds: Dict[str, int] = {}
        self._values: Dict[str, Value] = {}
        self._sorted: List[str] = []
        try:
            self._load()
        except BaseException:
            self.close()
            raise

    # -- reading ---------------------------------------------------------

    def _pread(self, path: str, offset: int, length: int, what: str) -> bytes:
        fd = self._fds.get(path)
        if fd is None:
            try:
                fd = os.open(self.root / path, os.O_RDONLY)
            except OSError as e:
                raise OcdbtError(f"{self.root / path}: {e.strerror} ({what})") from e
            self._fds[path] = fd
        data = os.pread(fd, length, offset)
        if len(data) != length:
            raise OcdbtError(f"{self.root / path}: {length} bytes at {offset} wanted, "
                             f"{len(data)} read ({what})")
        return data

    def _load(self) -> None:
        where = str(self.root / "manifest.ocdbt")
        try:
            raw = (self.root / "manifest.ocdbt").read_bytes()
        except OSError as e:
            raise OcdbtError(f"{where}: {e.strerror}") from e
        c = _Cursor(_unframe(raw, MANIFEST_MAGIC, where), where)
        c.take(16)  # uuid
        kind = c.varint()
        c.varint()  # max inline value bytes
        c.varint()  # max decoded node bytes
        c.u8()  # version tree arity (log2)
        node_comp = c.varint()
        if node_comp == 1:
            c.take(4)  # zstd level
        elif node_comp != 0:
            raise c.fail(f"unknown node compression {node_comp}")
        if kind != 0:
            raise c.fail(f"manifest kind {kind} (numbered manifests) is not read here")
        files = c.data_file_table()
        n = c.varint()
        if n == 0:
            return  # no version yet: an empty database
        c.varints(n)  # generation numbers
        heights = [c.u8() for _ in range(n)]
        fid, off, length = c.varints(n), c.varints(n), c.varints(n)
        num_keys = c.varints(n)
        if num_keys[-1] == 0:
            return
        if fid[-1] >= len(files):
            raise c.fail("root node names a data file that is not in the table")
        self._walk(files[fid[-1]], off[-1], length[-1], heights[-1], b"")
        if len(self._values) != num_keys[-1]:
            raise OcdbtError(f"{where}: {len(self._values)} keys found, the manifest "
                             f"counts {num_keys[-1]}")
        self._sorted = sorted(self._values)

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        where = f"{self.root / path} (node at {offset}, {length} bytes)"
        c = _Cursor(_unframe(self._pread(path, offset, length, "B-tree node"), NODE_MAGIC,
                             where), where)
        if c.u8() != height:
            raise c.fail(f"node height differs from its reference's {height}")
        files = c.data_file_table()
        n = c.varint()
        keys, common = c.keys(n, interior=height > 0)
        if height > 0:
            fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
            for i in range(n):
                if fid[i] >= len(files):
                    raise c.fail("child names a data file that is not in the table")
                if common[i] > len(keys[i]):
                    raise c.fail("subtree prefix longer than its key")
                self._walk(files[fid[i]], off[i], ln[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        vlen = c.varints(n)
        kinds = c.varints(n)
        nind = sum(1 for k in kinds if k)
        fid, off = c.varints(nind), c.varints(nind)
        j = 0
        for key, ln, k in zip(keys, vlen, kinds):
            name = (prefix + key).decode()
            if k == 0:
                self._values[name] = c.take(ln)
            elif k == 1:
                if fid[j] >= len(files):
                    raise c.fail(f"value of {name!r} names a data file not in the table")
                self._values[name] = (files[fid[j]], off[j], ln)
                j += 1
            else:
                raise c.fail(f"value of {name!r} has unknown kind {k}")
        if c.p != len(c.d):
            raise c.fail("bytes after the last value")

    # -- public ----------------------------------------------------------

    def list(self, prefix: str = "") -> List[str]:
        """The keys that start with ``prefix``, sorted."""
        keys = self._sorted
        i = bisect_left(keys, prefix)
        out = []
        while i < len(keys) and keys[i].startswith(prefix):
            out.append(keys[i])
            i += 1
        return out

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def get(self, key: str) -> bytes:
        """The value of ``key``; KeyError when there is none."""
        v = self._values[key]
        if isinstance(v, bytes):
            return v
        path, offset, length = v
        return self._pread(path, offset, length, f"value of {key!r}")

    def close(self) -> None:
        for fd in self._fds.values():
            os.close(fd)
        self._fds.clear()

    def __enter__(self) -> "OcdbtStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
