"""A read-only OCDBT key-value store: the format tensorstore writes under
an orbax checkpoint (``manifest.ocdbt``, ``d/<hex>``).

The layout follows tensorstore's "OCDBT on-disk format"
(``tensorstore/kvstore/ocdbt/format/``).  Every manifest and B-tree node
is framed the same way::

    magic        uint32 big-endian: 0x0cdb3a2a (manifest), 0x0cdb20de (node)
    length       uint64 little-endian, the whole framed length
    version      varint, 0
    compression  varint, 0 (none) or 1 (zstd, through ``io/zstd.py``)
    body         (compressed as said)
    crc32c       uint32 little-endian, of every byte before it

Integers are LEB128 varints unless named, and arrays are stored column by
column (all of one field, then all of the next).

* Manifest body: the config (uuid[16], manifest kind, max inline value
  bytes, max decoded node bytes, version tree arity log2 (uint8),
  compression method, and with zstd its level as an int32), a data file
  table, the newest versions inline (generation, root height (uint8),
  root node file id / offset / length, the root's key count, tree bytes
  and indirect value bytes, commit time (uint64)), then the references to
  the version tree nodes that hold older versions.  The store reads the
  newest inline version; older versions are not read.
* Data file table: count, the shared prefix length of each path with the
  previous one (count - 1 of them), each suffix length, each base path
  length, then the suffixes.  A path is relative to the directory that
  holds the manifest (``ocdbt.process_0/d/<hex>`` from an orbax item's
  root).
* B-tree node body: height (uint8), its own data file table, the entry
  count, each key's prefix length shared with the previous key (count - 1
  of them) and suffix length, then (interior nodes) each child's subtree
  common prefix length, the key suffixes, and either each child's file id /
  offset / length / key count / tree bytes / indirect value bytes
  (interior) or each value's length, its kind (0 inline, 1 a reference
  into a data file), each reference's file id and offset, and the inline
  values back to back (leaf).  A child's keys are stored without the
  common prefix its parent's entry names.

Nothing is returned for a tree it cannot read: a bad magic, an unknown
version or compression, a checksum mismatch, a truncated node or value and
a missing data file raise, naming the file.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple, Union

from . import zstd

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
# the smallest framed file: magic, length, one-byte version and compression
# varints, crc32c
_MIN_FRAMED = 18
_NO_NODE = 2**64 - 1  # the offset and length of an empty tree's missing root


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT checksums its files."""
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Bound-checked reads from a decoded body; ``where`` names the file."""

    def __init__(self, buf: bytes, where: str):
        self.buf, self.pos, self.where = buf, 0, where

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.where}: truncated OCDBT body ({len(self.buf)} bytes, "
                             f"{self.pos + n} needed)")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.where}: varint longer than 10 bytes")
        if value >= 2**64:
            raise ValueError(f"{self.where}: varint past 64 bits")
        return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"{self.where}: {len(self.buf) - self.pos} bytes left after the "
                             "body (an unknown OCDBT layout)")


def _unframe(raw: bytes, magic: int, where: str) -> bytes:
    """The decoded body of a framed manifest or node, after every check."""
    what = "manifest" if magic == _MANIFEST_MAGIC else "B-tree node"
    if len(raw) < _MIN_FRAMED:
        raise ValueError(f"{where}: truncated OCDBT {what} ({len(raw)} bytes)")
    found, length = struct.unpack(">I", raw[:4])[0], struct.unpack("<Q", raw[4:12])[0]
    if found != magic:
        raise ValueError(f"{where}: not an OCDBT {what} (magic {raw[:4].hex()}, "
                         f"expected {magic:08x})")
    if length != len(raw):
        raise ValueError(f"{where}: truncated OCDBT {what}: its header says {length} bytes, "
                         f"{len(raw)} were read")
    head = _Reader(raw[12:-4], where)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{where}: OCDBT {what} version {version}, this reader knows 0")
    compression = head.varint()
    if crc32c(raw[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"{where}: OCDBT {what} checksum mismatch (a corrupted file)")
    body = raw[12 + head.pos:-4]
    if compression == 1:
        return bytes(zstd.decompress(body))
    if compression != 0:
        raise ValueError(f"{where}: OCDBT {what} compression {compression}, this reader "
                         "knows 0 (none) and 1 (zstd)")
    return body


def _data_files(r: _Reader) -> List[str]:
    """A data file table: each file's path (base path and relative path
    joined), checked to stay inside the store."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: where each path's base ends, not needed to open it
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.where}: data file path prefix {p} past the previous path")
        prev = prev[:p] + r.take(s)
        path = prev.decode("utf-8")
        if path.startswith("/") or ".." in path.split("/"):
            raise ValueError(f"{r.where}: data file path {path!r} leaves the store")
        paths.append(path)
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's keys (prefix-decoded) and, in an interior node, each
    child's subtree common prefix length."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"{r.where}: key prefix {p} past the previous key")
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    for key, c in zip(keys, common):
        if c > len(key):
            raise ValueError(f"{r.where}: subtree prefix {c} past its key")
    return keys, common


_Ref = Tuple[str, int, int]  # (path in the store, offset, length)


class OcdbtStore:
    """The newest version of an OCDBT database under ``directory`` (which
    holds its ``manifest.ocdbt``): ``keys()`` and ``read(key)``.  The whole
    B-tree is read when the store opens; values stored by reference are
    read from their data files on ``read``.  ``bytes_read`` counts the
    bytes of every file read so far."""

    def __init__(self, directory: str):
        self.directory = directory
        self.bytes_read = 0
        self._values: Dict[str, Union[bytes, _Ref]] = {}
        body = _unframe(self._file(MANIFEST, 0, None), _MANIFEST_MAGIC, self._where(MANIFEST))
        self._read_manifest(_Reader(body, self._where(MANIFEST)))

    def _where(self, path: str) -> str:
        return os.path.join(self.directory, path)

    def _file(self, path: str, offset: int, length) -> bytes:
        """``length`` bytes at ``offset`` of a file of the store (all of it
        where ``length`` is None); a short read raises."""
        full = self._where(path)
        if not os.path.isfile(full):
            raise FileNotFoundError(f"{full}: OCDBT file missing")
        with open(full, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"{full}: truncated OCDBT file: {length} bytes at offset "
                             f"{offset} asked, {len(data)} there")
        self.bytes_read += len(data)
        return data

    def _read_manifest(self, r: _Reader) -> None:
        r.take(16)  # uuid
        kind = r.varint()
        r.varints(2)  # max inline value bytes, max decoded node bytes
        r.u8()  # version tree arity log2
        method = r.varint()
        if method == 1:
            r.take(4)  # zstd level, int32
        elif method != 0:
            raise ValueError(f"{r.where}: config compression method {method} unknown")
        if kind != 0:
            raise ValueError(f"{r.where}: manifest kind {kind} (numbered manifests): this "
                             "reader reads single-file manifests only")
        files = _data_files(r)
        n = r.varint()
        r.varints(n)  # generation numbers
        heights = list(r.take(n))
        file_ids, offsets, lengths, num_keys = (r.varints(n) for _ in range(4))
        r.varints(2 * n)  # tree bytes and indirect value bytes
        r.take(8 * n)  # commit times
        m = r.varint()  # references to version tree nodes of older versions
        r.varints(5 * m)  # generation, file id, offset, length, generation count
        r.take(8 * m)  # commit times
        r.take(m)  # heights
        r.end()
        if n == 0:
            raise ValueError(f"{r.where}: the manifest holds no version")
        if offsets[-1] == _NO_NODE and lengths[-1] == _NO_NODE:
            return  # an empty tree
        ref = self._ref(files, file_ids[-1], offsets[-1], lengths[-1], r.where)
        self._walk(ref, heights[-1], b"")
        if len(self._values) != num_keys[-1]:
            raise ValueError(f"{r.where}: the newest version holds {num_keys[-1]} keys, its "
                             f"tree {len(self._values)}")

    @staticmethod
    def _ref(files: List[str], file_id: int, offset: int, length: int, where: str) -> _Ref:
        if file_id >= len(files):
            raise ValueError(f"{where}: data file id {file_id} of a table of {len(files)}")
        return files[file_id], offset, length

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        path, offset, length = ref
        where = f"{self._where(path)} at {offset}"
        r = _Reader(_unframe(self._file(path, offset, length), _NODE_MAGIC, where), where)
        if r.u8() != height:
            raise ValueError(f"{where}: B-tree node height differs from its parent's entry")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            file_ids, offsets, lengths = (r.varints(n) for _ in range(3))
            r.varints(3 * n)  # each child's key count, tree bytes and indirect value bytes
            r.end()
            for key, c, f, o, ln in zip(keys, common, file_ids, offsets, lengths):
                self._walk(self._ref(files, f, o, ln, where), height - 1, prefix + key[:c])
            return
        sizes = r.varints(n)
        kinds = r.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{where}: value kind {max(kinds)} unknown")
        indirect = [i for i, k in enumerate(kinds) if k]
        file_ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {i: self._ref(files, f, o, sizes[i], where)
                for i, f, o in zip(indirect, file_ids, offsets)}
        for i, key in enumerate(keys):
            self._values[(prefix + key).decode("utf-8")] = refs[i] if kinds[i] else r.take(sizes[i])
        r.end()

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        """The value of ``key``; raises ``KeyError`` naming the store where
        there is none."""
        if key not in self._values:
            raise KeyError(f"{self.directory}: OCDBT store has no key {key!r}")
        value = self._values[key]
        return value if isinstance(value, bytes) else self._file(*value)
