"""A reader of the HDF5 files that the packed datasets are, in numpy alone.

The card's machine has no ``h5py``, so the port reads the packs itself.
It takes what h5py writes with its default (earliest) file format: a
version 0 or 1 superblock, a root group held in a symbol table (a
version 1 B-tree of symbol nodes and a local heap), version 1 object
headers with continuation blocks, and datasets of little-endian integers
or floats stored contiguous or chunked (a version 1 B-tree of
chunks) through the deflate and shuffle filters (the format
specification, "HDF5 File Format Specification Version 2.0", sections
II-IV). Anything else raises ``NotImplementedError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOLS = (
    0x1, 0x3, 0x8, 0xB, 0x10, 0x11)


class _File:
    def __init__(self, data: bytes):
        self.data = data
        if data[:8] != _SIGNATURE:
            raise ValueError("not an HDF5 file")
        version = data[8]
        if version not in (0, 1):
            raise NotImplementedError(f"HDF5 superblock version {version}")
        self.size_o, self.size_l = data[13], data[14]
        if (self.size_o, self.size_l) != (8, 8):
            raise NotImplementedError(f"HDF5 offsets of {self.size_o} bytes")
        pos = 24 + (4 if version == 1 else 0)
        self.base = self.u64(pos)
        # the base address and three more; then the root group's
        # symbol table entry, whose object header address is its second field
        self.root = self.u64(pos + 32 + 8)

    def u64(self, pos: int) -> int:
        return struct.unpack_from("<Q", self.data, pos)[0]

    def at(self, addr: int) -> int:
        return self.base + addr

    def messages(self, addr: int) -> list[tuple[int, int, int]]:
        """(type, start, size) of every message of a version 1 header."""
        pos = self.at(addr)
        if self.data[pos] != 1:
            raise NotImplementedError(f"HDF5 object header version {self.data[pos]}")
        count, _, size = struct.unpack_from("<HII", self.data, pos + 2)
        blocks, out = [(pos + 16, size)], []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            p = start
            while p + 8 <= start + length and len(out) < count:
                kind, msize = struct.unpack_from("<HH", self.data, p)
                out.append((kind, p + 8, msize))
                if kind == _CONTINUATION:
                    blocks.append((self.at(self.u64(p + 8)), self.u64(p + 16)))
                p += 8 + msize
        return out

    def btree(self, addr: int, ndims: int = 0):
        """Leaf entries of a version 1 B-tree: (key bytes, child address)
        for a chunk tree (``ndims`` > 0), child addresses for a group."""
        pos = self.at(addr)
        if self.data[pos:pos + 4] != b"TREE":
            raise ValueError("corrupt HDF5 B-tree")
        level = self.data[pos + 5]
        used = struct.unpack_from("<H", self.data, pos + 6)[0]
        key_size = 8 + 8 * ndims if ndims else self.size_l
        p = pos + 24 + key_size  # past the signature, siblings and the first key
        for i in range(used):
            child = self.u64(p)
            key = self.data[p - key_size:p]
            if level > 0:
                yield from self.btree(child, ndims)
            else:
                yield (key, child) if ndims else child
            p += 8 + key_size

    def group(self, addr: int) -> dict[str, int]:
        """Names -> object header addresses of the links of a group."""
        found = [m for m in self.messages(addr) if m[0] == _SYMBOLS]
        if not found:
            raise NotImplementedError("HDF5 group without a symbol table")
        tree, heap = self.u64(found[0][1]), self.u64(found[0][1] + 8)
        hpos = self.at(heap)
        if self.data[hpos:hpos + 4] != b"HEAP":
            raise ValueError("corrupt HDF5 local heap")
        names = self.at(self.u64(hpos + 24))
        links = {}
        for snod in self.btree(tree):
            spos = self.at(snod)
            if self.data[spos:spos + 4] != b"SNOD":
                raise ValueError("corrupt HDF5 symbol node")
            count = struct.unpack_from("<H", self.data, spos + 6)[0]
            for e in range(count):
                entry = spos + 8 + 40 * e
                off = names + self.u64(entry)
                name = self.data[off:self.data.index(b"\0", off)].decode()
                links[name] = self.u64(entry + 8)
        return links

    def dataset(self, addr: int) -> np.ndarray | None:
        """The array of a dataset's object header; None for a group."""
        msgs = {kind: (start, size) for kind, start, size in self.messages(addr)}
        if _DATASPACE not in msgs or _LAYOUT not in msgs:
            return None
        shape = self._shape(msgs[_DATASPACE][0])
        dtype = self._dtype(msgs[_DATATYPE][0])
        filters = self._filters(msgs[_FILTERS][0]) if _FILTERS in msgs else []
        pos = msgs[_LAYOUT][0]
        if self.data[pos] != 3:
            raise NotImplementedError(f"HDF5 layout version {self.data[pos]}")
        layout, pos = self.data[pos + 1], pos + 2
        count = int(np.prod(shape))
        if layout == 1:  # contiguous
            start = self.u64(pos)
            if start == _UNDEFINED:
                return np.zeros(shape, dtype)
            return np.frombuffer(self.data, dtype, count, self.at(start)).reshape(shape).copy()
        if layout != 2:
            raise NotImplementedError(f"HDF5 layout class {layout}")
        ndims = self.data[pos] - 1
        tree = self.u64(pos + 1)
        chunk = struct.unpack_from(f"<{ndims}I", self.data, pos + 9)
        out = np.zeros(shape, dtype)
        if tree == _UNDEFINED:
            return out
        for key, child in self.btree(tree, ndims + 1):
            nbytes, mask = struct.unpack_from("<II", key)
            offset = struct.unpack_from(f"<{ndims}Q", key, 8)
            raw = self.data[self.at(child):self.at(child) + nbytes]
            for i, (fid, elem) in reversed(list(enumerate(filters))):
                if mask & (1 << i):
                    continue
                raw = zlib.decompress(raw) if fid == 1 else _unshuffle(raw, elem)
            block = np.frombuffer(raw, dtype, int(np.prod(chunk))).reshape(chunk)
            region = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, shape))
            out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
        return out

    def _shape(self, pos: int) -> tuple[int, ...]:
        version, rank = self.data[pos], self.data[pos + 1]
        start = pos + (8 if version == 1 else 4)
        return struct.unpack_from(f"<{rank}Q", self.data, start)

    def _dtype(self, pos: int) -> np.dtype:
        cls = self.data[pos] & 0x0F
        bits = self.data[pos + 1]
        size = struct.unpack_from("<I", self.data, pos + 4)[0]
        if bits & 1:
            raise NotImplementedError("big-endian HDF5 data")
        if cls == 0:
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            return np.dtype(f"<f{size}")
        raise NotImplementedError(f"HDF5 datatype class {cls}")

    def _filters(self, pos: int) -> list[tuple[int, int]]:
        """(filter id, element size) of each filter of a pipeline."""
        version, count = self.data[pos], self.data[pos + 1]
        p = pos + (8 if version == 1 else 2)
        out = []
        for _ in range(count):
            fid = struct.unpack_from("<H", self.data, p)[0]
            if version == 1 or fid >= 256:
                name_len, _, nvals = struct.unpack_from("<HHH", self.data, p + 2)
                p += 8
            else:
                name_len, (_, nvals) = 0, struct.unpack_from("<HH", self.data, p + 2)
                p += 6
            p += ((name_len + 7) // 8 * 8) if version == 1 else name_len
            values = struct.unpack_from(f"<{nvals}I", self.data, p)
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2):
                raise NotImplementedError(f"HDF5 filter {fid}")
            out.append((fid, values[0] if fid == 2 and values else 0))
        return out


def _unshuffle(raw: bytes, elem: int) -> bytes:
    """Undo the shuffle filter: byte j of every element was stored together."""
    n = len(raw) // elem
    head = np.frombuffer(raw, np.uint8, n * elem).reshape(elem, n).T
    return head.tobytes() + raw[n * elem:]


def read_datasets(path: str) -> dict[str, np.ndarray]:
    """Every dataset of the root group of the HDF5 file at ``path``."""
    with open(path, "rb") as f:
        h5 = _File(f.read())
    out = {}
    for name, addr in h5.group(h5.root).items():
        arr = h5.dataset(addr)
        if arr is not None:
            out[name] = arr
    return out
