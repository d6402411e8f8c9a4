"""A writer of HDF5 files in numpy and ``struct`` alone, the twin of
``data/h5_reader.py``: the card's machine has no ``h5py``, so the port
writes its packs itself.

It writes the earliest file format, the one h5py writes with
``libver="earliest"`` and the subset ``h5_reader.py`` parses (the format
specification, "HDF5 File Format Specification Version 2.0", sections
II-IV): a version 0 superblock; the root group as a symbol table, that
is a local heap of the names, one version 1 B-tree leaf of group nodes
and symbol-table nodes (``SNOD``) of at most 2 * 4 entries each (the
default group leaf K), sorted by name byte for byte, since libhdf5 finds
a name by binary search; and one dataset per array, a version 1 object
header with dataspace, datatype (little-endian integers and IEEE floats)
and layout messages over contiguous storage. The arrays are stored
uncompressed: a pack is read back with the same values as h5py's gzip
pack, not the same bytes. libhdf5 reads a dataset without a fill-value
message (it then takes the default fill), so none is written. Every
address is relative to a base address of 0, and the end-of-file address
is the file's size.
"""

from __future__ import annotations

import struct

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
_LEAF_K = 4  # group leaf node K: a symbol-table node holds 2K entries
_TREE_K = 16  # group internal node K: a B-tree node holds 2K children
_HEAP_FREE_NULL = 1  # libhdf5's end of a local heap's free list
_SUPERBLOCK = 96
_TREE_SIZE = 24 + 2 * _TREE_K * 8 + (2 * _TREE_K + 1) * 8
_SNOD_SIZE = 8 + 2 * _LEAF_K * 40

# object header message types
_DATASPACE, _DATATYPE, _LAYOUT, _SYMBOLS = 0x1, 0x3, 0x8, 0x11


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    body = body.ljust(_pad8(len(body)), b"\0")
    return struct.pack("<HHB3x", kind, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype(dtype: np.dtype) -> bytes:
    """A version 1 datatype message: fixed-point or IEEE float, little end."""
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = 0x08 if dtype.kind == "i" else 0x00
        return struct.pack("<B3BIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        exp_loc, exp_size, mant_size, bias = (23, 8, 23, 127) if size == 4 else (
            52, 11, 52, 1023)
        # mantissa normalised with an implied msb (2 << 4); sign at the top bit
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0,
                           8 * size, exp_loc, exp_size, 0, mant_size, bias)
    raise NotImplementedError(f"HDF5 writer: dtype {dtype}")


def _dataspace(shape: tuple[int, ...]) -> bytes:
    """A version 1 dataspace: rank 0 is a scalar; no maximum dimensions."""
    return struct.pack(f"<BBB5x{len(shape)}Q", 1, len(shape), 0, *shape)


def _layout(addr: int, nbytes: int) -> bytes:
    """Version 3, contiguous; an empty array has no storage."""
    return struct.pack("<BBQQ", 3, 1, addr if nbytes else _UNDEFINED, nbytes)


def _dataset_header(arr: np.ndarray, dtype_msg: bytes, addr: int) -> bytes:
    return _object_header([_message(_DATASPACE, _dataspace(arr.shape)),
                           _message(_DATATYPE, dtype_msg, flags=1),
                           _message(_LAYOUT, _layout(addr, arr.nbytes))])


def _symbol_entry(name_offset: int, header: int, cache: int = 0,
                  scratch: bytes = b"") -> bytes:
    return struct.pack("<QQI4x", name_offset, header, cache) + scratch.ljust(16, b"\0")


def _leaves(n: int) -> list[int]:
    """Entries per symbol-table node: as few nodes as fit, filled evenly."""
    count = max(1, -(-n // (2 * _LEAF_K)))
    return [n // count + (i < n % count) for i in range(count)]


def write_datasets(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Write each array as a dataset of the root group of a new HDF5 file
    at ``path``. Names are non-empty, not ``.`` and hold no ``/`` or NUL; arrays are
    integers or float32/float64, of any rank (0 is a scalar) and any
    shape (a zero-length axis stores nothing)."""
    items = []
    for name, arr in arrays.items():
        raw = name.encode()
        if not raw or raw == b"." or b"/" in raw or b"\0" in raw:
            raise ValueError(f"HDF5 writer: dataset name {name!r}")
        arr = np.asarray(arr)
        arr = np.asarray(arr, dtype=arr.dtype.newbyteorder("<"), order="C")
        items.append((raw, arr, _datatype(arr.dtype)))
    items.sort(key=lambda item: item[0])
    leaves = _leaves(len(items)) if items else []
    if len(leaves) > 2 * _TREE_K:
        raise NotImplementedError(f"HDF5 writer: {len(items)} datasets in one group")

    # the local heap's data: "" at offset 0, then each name, NUL-padded to 8
    heap_data = bytearray(8)
    name_offsets = []
    for raw, _, _ in items:
        name_offsets.append(len(heap_data))
        heap_data += raw.ljust(_pad8(len(raw) + 1), b"\0")

    root = _SUPERBLOCK
    root_header_size = 16 + 8 + 16
    tree = root + root_header_size
    heap = tree + _TREE_SIZE
    heap_addr = heap + 32
    snods = heap_addr + len(heap_data)
    pos = snods + _SNOD_SIZE * len(leaves)
    header_addrs, data_addrs = [], []
    for _, arr, dt in items:
        header_addrs.append(pos)
        # a dataset's header has the same size whatever its data's address
        pos += len(_dataset_header(arr, dt, 0))
    for _, arr, _ in items:
        data_addrs.append(pos)
        pos += _pad8(arr.nbytes)
    eof = pos

    meta = bytearray()
    meta += _SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K,
                                     _TREE_K, 0)
    meta += struct.pack("<QQQQ", 0, _UNDEFINED, eof, _UNDEFINED)
    meta += _symbol_entry(0, root, cache=1, scratch=struct.pack("<QQ", tree, heap))
    meta += _object_header([_message(_SYMBOLS, struct.pack("<QQ", tree, heap))])

    # the B-tree leaf: key i < every name of child i <= key i + 1
    node = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, 0, len(leaves), _UNDEFINED,
                                 _UNDEFINED))
    node += struct.pack("<Q", 0)
    last = -1
    for i, count in enumerate(leaves):
        last += count
        node += struct.pack("<QQ", snods + _SNOD_SIZE * i, name_offsets[last])
    meta += node.ljust(_TREE_SIZE, b"\0")

    meta += struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), _HEAP_FREE_NULL,
                        heap_addr)
    meta += heap_data
    first = 0
    for count in leaves:
        snod = bytearray(struct.pack("<4sBBH", b"SNOD", 1, 0, count))
        for e in range(first, first + count):
            snod += _symbol_entry(name_offsets[e], header_addrs[e])
        meta += snod.ljust(_SNOD_SIZE, b"\0")
        first += count
    for (_, arr, dt), addr in zip(items, data_addrs):
        meta += _dataset_header(arr, dt, addr)
    assert len(meta) == (data_addrs[0] if items else eof)

    with open(path, "wb") as f:
        f.write(meta)
        for (_, arr, _), addr in zip(items, data_addrs):
            f.write(b"\0" * (addr - f.tell()))
            if arr.nbytes:
                f.write(memoryview(arr.reshape(-1)).cast("B"))
        f.write(b"\0" * (eof - f.tell()))
