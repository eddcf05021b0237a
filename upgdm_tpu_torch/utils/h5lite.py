"""A read-only HDF5 reader in numpy for the subset Keras weight files use.

The card's machine has no h5py. The Bury-2021 classifiers
(``eval/bury.py``) keep their weights in ``model.weights.h5`` inside each
``.keras`` zip archive, and those files use a small part of the format. This
module reads exactly that part, from bytes (the archive member needs no
temporary file):

  - superblock version 0, at offset 0 or at 512, 1024, 2048, ...;
  - version-1 object headers, with continuation messages;
  - old-style groups: the symbol-table message, version-1 B-tree group nodes,
    ``SNOD`` symbol nodes and the local heap of link names;
  - dataspace messages (versions 1 and 2: scalar or simple, any rank),
    datatype messages and layout messages (version 3, contiguous storage);
  - IEEE floating-point data, little-endian, of 4 or 8 bytes.

Anything else raises ``NotImplementedError`` naming the feature, and the
reader never guesses: a superblock of version 1, 2 or 3; a version-2 object
header; new-style groups (link, link-info or group-info messages); a shared
message; a filter pipeline (compression, shuffle, checksums); a chunked,
compact or virtual layout, or a layout message of another version; a
datatype that is not an IEEE float of 4 or 8 bytes in little-endian order;
storage that was never allocated. Attributes, fill values and modification
times are skipped unread. A malformed file raises ``ValueError``.

``read_h5(data)`` returns the file as nested dicts: a group is a ``dict``
keyed by link name, a dataset a numpy array (shape ``()`` for a scalar).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np

__all__ = ["read_h5"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types (HDF5 file format, section IV.A.2)
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0000, 0x0001, 0x0002, 0x0003
_FILL_OLD, _FILL, _LINK, _EXTERNAL = 0x0004, 0x0005, 0x0006, 0x0007
_LAYOUT, _GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x0008, 0x000A, 0x000B, 0x000C
_CONTINUATION, _SYMBOL_TABLE, _MTIME = 0x0010, 0x0011, 0x0012
_SKIPPED = {_NIL, _FILL_OLD, _FILL, _ATTRIBUTE, _MTIME, 0x000E, 0x0015}
_REFUSED = {
    _LINK_INFO: "new-style groups (link-info message)",
    _LINK: "new-style groups (link message)",
    _GROUP_INFO: "new-style groups (group-info message)",
    _FILTERS: "a filter pipeline (compression or checksums)",
    _EXTERNAL: "external data files",
}
_FLOATS = {  # size -> (precision, exponent location, size, mantissa location, size, bias)
    4: (32, 23, 8, 0, 23, 127),
    8: (64, 52, 11, 0, 52, 1023),
}

Node = Union[Dict[str, "Node"], np.ndarray]


class _Reader:
    def __init__(self, data: bytes):
        self.b = memoryview(bytes(data))
        sb = self._find_superblock()
        version = self.b[sb + 8]
        if version != 0:
            raise NotImplementedError(f"HDF5 superblock version {version} (only 0 is read)")
        offsets, lengths = self.b[sb + 13], self.b[sb + 14]
        if offsets != 8 or lengths != 8:
            raise NotImplementedError(f"offsets of {offsets} and lengths of {lengths} bytes")
        # version 0: 24 bytes of fields, then base address, free-space,
        # end-of-file and driver addresses, then the root symbol-table entry
        pos = sb + 24
        self.base_addr = self._u(pos, 8)
        self.root_entry = pos + 4 * 8

    def _find_superblock(self) -> int:
        at = 0
        while at + 8 <= len(self.b):
            if bytes(self.b[at : at + 8]) == _SIGNATURE:
                return at
            at = 512 if at == 0 else 2 * at
        raise ValueError("not an HDF5 file: no superblock signature")

    def _u(self, pos: int, size: int) -> int:
        if pos + size > len(self.b):
            raise ValueError(f"read past the end of the file at {pos}")
        return int.from_bytes(self.b[pos : pos + size], "little")

    def _addr(self, pos: int) -> int:
        a = self._u(pos, 8)
        return a if a == _UNDEFINED else a + self.base_addr

    def _sig(self, addr: int, sig: bytes) -> None:
        if bytes(self.b[addr : addr + 4]) != sig:
            raise ValueError(f"expected {sig!r} at {addr}")

    # -- object headers ---------------------------------------------------------
    def _messages(self, addr: int):
        """[(type, flags, data offset, size)] of a version-1 object header,
        continuation blocks followed."""
        version = self.b[addr]
        if version != 1:
            raise NotImplementedError(f"object header version {version} (only 1 is read)")
        n_msgs = self._u(addr + 2, 2)
        blocks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while blocks and len(out) < n_msgs:
            pos, length = blocks.pop(0)
            end = pos + length
            while pos + 8 <= end and len(out) < n_msgs:
                mtype, size, flags = self._u(pos, 2), self._u(pos + 2, 2), self.b[pos + 4]
                data = pos + 8
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(data), self._u(data + 8, 8)))
                out.append((mtype, flags, data, size))
                pos = data + size
        return out

    def read_object(self, addr: int) -> Node:
        msgs = self._messages(addr)
        kinds = {m[0] for m in msgs}
        for mtype, flags, _data, _size in msgs:
            if mtype in _REFUSED:
                raise NotImplementedError(_REFUSED[mtype])
            if flags & 0x02 and mtype not in _SKIPPED:
                raise NotImplementedError(f"shared header message of type {mtype:#06x}")
            if mtype not in _SKIPPED | {_DATASPACE, _DATATYPE, _LAYOUT, _CONTINUATION,
                                        _SYMBOL_TABLE}:
                raise NotImplementedError(f"object header message of type {mtype:#06x}")
        if _SYMBOL_TABLE in kinds:
            data = next(m[2] for m in msgs if m[0] == _SYMBOL_TABLE)
            return self._group(self._addr(data), self._addr(data + 8))
        if {_DATASPACE, _DATATYPE, _LAYOUT} <= kinds:
            by_type = {m[0]: m[2] for m in msgs}
            return self._dataset(by_type[_DATASPACE], by_type[_DATATYPE], by_type[_LAYOUT])
        raise NotImplementedError("an object that is neither an old-style group nor a dataset")

    # -- groups ----------------------------------------------------------------
    def _heap_data(self, heap: int) -> int:
        self._sig(heap, b"HEAP")
        return self._addr(heap + 8 + 2 * 8)

    def _name(self, heap_data: int, offset: int) -> str:
        start = heap_data + offset
        end = bytes(self.b[start : start + 65536]).index(b"\0")
        return bytes(self.b[start : start + end]).decode("utf-8")

    def _group(self, btree: int, heap: int) -> Dict[str, Node]:
        heap_data = self._heap_data(heap)
        out: Dict[str, Node] = {}
        for snod in self._btree_leaves(btree):
            self._sig(snod, b"SNOD")
            if self.b[snod + 4] != 1:
                raise NotImplementedError(f"symbol node version {self.b[snod + 4]}")
            for i in range(self._u(snod + 6, 2)):
                entry = snod + 8 + i * 40  # name offset, header address, cache, scratch
                name = self._name(heap_data, self._u(entry, 8))
                out[name] = self.read_object(self._addr(entry + 8))
        return out

    def _btree_leaves(self, node: int):
        """Addresses of the SNOD nodes under a version-1 group B-tree node."""
        self._sig(node, b"TREE")
        if self.b[node + 4] != 0:
            raise NotImplementedError(f"B-tree node of type {self.b[node + 4]} in a group")
        level, used = self.b[node + 5], self._u(node + 6, 2)
        # left and right siblings (8 bytes each), then key, child, key, ... key
        children = [self._addr(node + 24 + 8 + 16 * i) for i in range(used)]
        if level == 0:
            return children
        return [leaf for child in children for leaf in self._btree_leaves(child)]

    # -- datasets --------------------------------------------------------------
    def _shape(self, pos: int):
        version, rank = self.b[pos], self.b[pos + 1]
        if version == 1:
            dims = pos + 8
        elif version == 2:
            kind = self.b[pos + 3]
            if kind == 2:
                raise NotImplementedError("a null dataspace")
            dims = pos + 4
        else:
            raise NotImplementedError(f"dataspace message version {version}")
        # the maximum sizes that may follow the sizes do not change the data
        return tuple(self._u(dims + 8 * i, 8) for i in range(rank))

    def _dtype(self, pos: int) -> np.dtype:
        klass, bits, size = self.b[pos] & 0x0F, self._u(pos + 1, 3), self._u(pos + 4, 4)
        if klass != 1:
            raise NotImplementedError(f"datatype class {klass} (only floating point is read)")
        if bits & 0x01 or bits & 0x40:
            raise NotImplementedError("a big-endian or VAX-order float")
        if (bits >> 4) & 0x03 != 2 or (bits >> 8) & 0xFF != 8 * size - 1:
            raise NotImplementedError(f"a float of {size} bytes that is not IEEE 754")
        props = (self._u(pos + 10, 2), self.b[pos + 12], self.b[pos + 13], self.b[pos + 14],
                 self.b[pos + 15], self._u(pos + 16, 4))
        if size not in _FLOATS or self._u(pos + 8, 2) != 0 or props != _FLOATS[size]:
            raise NotImplementedError(f"a float of {size} bytes that is not IEEE 754")
        return np.dtype("<f4" if size == 4 else "<f8")

    def _dataset(self, space: int, dtype_pos: int, layout: int) -> np.ndarray:
        shape, dtype = self._shape(space), self._dtype(dtype_pos)
        version, klass = self.b[layout], self.b[layout + 1]
        if version != 3:
            raise NotImplementedError(f"data layout message version {version} (only 3 is read)")
        if klass != 1:
            name = {0: "compact", 2: "chunked", 3: "virtual"}.get(klass, str(klass))
            raise NotImplementedError(f"a {name} data layout (only contiguous is read)")
        addr, size = self._addr(layout + 2), self._u(layout + 10, 8)
        count = int(np.prod(shape, dtype=np.int64))
        if addr == _UNDEFINED:
            raise NotImplementedError("storage that was never allocated")
        if size != count * dtype.itemsize or addr + size > len(self.b):
            raise ValueError(f"contiguous storage of {size} bytes at {addr} for {shape} {dtype}")
        return np.frombuffer(self.b, dtype, count, addr).reshape(shape).copy()


def read_h5(data: bytes) -> Dict[str, Node]:
    """The whole file as nested dicts of groups and numpy arrays."""
    r = _Reader(data)
    return r.read_object(r._addr(r.root_entry + 8))
