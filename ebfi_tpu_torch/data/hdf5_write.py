"""An HDF5 writer of the port's own, on numpy and ``zlib``: files that
``h5py`` (so the JAX package and the reference) reads, written on a
machine without ``h5py``.

It writes what ``h5py`` writes with its defaults (``libver`` ``earliest``):

- superblock version 0, 8-byte offsets and lengths, version-1 object
  headers;
- groups as symbol tables: names sorted (``h5py`` looks them up by binary
  search) in ``SNOD`` leaves of 8 entries under a v1 B-tree of 32 children
  a node, as many levels as the group needs, the names in a local heap;
- contiguous datasets, and chunked ones with deflate at ``h5py``'s gzip
  level 4 under a v1 B-tree of 64 chunks a node (the K of 32 that
  superblock 0 fixes), as many levels as the chunks need; edge chunks are
  stored whole, padded with zeros; chunk shapes follow ``h5py``'s own rule
  (:func:`guess_chunk`), so a file written here costs what a user's file
  costs to read;
- attributes: fixed-point and IEEE scalars and arrays, byte strings as
  fixed-length strings and ``str`` as variable-length UTF-8 strings in a
  global heap, as ``h5py`` stores them (so ``h5py`` reads them back as
  ``bytes`` and ``str``).

Raw data goes to the file as each dataset is created, the metadata (object
headers, heaps, B-trees, then the superblock) at :meth:`Writer.close`.
Chunks are compressed on a few threads (``zlib`` releases the GIL).
:mod:`.hdf5` reads the files back.
"""
from __future__ import annotations

import concurrent.futures as cf
import math
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hdf5 import FILTER_DEFLATE, SIGNATURE, _IEEE

UNDEF = (1 << 64) - 1
SUPERBLOCK_SIZE = 96  # version 0, 8-byte offsets and lengths
GROUP_LEAF_K, GROUP_NODE_K, CHUNK_NODE_K = 4, 16, 32  # superblock 0's defaults
ENTRY_SIZE = 40  # a symbol table entry
GZIP_LEVEL = 4  # h5py's default
CHUNK_BASE, CHUNK_MIN, CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024
WRITE_BATCH = 64  # chunks compressed together


def guess_chunk(shape: Sequence[int], typesize: int) -> Tuple[int, ...]:
    """h5py's chunk shape for a dataset (``h5py/_hl/filters.py::guess_chunk``):
    a target of 16 KiB times 2 ** log10(dataset MiB), clamped to [8 KiB,
    1 MiB]; the axes halved in turn (rounding up) until the chunk is under
    the target, or within half of it, and under 1 MiB.  A zero-length axis
    counts as 1024."""
    shape = tuple(s if s != 0 else 1024 for s in shape)
    if not shape:
        raise ValueError("a scalar dataset has no chunks")
    chunks = np.array(shape, dtype="=f8")
    target = CHUNK_BASE * (2 ** np.log10(np.prod(chunks) * typesize / (1024.0 * 1024)))
    target = min(max(target, CHUNK_MIN), CHUNK_MAX)
    idx = 0
    while True:
        nbytes = np.prod(chunks) * typesize
        if ((nbytes < target or abs(nbytes - target) / target < 0.5)
                and nbytes < CHUNK_MAX):
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(c) for c in chunks)


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


# --------------------------------------------------------------------------- #
# message encodings


def _datatype(dt: np.dtype) -> bytes:
    """A version-1 datatype message for a numeric or fixed-length byte
    string dtype."""
    order = 1 if dt.str[0] == ">" else 0
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, order | (0x08 if dt.kind == "i" else 0), 0, 0,
                           dt.itemsize, 0, 8 * dt.itemsize)
    if dt.kind == "f" and dt.itemsize in _IEEE:
        sign, eloc, esize, msize, bias = _IEEE[dt.itemsize]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20 | order, sign, 0, dt.itemsize, 0,
                           8 * dt.itemsize, eloc, esize, 0, msize, bias)
    if dt.kind == "S":
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, dt.itemsize)  # null-padded ASCII
    raise TypeError(f"dtype {dt} is not written (integers, IEEE floats, byte strings)")


# a variable-length UTF-8 string of unsigned bytes, as h5py declares str
_VLEN_STR = struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + _datatype(np.dtype("u1"))


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    """A version-1 dataspace (rank 0: scalar); maximum sizes the sizes."""
    if not shape:
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), 1, 0) + dims + dims


def _header(messages: List[Tuple[int, bytes, int]]) -> bytes:
    """A version-1 object header holding (type, body, flags) messages."""
    chunk = b"".join(struct.pack("<HHB3x", t, len(_pad8(body)), flags) + _pad8(body)
                     for t, body, flags in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(chunk)) + chunk


def _deflate_pipeline(level: int) -> bytes:
    """A version-1 filter pipeline of deflate alone, optional as h5py marks
    it, with the library's name and one client value, the level."""
    name = _pad8(b"deflate\0")
    return (struct.pack("<BB6xHHHH", 1, 1, FILTER_DEFLATE, len(name), 1, 1) + name
            + struct.pack("<I4x", level))


# --------------------------------------------------------------------------- #
# the objects


class _Attrs(dict):
    """An object's attributes: values converted as h5py converts them when
    they are set."""

    def __setitem__(self, name: str, value) -> None:
        super().__setitem__(name, _attr_value(name, value))


def _attr_value(name: str, value):
    """(kind, dtype, shape, values): kind "vlen" for ``str``, "raw" else."""
    if isinstance(value, str):
        return ("vlen", None, (), [value])
    arr = np.asarray(value)
    if arr.dtype.kind == "U":  # a list or array of str
        return ("vlen", None, arr.shape, [str(v) for v in arr.reshape(-1)])
    if arr.dtype.kind == "S" and arr.dtype.itemsize == 0:
        arr = arr.astype("S1")
    kind, size = arr.dtype.kind, arr.dtype.itemsize
    if kind not in "iufS" or (kind == "f" and size not in _IEEE):
        raise TypeError(f"attribute {name!r}: {arr.dtype} values are not written (integers, "
                        "IEEE floats, strings)")
    return ("raw", arr.dtype, arr.shape, np.ascontiguousarray(arr).tobytes())


class Dataset:
    """A written dataset: its shape, dtype and storage, and ``attrs``."""

    def __init__(self, name: str, shape, dtype, layout: dict):
        self.name, self.shape, self.dtype, self._layout = name, tuple(shape), dtype, layout
        self.attrs = _Attrs()


class Group:
    """A group being written: ``create_group``, ``require_group``,
    ``create_dataset``, ``g["a/b"]``, ``in``, ``attrs``, ``members``."""

    def __init__(self, writer: "Writer", name: str):
        self._w, self.name = writer, name
        self.members: Dict[str, object] = {}
        self.attrs = _Attrs()

    def _parent_of(self, path: str, create: bool):
        parts = path.strip("/").split("/")
        g = self
        for p in parts[:-1]:
            if p not in g.members:
                if not create:
                    raise KeyError(path)
                g.members[p] = Group(self._w, f"{g.name.rstrip('/')}/{p}")
            g = g.members[p]
            if not isinstance(g, Group):
                raise KeyError(f"{path}: {g.name!r} is not a group")
        return g, parts[-1]

    def __getitem__(self, path: str):
        g, last = self._parent_of(path, create=False)
        if last not in g.members:
            raise KeyError(path)
        return g.members[last]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def create_group(self, path: str) -> "Group":
        g, last = self._parent_of(path, create=True)
        if last in g.members:
            raise ValueError(f"{path!r} exists")
        g.members[last] = Group(self._w, f"{g.name.rstrip('/')}/{last}")
        return g.members[last]

    def require_group(self, path: str) -> "Group":
        if path in self:
            obj = self[path]
            if not isinstance(obj, Group):
                raise TypeError(f"{path!r} is a dataset")
            return obj
        return self.create_group(path)

    def create_dataset(self, path: str, data, compression: Optional[str] = None) -> Dataset:
        """Write ``data`` (any numeric or byte-string array) now: contiguous,
        or with ``compression="gzip"`` in :func:`guess_chunk`'s chunks,
        deflated at h5py's level 4."""
        g, last = self._parent_of(path, create=True)
        if last in g.members:
            raise ValueError(f"{path!r} exists")
        arr = np.asarray(data)
        if arr.dtype.kind not in "iufS":
            raise TypeError(f"{path!r}: {arr.dtype} data is not written")
        _datatype(arr.dtype)  # raises for the dtypes it cannot declare
        if compression not in (None, "gzip"):
            raise ValueError(f"{path!r}: compression {compression!r} is not written (gzip only)")
        if compression == "gzip":  # guess_chunk raises for a scalar, as h5py does
            layout = self._w._write_chunked(arr, guess_chunk(arr.shape, arr.dtype.itemsize))
        else:
            layout = self._w._write_contiguous(arr)
        name = f"{g.name.rstrip('/')}/{last}"
        g.members[last] = Dataset(name, arr.shape, arr.dtype, layout)
        return g.members[last]


class Writer(Group):
    """A new HDF5 file at ``path`` (truncated), the root group; written out
    by :meth:`close`."""

    def __init__(self, path: str):
        super().__init__(self, "/")
        self.filename = os.fspath(path)
        self._f = open(self.filename, "wb")
        self._f.write(bytes(SUPERBLOCK_SIZE))
        self._eof = SUPERBLOCK_SIZE
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._gcol: Dict[str, Tuple[int, int]] = {}  # string -> (collection, index)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _append(self, data) -> int:
        addr = self._eof
        self._f.write(data)
        self._eof += len(memoryview(data).cast("B"))
        return addr

    # -- raw data ------------------------------------------------------------ #

    def _write_contiguous(self, arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        if arr.nbytes == 0:
            return {"addr": UNDEF, "size": 0}
        return {"addr": self._append(memoryview(arr).cast("B")), "size": arr.nbytes}

    def _write_chunked(self, arr: np.ndarray, chunks: Tuple[int, ...]) -> dict:
        grid = [math.ceil(s / c) for s, c in zip(arr.shape, chunks)]
        origins = [tuple(i * c for i, c in zip(idx, chunks)) for idx in np.ndindex(*grid)]
        if self._pool is None:
            self._pool = cf.ThreadPoolExecutor(min(8, os.cpu_count() or 1))

        def encode(origin):
            block = arr[tuple(slice(o, o + c) for o, c in zip(origin, chunks))]
            if block.shape != chunks:
                full = np.zeros(chunks, arr.dtype)
                full[tuple(slice(0, s) for s in block.shape)] = block
                block = full
            return zlib.compress(np.ascontiguousarray(block).tobytes(), GZIP_LEVEL)

        index = []
        for start in range(0, len(origins), WRITE_BATCH):
            batch = origins[start:start + WRITE_BATCH]
            for origin, data in zip(batch, self._pool.map(encode, batch)):
                index.append((origin, self._append(data), len(data)))
        return {"chunks": chunks, "index": index, "itemsize": arr.dtype.itemsize}

    # -- metadata ------------------------------------------------------------ #

    def _btree(self, node_type: int, k2: int, children: List[int], keys: List[bytes]) -> int:
        """Write a v1 B-tree over ``children`` (len n) and ``keys`` (len n + 1)
        in nodes of at most ``k2`` children; returns the root's address."""
        key_size = len(keys[0])
        node_size = 24 + k2 * 8 + (k2 + 1) * key_size
        level = 0
        while True:
            n_nodes = max(1, math.ceil(len(children) / k2))
            first = self._eof
            addrs = [first + j * node_size for j in range(n_nodes)]
            bounds = [min(j * k2, len(children)) for j in range(n_nodes + 1)]
            for j in range(n_nodes):
                a, b = bounds[j], bounds[j + 1]
                left = addrs[j - 1] if j > 0 else UNDEF
                right = addrs[j + 1] if j + 1 < n_nodes else UNDEF
                body = b"".join(keys[i] + struct.pack("<Q", children[i]) for i in range(a, b))
                node = (b"TREE" + struct.pack("<BBHQQ", node_type, level, b - a, left, right)
                        + body + keys[b])
                self._append(node + bytes(node_size - len(node)))
            if n_nodes == 1:
                return addrs[0]
            children, keys = addrs, [keys[i] for i in bounds]
            level += 1

    def _chunk_btree(self, layout: dict, rank: int) -> int:
        index = layout["index"]
        if not index:
            return UNDEF
        chunks, itemsize = layout["chunks"], layout["itemsize"]
        keys = [struct.pack(f"<II{rank + 1}Q", size, 0, *origin, 0)
                for origin, _, size in index]
        end = [o + c for o, c in zip(index[-1][0], chunks)]
        keys.append(struct.pack(f"<II{rank + 1}Q", 0, 0, *end, itemsize))
        return self._btree(1, 2 * CHUNK_NODE_K, [addr for _, addr, _ in index], keys)

    def _vlen_strings(self, obj, out: list) -> None:
        for kind, _, _, values in obj.attrs.values():
            if kind == "vlen":
                out.extend(v for v in values if v not in self._gcol)
        for child in getattr(obj, "members", {}).values():
            self._vlen_strings(child, out)

    def _write_global_heap(self) -> None:
        """Every distinct ``str`` attribute value into global heap
        collections (at least 4096 bytes each, at most 65535 objects)."""
        pending: List[str] = []
        self._vlen_strings(self, pending)
        pending = list(dict.fromkeys(pending))
        for start in range(0, len(pending), 65535):
            objs = b""
            for i, s in enumerate(pending[start:start + 65535], 1):
                data = s.encode("utf-8")
                objs += struct.pack("<HH4xQ", i, 0, len(data)) + _pad8(data)
            size = max(4096, 16 + len(objs) + 16)
            free = size - 16 - len(objs)
            heap = b"GCOL" + struct.pack("<B3xQ", 1, size) + objs
            heap += struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)
            addr = self._append(heap)
            for i, s in enumerate(pending[start:start + 65535], 1):
                self._gcol[s] = (addr, i)

    def _attr_messages(self, attrs: _Attrs) -> List[Tuple[int, bytes, int]]:
        out = []
        for name, (kind, dt, shape, values) in attrs.items():
            if kind == "vlen":
                typ = _VLEN_STR
                data = b"".join(struct.pack("<IQI", len(s.encode("utf-8")), *self._gcol[s])
                                for s in values)
            else:
                typ, data = _datatype(dt), values
            space = _dataspace(shape)
            nb = name.encode("utf-8") + b"\0"
            body = (struct.pack("<BBHHH", 1, 0, len(nb), len(typ), len(space))
                    + _pad8(nb) + _pad8(typ) + _pad8(space) + data)
            if len(_pad8(body)) > 0xFFFF:
                raise ValueError(f"{self.filename}: attribute {name!r} holds {len(data)} bytes; "
                                 "version-1 headers take at most 64 KiB a message")
            out.append((0x000C, body, 0))
        return out

    def _write_dataset(self, ds: Dataset) -> int:
        lay = ds._layout
        chunked = "chunks" in lay
        # fill value: version 2, allocated late (incremental when chunked),
        # written if set, the library's default value
        fill = struct.pack("<BBBBI", 2, 3 if chunked else 2, 2, 1, 0)
        msgs = [(0x0001, _dataspace(ds.shape), 0), (0x0003, _datatype(ds.dtype), 1),
                (0x0005, fill, 1)]
        if chunked:
            rank = len(ds.shape)
            msgs.append((0x000B, _deflate_pipeline(GZIP_LEVEL), 1))
            layout = (struct.pack("<BBBQ", 3, 2, rank + 1, self._chunk_btree(lay, rank))
                      + struct.pack(f"<{rank + 1}I", *lay["chunks"], lay["itemsize"]))
        else:
            layout = struct.pack("<BBQQ", 3, 1, lay["addr"], lay["size"])
        msgs.append((0x0008, layout, 0))
        return self._append(_header(msgs + self._attr_messages(ds.attrs)))

    def _write_group(self, g: Group) -> Tuple[int, int, int]:
        """Write the group's members, heap, nodes and header; returns (header,
        B-tree, heap) addresses."""
        names = sorted(g.members, key=lambda n: n.encode("utf-8"))
        entries = []
        for name in names:
            child = g.members[name]
            if isinstance(child, Group):
                header, btree, heap = self._write_group(child)
                entries.append((name, header, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((name, self._write_dataset(child), 0, bytes(16)))
        heap_data, offsets = bytearray(8), []  # offset 0: the empty name
        for name in names:
            offsets.append(len(heap_data))
            heap_data += _pad8(name.encode("utf-8") + b"\0")
        heap = self._append(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                                  self._eof + 32) + bytes(heap_data))
        snods, keys = [], [struct.pack("<Q", 0)]
        per = 2 * GROUP_LEAF_K
        for start in range(0, len(entries), per):
            batch = entries[start:start + per]
            body = b"".join(struct.pack("<QQI4x", offsets[start + i], addr, cache) + scratch
                            for i, (_, addr, cache, scratch) in enumerate(batch))
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(batch)) + body
            snods.append(self._append(node + bytes(8 + per * ENTRY_SIZE - len(node))))
            keys.append(struct.pack("<Q", offsets[start + len(batch) - 1]))
        btree = self._btree(0, 2 * GROUP_NODE_K, snods, keys)
        msgs = [(0x0011, struct.pack("<QQ", btree, heap), 0)] + self._attr_messages(g.attrs)
        return self._append(_header(msgs)), btree, heap

    def close(self) -> None:
        """Write the metadata and the superblock, and close the file."""
        if self._f is None:
            return
        try:
            self._write_global_heap()
            root, btree, heap = self._write_group(self)
            self._f.seek(0)
            self._f.write(SIGNATURE + struct.pack("<8BHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                                  GROUP_LEAF_K, GROUP_NODE_K, 0)
                          + struct.pack("<QQQQ", 0, UNDEF, self._eof, UNDEF)
                          + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
        finally:
            self._f.close()
            self._f = None
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None
