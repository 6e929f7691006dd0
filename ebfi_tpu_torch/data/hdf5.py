"""An HDF5 reader of the port's own, on numpy and the standard library's
``zlib``: the schema H5 clips of the JAX package and the reference, read
without ``h5py`` (which the card machine does not have).

The scope is what ``h5py`` writes by default (``libver`` ``earliest``) and
what the JAX package and the reference write:

- superblock versions 0 and 1 (offsets and lengths of the sizes it
  states), found at byte 0, 512, 1024, 2048, ...;
- version-1 object headers, continuation blocks included (an attribute
  added later in ``"a"`` mode lands in one);
- groups as symbol tables (a v1 B-tree of type 0 over ``SNOD`` leaves, the
  names in the local heap), and compact new-style groups (link messages
  of hard links);
- datatypes: fixed-point (signed, unsigned) and IEEE floats in either byte
  order, fixed-length strings, and variable-length strings (read from the
  global heap, ``GCOL``) in attributes;
- layouts: compact, contiguous and chunked; the chunk index (a v1 B-tree
  of type 1) is read once, when a dataset is opened, into numpy arrays;
- filters: deflate (``zlib``), shuffle and fletcher32 (its checksum
  verified), honouring each chunk's filter mask; edge chunks are cropped,
  chunks never written read as the fill value.

Anything else raises :class:`HDF5Error`, naming the feature and the file:
superblocks 2 and 3, v2 object headers (``OHDR``), dense (fractal-heap)
links or attributes, chunk indexes other than the v1 B-tree, virtual and
external storage, other filters (lzf, szip, blosc, ...), compound, enum,
array, opaque, reference and variable-length sequence types, shared
messages, soft and external links.  It never returns other data instead.

Reads: ``ds[:]``, ``ds[()]``, ``ds[i]`` and ``ds[a:b]`` on the first axis,
each touching only the chunks that overlap the selection.  The chunks of a
partial read stay in one LRU per file (4 MiB: ``h5py``'s 1 MiB default for
each of a clip's four event arrays), so that neighbouring windows of a clip
do not decompress their shared event chunks twice; a read of a whole
dataset (a frame) keeps none, as ``h5py`` drops a dataset's cache with its
handle.  Objects: ``File(path)["a/b"]``, ``.attrs``,
``.keys()``, ``len()``, ``in``, ``.shape``, ``.dtype``; values come back as
``h5py`` gives them (arrays in the file's byte order, scalars as numpy
scalars, variable-length strings as ``str``, fixed-length ones as bytes).

The file is opened lazily, in each process, and read with ``os.pread``
(no shared file offset, so threads read concurrently): a :class:`File`
pickled or forked before its first read works in the new process.
"""
from __future__ import annotations

import collections
import os
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
CHUNK_CACHE_BYTES = 4 << 20  # decoded chunks kept per file (h5py: 1 MiB a dataset)

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3
FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4",
                32008: "bitshuffle", 32015: "zstd"}
DATATYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
                    4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enum",
                    9: "variable-length", 10: "array"}
CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array", 4: "extensible array",
                 5: "v2 B-tree"}
# object header messages that describe nothing this reader returns
_SKIPPED_MESSAGES = {0x0000: "NIL", 0x0009: "bogus", 0x000A: "group info",
                     0x000D: "object comment", 0x000E: "modification time (old)",
                     0x0012: "modification time", 0x0016: "reference count"}
# the messages this reader reads; any other type raises
_READ_MESSAGES = {0x0001, 0x0002, 0x0003, 0x0004, 0x0005, 0x0006, 0x0007, 0x0008, 0x000B,
                  0x000C, 0x0011, 0x0015}
# IEEE layouts by size: sign bit, exponent location and size, mantissa size, bias
_IEEE = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}


class HDF5Error(ValueError):
    """A file this reader cannot read: a feature outside its scope, or a
    structure that is not what the format says."""


def _u(b, p: int, n: int) -> int:
    return int.from_bytes(b[p:p + n], "little")


# --------------------------------------------------------------------------- #
# the bytes of the file


class _Source:
    """The file's bytes by address, opened at the first read in each
    process (``os.pread``: no shared offset between threads)."""

    def __init__(self, path: str):
        self.path = path
        self.base = 0
        self._fd: Optional[int] = None
        self._pid = -1

    def _handle(self) -> int:
        if self._fd is None or self._pid != os.getpid():
            self._fd, self._pid = os.open(self.path, os.O_RDONLY), os.getpid()
        return self._fd

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self._handle(), n, self.base + addr)
        if len(data) != n:
            raise HDF5Error(f"{self.path}: {n} bytes at address {addr} run past the end of "
                            "the file (truncated?)")
        return data

    def read_into(self, addr: int, out: np.ndarray) -> None:
        view = memoryview(out).cast("B")
        got = os.preadv(self._handle(), [view], self.base + addr)
        if got != len(view):
            raise HDF5Error(f"{self.path}: {len(view)} bytes at address {addr} run past the "
                            "end of the file (truncated?)")

    def close(self) -> None:
        if self._fd is not None and self._pid == os.getpid():
            os.close(self._fd)
        self._fd = None

    def __getstate__(self):
        return {"path": self.path, "base": self.base, "_fd": None, "_pid": -1}

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# --------------------------------------------------------------------------- #
# messages


class _Type:
    """A datatype message: ``dtype`` (numpy), ``size`` in the file, and
    ``vlen_str`` / ``charset`` for variable-length strings."""

    __slots__ = ("dtype", "size", "vlen_str", "charset")

    def __init__(self, dtype, size, vlen_str=False, charset=0):
        self.dtype, self.size, self.vlen_str, self.charset = dtype, size, vlen_str, charset


class _Reader:
    """Parsing state of one file: sizes from its superblock, caches of what
    was parsed (object headers, heaps, opened objects), and the file's LRU
    of decoded chunks, keyed by (dataset header address, chunk)."""

    def __init__(self, src: _Source, O: int, L: int):
        self.src, self.O, self.L = src, O, L
        self.undef = (1 << (8 * O)) - 1
        self.headers: Dict[int, list] = {}
        self.objects: Dict[int, object] = {}
        self.gcols: Dict[int, Dict[int, bytes]] = {}
        self._empty_lru()

    def _empty_lru(self) -> None:
        self.chunks: "collections.OrderedDict[Tuple[int, int], np.ndarray]" = \
            collections.OrderedDict()
        self.chunk_bytes = 0
        self.lock = threading.Lock()

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["chunks"], state["chunk_bytes"], state["lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._empty_lru()

    def cached_chunk(self, key: Tuple[int, int]) -> Optional[np.ndarray]:
        with self.lock:
            hit = self.chunks.get(key)
            if hit is not None:
                self.chunks.move_to_end(key)
            return hit

    def keep_chunk(self, key: Tuple[int, int], chunk: np.ndarray) -> None:
        """Into the LRU, the least recently used out past CHUNK_CACHE_BYTES."""
        if chunk.nbytes > CHUNK_CACHE_BYTES:
            return
        with self.lock:
            if key not in self.chunks:
                self.chunks[key] = chunk
                self.chunk_bytes += chunk.nbytes
            while self.chunk_bytes > CHUNK_CACHE_BYTES:
                _, old = self.chunks.popitem(last=False)
                self.chunk_bytes -= old.nbytes

    def fail(self, what: str):
        raise HDF5Error(f"{self.src.path}: {what}")

    # -- object headers ------------------------------------------------------ #

    def header(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """The messages of the object header at ``addr``: (type, flags, body),
        continuation blocks followed."""
        msgs = self.headers.get(addr)
        if msgs is not None:
            return msgs
        pre = self.src.read(addr, 16)
        if pre[:4] == b"OHDR":
            self.fail(f"object header at {addr} is version 2 (OHDR; written with libver "
                      "'latest' or creation-order tracking): not supported")
        if pre[0] != 1:
            self.fail(f"object header at {addr} has version {pre[0]}: not supported")
        n_msgs, size = _u(pre, 2, 2), _u(pre, 8, 4)
        blocks, msgs = [(addr + 16, size)], []
        seen = 0
        while blocks:
            start, length = blocks.pop(0)
            data = self.src.read(start, length)
            p = 0
            while p + 8 <= length and seen < n_msgs:
                mtype, msize, flags = _u(data, p, 2), _u(data, p + 2, 2), data[p + 4]
                body = data[p + 8:p + 8 + msize]
                p += 8 + msize
                seen += 1
                if mtype == 0x0010:
                    blocks.append((_u(body, 0, self.O), _u(body, self.O, self.L)))
                elif mtype not in _SKIPPED_MESSAGES:
                    if mtype not in _READ_MESSAGES:
                        self.fail(f"object header at {addr}: message type 0x{mtype:04x}: not "
                                  "supported")
                    if flags & 0x02:
                        self.fail(f"object header at {addr}: message 0x{mtype:04x} is shared "
                                  "(a committed datatype or a shared message table): not "
                                  "supported")
                    msgs.append((mtype, flags, body))
        self.headers[addr] = msgs
        return msgs

    # -- dataspace, datatype, fill value ------------------------------------- #

    def dataspace(self, b: bytes) -> Tuple[int, ...]:
        version, rank = b[0], b[1]
        if version == 1:
            p = 8
        elif version == 2:
            if b[3] == 2:
                self.fail("null dataspace (h5py.Empty): not supported")
            p = 4
        else:
            self.fail(f"dataspace message version {version}: not supported")
        return tuple(_u(b, p + i * self.L, self.L) for i in range(rank))

    def datatype(self, b: bytes, p: int = 0) -> Tuple[_Type, int]:
        """The datatype at ``b[p:]`` and the bytes it takes."""
        cls, version = b[p] & 0x0F, b[p] >> 4
        bits = _u(b, p + 1, 3)
        size = _u(b, p + 4, 4)
        if version not in (1, 2, 3):
            self.fail(f"datatype message version {version}: not supported")
        order = ">" if bits & 1 else "<"
        if cls == 0:  # fixed-point
            offset, precision = _u(b, p + 8, 2), _u(b, p + 10, 2)
            if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
                self.fail(f"fixed-point type of {size} bytes, bit offset {offset}, precision "
                          f"{precision}: not supported")
            kind = "i" if bits & 0x08 else "u"
            return _Type(np.dtype(f"{order}{kind}{size}"), size), 12
        if cls == 1:  # floating-point
            if bits & 0x40:
                self.fail("floating-point type in VAX byte order: not supported")
            props = (bits >> 8 & 0xFF, b[p + 12], b[p + 13], b[p + 15], _u(b, p + 16, 4))
            offset, precision = _u(b, p + 8, 2), _u(b, p + 10, 2)
            if (size not in _IEEE or props != _IEEE[size] or offset != 0
                    or precision != 8 * size or b[p + 14] != 0 or (bits >> 4) & 3 != 2):
                self.fail(f"floating-point type of {size} bytes that is not IEEE "
                          f"(sign, exponent, mantissa, bias {props}): not supported")
            return _Type(np.dtype(f"{order}f{size}"), size), 20
        if cls == 3:  # fixed-length string
            return _Type(np.dtype(f"S{size}"), size), 8
        if cls == 9 and bits & 0x0F == 1:  # variable-length string
            _, used = self.datatype(b, p + 8)
            return _Type(np.dtype(object), size, True, bits >> 8 & 0x0F), 8 + used
        what = DATATYPE_CLASSES.get(cls, f"class {cls}")
        if cls == 9:
            what = "variable-length sequence"
        self.fail(f"datatype {what}: not supported")

    def fill(self, msgs) -> Optional[bytes]:
        """The fill value's bytes, or None for zeros."""
        for mtype, _, b in msgs:
            if mtype == 0x0005:
                version = b[0]
                if version in (1, 2):
                    if b[3]:  # defined: its size and value follow
                        n = _u(b, 4, 4)
                        return b[8:8 + n] if n else None
                    return None
                if version == 3:
                    if b[1] & 0x20:
                        n = _u(b, 2, 4)
                        return b[6:6 + n] if n else None
                    return None
                self.fail(f"fill value message version {version}: not supported")
        for mtype, _, b in msgs:
            if mtype == 0x0004:
                n = _u(b, 0, 4)
                return b[4:4 + n] if n else None
        return None

    # -- attributes ---------------------------------------------------------- #

    def attributes(self, msgs) -> Dict[str, object]:
        out = {}
        for mtype, _, b in msgs:
            if mtype == 0x0015:
                if _u(b, 2 + (2 if b[1] & 1 else 0), self.O) != self.undef:
                    self.fail("dense attribute storage (fractal heap): not supported")
            elif mtype == 0x000C:
                name, value = self.attribute(b)
                out[name] = value
        return dict(sorted(out.items()))  # h5py's order: by name

    def attribute(self, b: bytes):
        version = b[0]
        if version not in (1, 2, 3):
            self.fail(f"attribute message version {version}: not supported")
        if version > 1 and b[1] & 0x03:
            self.fail("attribute with a shared datatype or dataspace: not supported")
        n_name, n_type, n_space = _u(b, 2, 2), _u(b, 4, 2), _u(b, 6, 2)
        pad = (lambda n: -(-n // 8) * 8) if version == 1 else (lambda n: n)
        p = 8 if version < 3 else 9
        name = b[p:p + n_name].rstrip(b"\0").decode("utf-8")
        p += pad(n_name)
        typ, _ = self.datatype(b, p)
        p += pad(n_type)
        shape = self.dataspace(b[p:p + n_space])
        p += pad(n_space)
        count = int(np.prod(shape, dtype=np.int64))
        raw = b[p:p + count * typ.size]
        if len(raw) != count * typ.size:
            self.fail(f"attribute {name!r}: {len(raw)} bytes of data, {count * typ.size} "
                      "expected")
        if typ.vlen_str:
            arr = np.array([self.vlen_string(raw, i * typ.size, typ.charset)
                            for i in range(count)], dtype=object).reshape(shape)
        else:
            arr = np.frombuffer(raw, typ.dtype).reshape(shape).copy()
        return name, (arr[()] if shape == () else arr)

    def vlen_string(self, raw: bytes, p: int, charset: int) -> str:
        n, coll, index = _u(raw, p, 4), _u(raw, p + 4, self.O), _u(raw, p + 4 + self.O, 4)
        if n == 0:
            return ""
        objs = self.gcols.get(coll)
        if objs is None:
            objs = self.gcols[coll] = self.global_heap(coll)
        if index not in objs:
            self.fail(f"global heap collection at {coll} has no object {index}")
        return objs[index][:n].decode("utf-8" if charset == 1 else "ascii")

    def global_heap(self, addr: int) -> Dict[int, bytes]:
        head = self.src.read(addr, 8 + self.L)
        if head[:4] != b"GCOL" or head[4] != 1:
            self.fail(f"no global heap collection (GCOL, version 1) at {addr}")
        size = _u(head, 8, self.L)
        data = self.src.read(addr, size)
        objs, p, hdr = {}, 8 + self.L, 8 + self.L
        while p + hdr <= size:
            index, n = _u(data, p, 2), _u(data, p + 8, self.L)
            if index == 0:  # free space: the rest of the collection
                break
            objs[index] = data[p + hdr:p + hdr + n]
            p += hdr + -(-n // 8) * 8
        return objs

    # -- groups -------------------------------------------------------------- #

    def local_heap(self, addr: int) -> bytes:
        b = self.src.read(addr, 8 + 2 * self.L + self.O)
        if b[:4] != b"HEAP" or b[4] != 0:
            self.fail(f"no local heap (HEAP, version 0) at {addr}")
        size, data = _u(b, 8, self.L), _u(b, 8 + 2 * self.L, self.O)
        return self.src.read(data, size)

    def btree_node(self, addr: int, node_type: int, key_size: int):
        """(level, keys, children) of the v1 B-tree node at ``addr``."""
        pre = self.src.read(addr, 8 + 2 * self.O)
        if pre[:4] != b"TREE" or pre[4] != node_type:
            self.fail(f"no v1 B-tree node of type {node_type} at {addr}")
        level, n = pre[5], _u(pre, 6, 2)
        body = self.src.read(addr + 8 + 2 * self.O, n * (key_size + self.O) + key_size)
        step = key_size + self.O
        keys = [body[i * step:i * step + key_size] for i in range(n + 1)]
        children = [_u(body, i * step + key_size, self.O) for i in range(n)]
        return level, keys, children

    def symbol_table(self, btree: int, heap_addr: int) -> Dict[str, object]:
        """A symbol-table group's members: name -> object header address (or
        the reason it cannot be followed)."""
        heap = self.local_heap(heap_addr)

        def name_at(off):
            end = heap.index(b"\0", off)
            return heap[off:end].decode("utf-8")

        members: Dict[str, object] = {}
        stack = [btree]
        while stack:
            level, _, children = self.btree_node(stack.pop(), 0, self.L)
            if level > 0:
                stack.extend(reversed(children))
                continue
            for snod in children:
                pre = self.src.read(snod, 8)
                if pre[:4] != b"SNOD" or pre[4] != 1:
                    self.fail(f"no symbol table node (SNOD, version 1) at {snod}")
                n = _u(pre, 6, 2)
                entry = 2 * self.O + 24
                data = self.src.read(snod + 8, n * entry)
                for i in range(n):
                    e = data[i * entry:(i + 1) * entry]
                    name = name_at(_u(e, 0, self.O))
                    cache = _u(e, 2 * self.O, 4)
                    members[name] = (_u(e, self.O, self.O) if cache != 2
                                     else "a soft link")
        return members

    def links(self, msgs) -> Dict[str, object]:
        """A new-style group's compact links (link messages)."""
        members: Dict[str, object] = {}
        for mtype, _, b in msgs:
            if mtype == 0x0002:
                p = 2 + (8 if b[1] & 1 else 0)
                if _u(b, p, self.O) != self.undef:
                    self.fail("dense link storage (fractal heap): not supported")
            elif mtype == 0x0006:
                flags, p = b[1], 2
                kind = 0
                if flags & 0x08:
                    kind, p = b[p], p + 1
                if flags & 0x04:
                    p += 8
                if flags & 0x10:
                    p += 1
                width = 1 << (flags & 0x03)
                n = _u(b, p, width)
                p += width
                name = b[p:p + n].decode("utf-8")
                p += n
                members[name] = (_u(b, p, self.O) if kind == 0 else
                                 "a soft link" if kind == 1 else "an external link"
                                 if kind == 64 else f"a link of type {kind}")
        return members

    def open(self, addr: int, name: str):
        obj = self.objects.get(addr)
        if obj is None:
            msgs = self.header(addr)
            types = {m[0] for m in msgs}
            if 0x0011 in types:
                b = next(m[2] for m in msgs if m[0] == 0x0011)
                obj = Group(self, name, self.symbol_table(_u(b, 0, self.O),
                                                          _u(b, self.O, self.O)), msgs)
            elif 0x0002 in types or 0x0006 in types:
                obj = Group(self, name, self.links(msgs), msgs)
            elif 0x0008 in types:
                obj = Dataset(self, name, msgs, addr)
            else:
                self.fail(f"object {name!r} (header at {addr}) is neither a group nor a "
                          "dataset: not supported")
            self.objects[addr] = obj
        return obj


# --------------------------------------------------------------------------- #
# filters


def fletcher32(data) -> int:
    """HDF5's Fletcher-32 checksum (``H5_checksum_fletcher32``): big-endian
    16-bit words, sums folded after every 360 words."""
    buf = np.frombuffer(data, np.uint8)
    odd = len(buf) % 2
    words = (buf[: len(buf) - odd].reshape(-1, 2).astype(np.int64) * [256, 1]).sum(1)
    sum1 = sum2 = 0
    for start in range(0, len(words), 360):
        w = words[start:start + 360]
        t = len(w)
        sum2 += t * sum1 + int(((t - np.arange(t)) * w).sum())
        sum1 += int(w.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if odd:
        sum1 += int(buf[-1]) << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def unshuffle(data, elsize: int) -> bytes:
    """The shuffle filter's inverse: byte plane j holds byte j of every
    element; the bytes past the last whole element are kept as they are."""
    buf = np.frombuffer(data, np.uint8)
    n = len(buf) // elsize
    if elsize <= 1 or n <= 1:
        return bytes(data)
    out = np.empty(len(buf), np.uint8)
    out[: n * elsize].reshape(n, elsize)[:] = buf[: n * elsize].reshape(elsize, n).T
    out[n * elsize:] = buf[n * elsize:]
    return out.tobytes()


# --------------------------------------------------------------------------- #
# objects


class _Node:
    def __init__(self, reader: _Reader, name: str, msgs):
        self._r, self.name, self._msgs = reader, name, msgs
        self._attrs = None

    @property
    def attrs(self) -> Dict[str, object]:
        """The attributes, by name (read at first use)."""
        if self._attrs is None:
            self._attrs = self._r.attributes(self._msgs)
        return self._attrs

    @property
    def filename(self) -> str:
        return self._r.src.path


class Group(_Node):
    """A group: ``g["a/b"]``, ``keys()``, ``len()``, ``in``."""

    def __init__(self, reader: _Reader, name: str, members: Dict[str, object], msgs):
        super().__init__(reader, name, msgs)
        self._members = members

    def keys(self) -> List[str]:
        return sorted(self._members)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._members)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group):
                raise KeyError(f"{self.filename}: {node.name!r} is not a group")
            if part not in node._members:
                raise KeyError(f"{self.filename}: no object {part!r} in {node.name!r}")
            target = node._members[part]
            sub = node.name.rstrip("/") + "/" + part
            if isinstance(target, str):
                self._r.fail(f"{sub!r} is {target}: not supported")
            node = self._r.open(target, sub)
        return node

    def __repr__(self):
        return f"<HDF5 group {self.name!r} ({len(self)} members) in {self.filename}>"


class Dataset(_Node):
    """A dataset: ``shape``, ``dtype``, ``attrs`` and reads on the first axis
    (``ds[:]``, ``ds[()]``, ``ds[i]``, ``ds[a:b]``)."""

    def __init__(self, reader: _Reader, name: str, msgs, addr: int):
        super().__init__(reader, name, msgs)
        self._header = addr  # its key in the file's chunk LRU
        fail = lambda what: reader.fail(f"dataset {name!r}: {what}")  # noqa: E731
        by_type = {}
        for mtype, _, b in msgs:
            by_type.setdefault(mtype, b)
        if 0x0007 in by_type:
            fail("external storage (data in other files): not supported")
        self.shape = reader.dataspace(by_type[0x0001])
        typ, _ = reader.datatype(by_type[0x0003])
        if typ.vlen_str:
            fail("variable-length strings in a dataset: not supported")
        self.dtype = typ.dtype
        self._fill = reader.fill(msgs)
        self.filters = self._pipeline(by_type.get(0x000B), fail)
        self._layout(by_type[0x0008], fail)

    # -- layout and filters -------------------------------------------------- #

    def _pipeline(self, b: Optional[bytes], fail) -> List[Tuple[int, int, Tuple[int, ...]]]:
        """[(filter id, flags, client data)] in the order they were applied."""
        if b is None:
            return []
        version, n = b[0], b[1]
        if version not in (1, 2):
            fail(f"filter pipeline message version {version}: not supported")
        p, out = (8 if version == 1 else 2), []
        for _ in range(n):
            fid = _u(b, p, 2)
            p += 2
            n_name = 0
            if version == 1 or fid >= 256:
                n_name = _u(b, p, 2)
                p += 2
            flags, n_cd = _u(b, p, 2), _u(b, p + 2, 2)
            p += 4
            name = b[p:p + n_name].rstrip(b"\0").decode("ascii", "replace")
            p += -(-n_name // 8) * 8 if version == 1 else n_name
            cd = tuple(_u(b, p + 4 * i, 4) for i in range(n_cd))
            p += 4 * n_cd + (4 if version == 1 and n_cd % 2 else 0)
            if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32):
                label = FILTER_NAMES.get(fid) or name or "unknown"
                fail(f"filter {fid} ({label}): not supported")
            out.append((fid, flags, cd))
        return out

    def _layout(self, b: bytes, fail) -> None:
        r = self._r
        version = b[0]
        self._addr, self._compact = r.undef, None
        if version in (1, 2):
            rank, cls = b[1], b[2]
            p = 8
            if cls != 0:
                self._addr = _u(b, p, r.O)
                p += r.O
            dims = tuple(_u(b, p + 4 * i, 4) for i in range(rank))
            p += 4 * rank
            if cls == 0:
                self._compact = b[p + 4:p + 4 + _u(b, p, 4)]
            elif cls == 2:
                self.chunks = dims[:-1]
        elif version in (3, 4):
            cls = b[1]
            if cls == 0:
                self._compact = b[4:4 + _u(b, 2, 2)]
            elif cls == 1:
                self._addr = _u(b, 2, r.O)
            elif cls == 2 and version == 3:
                rank = b[2]
                self._addr = _u(b, 3, r.O)
                self.chunks = tuple(_u(b, 3 + r.O + 4 * i, 4) for i in range(rank))[:-1]
            elif cls == 2:
                index = b[5 + b[3] * b[4]]
                fail(f"chunk index {CHUNK_INDEXES.get(index, index)} (layout version 4): "
                     "only the v1 B-tree is supported")
            elif cls == 3:
                fail("virtual dataset layout: not supported")
            else:
                fail(f"layout class {cls}: not supported")
        else:
            fail(f"layout message version {version}: not supported")
        self.layout = {0: "compact", 1: "contiguous", 2: "chunked"}[cls]
        if cls != 2:
            self.chunks = None
            if self.filters:
                fail(f"filters on a {self.layout} dataset")
        elif len(self.chunks) != len(self.shape):
            fail(f"chunks of rank {len(self.chunks)} for a dataset of rank {len(self.shape)}")
        else:
            self._read_chunk_index()

    def _read_chunk_index(self) -> None:
        """Every chunk's offset, address, stored size and filter mask, from
        the v1 B-tree (type 1), into arrays."""
        r, rank = self._r, len(self.shape)
        key = 8 + 8 * (rank + 1)
        offsets, addrs, sizes, masks = [], [], [], []
        if self._addr != r.undef:
            stack = [self._addr]
            while stack:
                level, keys, children = r.btree_node(stack.pop(), 1, key)
                if level > 0:
                    stack.extend(reversed(children))
                    continue
                for k, child in zip(keys, children):
                    sizes.append(_u(k, 0, 4))
                    masks.append(_u(k, 4, 4))
                    offsets.append([_u(k, 8 + 8 * i, 8) for i in range(rank)])
                    addrs.append(child)
        self._offsets = np.asarray(offsets, np.int64).reshape(-1, rank)
        self._addrs = np.asarray(addrs, np.int64)
        self._sizes = np.asarray(sizes, np.int64)
        self._masks = np.asarray(masks, np.int64)

    @property
    def n_chunks(self) -> int:
        return len(self._addrs) if self.chunks is not None else 0

    # -- reads --------------------------------------------------------------- #

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError(f"{self.name!r} is a scalar dataset")
        return self.shape[0]

    def __getitem__(self, key):
        if key is Ellipsis or key == () or key == (Ellipsis,):
            if not self.shape:
                return self._rows(0, 1)[()]
            return self._rows(0, self.shape[0])
        if isinstance(key, tuple) and len(key) == 1:
            key = key[0]
        if not self.shape:
            raise TypeError(f"{self.filename}: scalar dataset {self.name!r} takes [()]")
        if isinstance(key, slice):
            start, stop, step = key.indices(self.shape[0])
            if step != 1:
                raise TypeError(f"{self.filename}: {self.name!r}: only unit-step slices "
                                "are read")
            return self._rows(start, max(start, stop))
        if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
            i = int(key) + (self.shape[0] if key < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {int(key)} out of range for {self.shape[0]} rows")
            return self._rows(i, i + 1)[0]
        raise TypeError(f"{self.filename}: {self.name!r}: selection {key!r} is not read "
                        "(an int, a unit-step slice on the first axis, : or ())")

    def _empty(self, shape) -> np.ndarray:
        if self._fill is None or not any(self._fill):
            return np.zeros(shape, self.dtype)
        return np.full(shape, np.frombuffer(self._fill, self.dtype)[0], self.dtype)

    def _rows(self, a: int, b: int) -> np.ndarray:
        """Rows [a, b) of the first axis (the whole scalar for rank 0)."""
        scalar = not self.shape
        shape = (1,) if scalar else (b - a,) + self.shape[1:]
        row_elems = int(np.prod(self.shape[1:], dtype=np.int64))
        if self._compact is not None:
            out = np.frombuffer(self._compact, self.dtype)[a * row_elems:b * row_elems]
            out = out.reshape(shape).copy()
        elif self.chunks is None:
            if self._addr == self._r.undef or b <= a:
                out = self._empty(shape)
            else:
                out = np.empty(shape, self.dtype)
                self._r.src.read_into(self._addr + a * row_elems * self.dtype.itemsize, out)
        else:
            out = self._empty(shape)
            if b > a:
                self._gather(out, a, b, keep=not scalar and (a, b) != (0, self.shape[0]))
        return out.reshape(()) if scalar else out

    def _gather(self, out: np.ndarray, a: int, b: int, keep: bool) -> None:
        """Rows [a, b) into ``out`` from the chunks that overlap them; those
        of a partial read (``keep``) through the file's LRU."""
        c0 = self.chunks[0]
        first = self._offsets[:, 0]
        for k in np.flatnonzero((first < b) & (first + c0 > a)):
            o = self._offsets[k]
            chunk = self._chunk(int(k), keep)
            r0, r1 = max(a, int(o[0])), min(b, int(o[0]) + c0)
            dst = [slice(r0 - a, r1 - a)]
            src = [slice(r0 - int(o[0]), r1 - int(o[0]))]
            for d in range(1, len(self.shape)):
                n = min(self.chunks[d], self.shape[d] - int(o[d]))
                dst.append(slice(int(o[d]), int(o[d]) + n))
                src.append(slice(0, n))
            out[tuple(dst)] = chunk[tuple(src)]

    def _chunk(self, k: int, keep: bool) -> np.ndarray:
        key = (self._header, k)
        chunk = self._r.cached_chunk(key)
        if chunk is None:
            chunk = self._decode(k)
            if keep:
                self._r.keep_chunk(key, chunk)
        return chunk

    def _decode(self, k: int) -> np.ndarray:
        """Chunk k, its filters undone (last applied first, those its mask
        skipped left out), as an array of the chunk's shape."""
        data = self._r.src.read(int(self._addrs[k]), int(self._sizes[k]))
        mask = int(self._masks[k])
        where = f"dataset {self.name!r}, chunk at {tuple(self._offsets[k])}"
        for j in reversed(range(len(self.filters))):
            if mask >> j & 1:
                continue
            fid, _, cd = self.filters[j]
            if fid == FILTER_DEFLATE:
                try:
                    data = zlib.decompress(data)
                except zlib.error as e:
                    self._r.fail(f"{where}: deflate failed ({e})")
            elif fid == FILTER_SHUFFLE:
                data = unshuffle(data, cd[0] if cd else self.dtype.itemsize)
            elif fid == FILTER_FLETCHER32:
                if len(data) < 4:
                    self._r.fail(f"{where}: no room for a fletcher32 checksum")
                body, stored = data[:-4], _u(data, len(data) - 4, 4)
                want = fletcher32(body)
                swapped = ((want & 0xFF) << 24 | (want & 0xFF00) << 8
                           | (want >> 8) & 0xFF00 | want >> 24)
                if stored not in (want, swapped):
                    self._r.fail(f"{where}: fletcher32 checksum 0x{stored:08x}, computed "
                                 f"0x{want:08x}")
                data = body
        n = int(np.prod(self.chunks, dtype=np.int64)) * self.dtype.itemsize
        if len(data) != n:
            self._r.fail(f"{where}: {len(data)} bytes after the filters, {n} expected")
        return np.frombuffer(data, self.dtype).reshape(self.chunks)

    def __repr__(self):
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, {self.dtype} in {self.filename}>"


# --------------------------------------------------------------------------- #
# the file


def find_superblock(path: str) -> Optional[int]:
    """The superblock's offset: the first of 0, 512, 1024, 2048, ... that
    holds the signature (the format lets a user block precede it), or None."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        off = 0
        while off + 8 <= size:
            if os.pread(f.fileno(), 8, off) == SIGNATURE:
                return off
            off = 512 if off == 0 else 2 * off
    return None


def is_hdf5(path: str) -> bool:
    """Whether ``path`` is a file that :class:`File` finds a superblock in."""
    try:
        return find_superblock(path) is not None
    except OSError:
        return False


class File(Group):
    """An HDF5 file, read-only: the root group, with ``attrs``."""

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"{path}: this reader opens files read-only (mode 'r'), not "
                             f"{mode!r}; hdf5_write writes them")
        src = _Source(os.fspath(path))
        base = find_superblock(src.path)
        if base is None:
            raise HDF5Error(f"{path}: no HDF5 signature at offset 0, 512, 1024, ...: not an "
                            "HDF5 file")
        head = src.read(base, 24)
        version = head[8]
        if version not in (0, 1):
            src.close()
            raise HDF5Error(f"{path}: superblock version {version} (written with libver "
                            "'v108' or later): only versions 0 and 1 are supported")
        O, L = head[13], head[14]
        if O not in (2, 4, 8) or L not in (2, 4, 8):
            src.close()
            raise HDF5Error(f"{path}: offsets of {O} and lengths of {L} bytes: not supported")
        p = 24 + (4 if version == 1 else 0)
        rest = src.read(base + p, 4 * O + 2 * O + 24)
        reader = _Reader(src, O, L)
        src.base = base  # addresses count from the superblock
        if _u(rest, 3 * O, O) != reader.undef:
            src.close()
            raise HDF5Error(f"{path}: a driver information block (multi or family file "
                            "driver): not supported")
        root = _u(rest, 4 * O + O, O)
        msgs = reader.header(root)
        if not any(m[0] in (0x0011, 0x0002, 0x0006) for m in msgs):
            reader.fail("the root object is not a group")
        g = reader.open(root, "/")
        super().__init__(reader, "/", g._members, msgs)
        reader.objects[root] = self

    def close(self) -> None:
        """Close the file's handle; a later read opens it again."""
        self._r.src.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return f"<HDF5 file {self.filename} ({len(self)} members)>"
