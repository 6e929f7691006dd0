"""DAVIS recordings in ROS1 bags (format 2.0) -> ``ebfi_clip_npz/1`` clips.

A reader of the port's own, on ``struct`` and numpy, replaces the ROS
runtime (``rosbag``, ``cv_bridge``), which the card machine does not have:

- :class:`Bag` reads the bag header, chunk, connection, message data, index
  data and chunk info records.  Chunks come uncompressed, in ``bz2``
  (the standard library) or in ``lz4`` (LZ4 frames, decoded by the native
  host plane, :func:`ebfi_tpu_torch.native.lz4_frame_decode`).
  :meth:`Bag.read_messages` yields ``(topic, msg, t)`` ordered by the
  record's time, ties in file order, as ``rosbag.Bag.read_messages`` does.
- Two message types are deserialized: ``dvs_msgs/EventArray`` (its events
  decoded in one structured view of the 13-byte ``Event`` records, no
  per-event Python) and ``sensor_msgs/Image`` (``mono8``, ``rgb8``,
  ``bgr8``; :func:`image_to_array` hands them on as ``cv_bridge`` does).
  Any other message type or image encoding raises and names it.
- :func:`write_bag` writes such bags (test and smoke-run fixtures, the
  counterpart of :func:`~ebfi_tpu_torch.data.synth.write_clip_npz`): its
  ``lz4`` chunks hold literal-only blocks, valid frames that do not
  compress.
- :func:`extract_bag` is ``tools/rosbag_to_h5.py::extract_bag`` of the JAX
  package writing the npz clip through
  :func:`~ebfi_tpu_torch.data.packager.package_sequence`: the same
  timestamps, window, polarities, sensor size and image order.  It takes
  this reader (events decoded vectorized) or any bag object whose
  ``read_messages()`` yields ``(topic, msg, t)`` with ``msg.events`` of
  ``x, y, ts.secs, ts.nsecs, polarity`` (per-event, as the JAX code).
"""
from __future__ import annotations

import bz2
import hashlib
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .packager import package_sequence

VERSION_LINE = b"#ROSBAG V2.0\n"
OP_MSG_DATA, OP_BAG_HEADER, OP_INDEX_DATA, OP_CHUNK, OP_CHUNK_INFO, OP_CONNECTION = (
    0x02, 0x03, 0x04, 0x05, 0x06, 0x07)
BAG_HEADER_LENGTH = 4096  # the bag header record is padded to this many bytes
CHUNK_THRESHOLD = 768 * 1024  # rosbag's default uncompressed chunk size

# one dvs_msgs/Event as serialized: u16 x, u16 y, time ts (u32 secs, u32 nsecs), bool polarity
EVENT_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"), ("secs", "<u4"), ("nsecs", "<u4"),
                        ("polarity", "u1")])
IMAGE_CHANNELS = {"mono8": 1, "rgb8": 3, "bgr8": 3}

_HEADER_DEF = "uint32 seq\ntime stamp\nstring frame_id\n"
_EVENT_DEF = "uint16 x\nuint16 y\ntime ts\nbool polarity\n"
_SEP = "=" * 80 + "\n"
DEFINITIONS = {
    "dvs_msgs/EventArray": (
        "Header header\nuint32 height\nuint32 width\ndvs_msgs/Event[] events\n"
        + _SEP + "MSG: std_msgs/Header\n" + _HEADER_DEF + _SEP + "MSG: dvs_msgs/Event\n"
        + _EVENT_DEF),
    "sensor_msgs/Image": (
        "Header header\nuint32 height\nuint32 width\nstring encoding\nuint8 is_bigendian\n"
        "uint32 step\nuint8[] data\n" + _SEP + "MSG: std_msgs/Header\n" + _HEADER_DEF),
}


def _md5(text: str) -> str:
    return hashlib.md5(text.encode()).hexdigest()


# ROS's md5 of a type: its fields' text, each message-typed field written as
# that type's md5 (genmsg's compute_md5_text)
_HEADER_MD5 = _md5(_HEADER_DEF.strip())
MD5SUMS = {
    "dvs_msgs/EventArray": _md5(f"{_HEADER_MD5} header\nuint32 height\nuint32 width\n"
                                f"{_md5(_EVENT_DEF.strip())} events"),
    "sensor_msgs/Image": _md5(f"{_HEADER_MD5} header\nuint32 height\nuint32 width\n"
                              "string encoding\nuint8 is_bigendian\nuint32 step\nuint8[] data"),
}


# ---------------------------------------------------------------------- messages


@dataclass(frozen=True, order=True)
class Time:
    """ROS time: whole seconds and nanoseconds."""

    secs: int
    nsecs: int


def timestamp_float(ts) -> float:
    """ROS time -> float seconds, ``secs + nsecs / 1e9`` (rosbag_to_h5.py:21-22)."""
    return ts.secs + ts.nsecs / float(1e9)


@dataclass
class Header:
    seq: int = 0
    stamp: Time = Time(0, 0)
    frame_id: str = ""


@dataclass
class Event:
    x: int
    y: int
    ts: Time
    polarity: bool


@dataclass
class EventArray:
    """``dvs_msgs/EventArray``; ``array`` holds the events in
    :data:`EVENT_DTYPE`, ``events`` lists them as ``Event`` objects (the
    per-event view that duck-typed code reads)."""

    header: Header
    height: int
    width: int
    array: np.ndarray

    @property
    def events(self) -> List[Event]:
        a = self.array
        return [Event(int(x), int(y), Time(int(s), int(n)), bool(p)) for x, y, s, n, p in
                zip(a["x"], a["y"], a["secs"], a["nsecs"], a["polarity"])]

    @staticmethod
    def from_arrays(header: Header, height: int, width: int, x, y, secs, nsecs,
                    polarity) -> "EventArray":
        a = np.empty(len(x), EVENT_DTYPE)
        a["x"], a["y"], a["secs"], a["nsecs"] = x, y, secs, nsecs
        a["polarity"] = np.asarray(polarity) != 0
        return EventArray(header, height, width, a)


@dataclass
class Image:
    """``sensor_msgs/Image``: ``data`` holds ``height`` rows of ``step`` bytes."""

    header: Header
    height: int
    width: int
    encoding: str
    is_bigendian: int
    step: int
    data: bytes

    @staticmethod
    def from_array(header: Header, pixels: np.ndarray, encoding: str) -> "Image":
        pixels = np.ascontiguousarray(pixels, np.uint8)
        h, w = pixels.shape[:2]
        return Image(header, h, w, encoding, 0, pixels.nbytes // max(h, 1), pixels.tobytes())


TYPES = {EventArray: "dvs_msgs/EventArray", Image: "sensor_msgs/Image"}


def image_to_array(msg, color: bool) -> np.ndarray:
    """Pixels of a ``mono8``, ``rgb8`` or ``bgr8`` image message as
    ``cv_bridge``'s ``imgmsg_to_cv2(msg, "bgr8" if color else "mono8")``
    gives them: (H, W, 3) BGR, or (H, W) grey by OpenCV's fixed-point
    ``RGB2GRAY``/``BGR2GRAY`` weights."""
    channels = IMAGE_CHANNELS.get(msg.encoding)
    if channels is None:
        raise ValueError(f"image encoding {msg.encoding!r} is not read (only "
                         f"{', '.join(IMAGE_CHANNELS)})")
    h, w, step = int(msg.height), int(msg.width), int(msg.step)
    if step < w * channels:
        raise ValueError(f"image step {step} is shorter than a row of {w} x {channels} bytes")
    rows = np.frombuffer(bytes(msg.data), np.uint8, count=h * step).reshape(h, step)
    px = rows[:, : w * channels].reshape(h, w, channels)
    if color:
        if channels == 1:
            return np.repeat(px, 3, axis=2)
        return (px[:, :, ::-1] if msg.encoding == "rgb8" else px).copy()
    if channels == 1:
        return px[:, :, 0].copy()
    r, g, b = (px[:, :, i].astype(np.int32) for i in ((0, 1, 2) if msg.encoding == "rgb8"
                                                        else (2, 1, 0)))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(np.uint8)


# ---------------------------------------------------------------------- serialization


def _read_string(buf, pos: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    if pos + n > len(buf):
        raise ValueError("truncated message: a string runs past its record")
    return bytes(buf[pos : pos + n]), pos + n


def _read_header(buf, pos: int) -> Tuple[Header, int]:
    seq, secs, nsecs = struct.unpack_from("<III", buf, pos)
    frame_id, pos = _read_string(buf, pos + 12)
    return Header(seq, Time(secs, nsecs), frame_id.decode()), pos


def _pack_string(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


def _pack_header(h: Header) -> bytes:
    return struct.pack("<III", h.seq, h.stamp.secs, h.stamp.nsecs) + _pack_string(
        h.frame_id.encode())


def deserialize(msg_type: str, buf) -> object:
    """One message of ``msg_type`` from its serialized bytes."""
    if msg_type == "dvs_msgs/EventArray":
        header, pos = _read_header(buf, 0)
        height, width, count = struct.unpack_from("<III", buf, pos)
        pos += 12
        if pos + count * EVENT_DTYPE.itemsize > len(buf):
            raise ValueError(f"truncated dvs_msgs/EventArray: {count} events do not fit")
        array = np.frombuffer(buf, EVENT_DTYPE, count=count, offset=pos).copy()
        return EventArray(header, height, width, array)
    if msg_type == "sensor_msgs/Image":
        header, pos = _read_header(buf, 0)
        height, width = struct.unpack_from("<II", buf, pos)
        encoding, pos = _read_string(buf, pos + 8)
        is_bigendian, step = struct.unpack_from("<BI", buf, pos)
        data, _ = _read_string(buf, pos + 5)
        return Image(header, height, width, encoding.decode(), is_bigendian, step, data)
    raise ValueError(f"message type {msg_type!r} is not read (only "
                     f"{', '.join(DEFINITIONS)})")


def serialize(msg) -> bytes:
    if isinstance(msg, EventArray):
        a = np.ascontiguousarray(msg.array, EVENT_DTYPE)
        return (_pack_header(msg.header) + struct.pack("<III", msg.height, msg.width, len(a))
                + a.tobytes())
    if isinstance(msg, Image):
        return (_pack_header(msg.header) + struct.pack("<II", msg.height, msg.width)
                + _pack_string(msg.encoding.encode())
                + struct.pack("<BI", msg.is_bigendian, msg.step) + _pack_string(bytes(msg.data)))
    raise ValueError(f"message of type {type(msg).__name__} is not written (only "
                     f"{', '.join(t.__name__ for t in TYPES)})")


# ---------------------------------------------------------------------- records


def _fields(buf: bytes) -> Dict[str, bytes]:
    """A record header's ``name=value`` fields."""
    out, pos = {}, 0
    while pos < len(buf):
        (n,) = struct.unpack_from("<I", buf, pos)
        name, eq, value = bytes(buf[pos + 4 : pos + 4 + n]).partition(b"=")
        if not eq or pos + 4 + n > len(buf):
            raise ValueError("malformed record header field")
        out[name.decode()] = value
        pos += 4 + n
    return out


def _pack_fields(fields: Dict[str, bytes]) -> bytes:
    return b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode() + b"=" + v
                    for k, v in fields.items())


def _record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _pack_fields(fields)
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


def _u8(v: int) -> bytes:
    return struct.pack("<B", v)


def _u32(v: int) -> bytes:
    return struct.pack("<I", v)


def _u64(v: int) -> bytes:
    return struct.pack("<Q", v)


def _time(t: Time) -> bytes:
    return struct.pack("<II", t.secs, t.nsecs)


def _get(fields: Dict[str, bytes], name: str, fmt: str):
    if name not in fields:
        raise ValueError(f"record header lacks the field {name!r}")
    return struct.unpack(fmt, fields[name])[0] if fmt else fields[name]


def _op(fields: Dict[str, bytes]) -> int:
    return _get(fields, "op", "<B")


def _read_record(f) -> Tuple[Dict[str, bytes], bytes]:
    (n,) = struct.unpack("<I", _read_exact(f, 4))
    fields = _fields(_read_exact(f, n))
    (m,) = struct.unpack("<I", _read_exact(f, 4))
    return fields, _read_exact(f, m)


def _read_exact(f, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise ValueError("truncated bag: a record runs past the end of the file")
    return b


@dataclass
class Connection:
    id: int
    topic: str
    type: str


@dataclass
class ChunkInfo:
    pos: int
    counts: Dict[int, int]
    compression: str = ""
    data_pos: int = 0
    data_len: int = 0
    size: int = 0


def _decompress(compression: str, data: bytes, size: int) -> bytes:
    if compression == "none":
        out = data
    elif compression == "bz2":
        out = bz2.decompress(data)
    elif compression == "lz4":
        from .. import native

        out = native.lz4_frame_decode(data, size)
    else:
        raise ValueError(f"chunk compression {compression!r} is not read (only none, bz2, lz4)")
    if len(out) != size:
        raise ValueError(f"a {compression} chunk decoded to {len(out)} bytes, {size} expected")
    return out


class Bag:
    """A ROS1 bag (format 2.0), read through its index.  ``with Bag(path) as
    bag:`` closes the file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._read_index()
        except BaseException:
            self._f.close()
            raise
        self._cache: Tuple[int, bytes] = (-1, b"")

    def __enter__(self) -> "Bag":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._f.close()

    def _read_index(self) -> None:
        f = self._f
        version = f.readline()
        if version != VERSION_LINE:
            raise ValueError(f"{self.path}: not a ROS bag of format 2.0 "
                             f"(first line {version[:40]!r})")
        fields, _ = _read_record(f)
        if _op(fields) != OP_BAG_HEADER:
            raise ValueError(f"{self.path}: the first record is not the bag header")
        index_pos = _get(fields, "index_pos", "<Q")
        conn_count = _get(fields, "conn_count", "<I")
        chunk_count = _get(fields, "chunk_count", "<I")
        if index_pos == 0:
            raise ValueError(f"{self.path}: the bag has no index (was it closed?); reindex it")
        f.seek(index_pos)
        self.connections: Dict[int, Connection] = {}
        for _ in range(conn_count):
            fields, data = _read_record(f)
            if _op(fields) != OP_CONNECTION:
                raise ValueError(f"{self.path}: expected a connection record at the index")
            c = _fields(data)
            cid = _get(fields, "conn", "<I")
            self.connections[cid] = Connection(
                cid, _get(fields, "topic", "").decode(), _get(c, "type", "").decode())
        self.chunks: List[ChunkInfo] = []
        for _ in range(chunk_count):
            fields, data = _read_record(f)
            if _op(fields) != OP_CHUNK_INFO:
                raise ValueError(f"{self.path}: expected a chunk info record at the index")
            pairs = np.frombuffer(data, "<u4").reshape(-1, 2)
            self.chunks.append(ChunkInfo(_get(fields, "chunk_pos", "<Q"),
                                         {int(a): int(b) for a, b in pairs}))
        # each chunk's own header, then its index data records (one per connection)
        entries = []  # (secs, nsecs, chunk number, offset, connection)
        for k, ch in enumerate(self.chunks):
            f.seek(ch.pos)
            (n,) = struct.unpack("<I", _read_exact(f, 4))
            fields = _fields(_read_exact(f, n))
            if _op(fields) != OP_CHUNK:
                raise ValueError(f"{self.path}: no chunk record at {ch.pos}")
            ch.compression = _get(fields, "compression", "").decode()
            ch.size = _get(fields, "size", "<I")
            (ch.data_len,) = struct.unpack("<I", _read_exact(f, 4))
            ch.data_pos = f.tell()
            f.seek(ch.data_len, 1)
            for _ in range(len(ch.counts)):
                fields, data = _read_record(f)
                if _op(fields) != OP_INDEX_DATA:
                    raise ValueError(f"{self.path}: expected an index data record after the "
                                     f"chunk at {ch.pos}")
                if _get(fields, "ver", "<I") != 1:
                    raise ValueError(f"{self.path}: index data version "
                                     f"{_get(fields, 'ver', '<I')} is not read")
                cid = _get(fields, "conn", "<I")
                idx = np.frombuffer(data, "<u4").reshape(-1, 3)  # secs, nsecs, offset
                entries += [(int(s), int(ns), k, int(o), cid) for s, ns, o in idx]
        entries.sort()  # by time; ties in file order (chunk, then offset in it)
        self._entries = entries

    def _chunk(self, k: int) -> bytes:
        if self._cache[0] != k:
            ch = self.chunks[k]
            self._f.seek(ch.data_pos)
            self._cache = (k, _decompress(ch.compression, _read_exact(self._f, ch.data_len),
                                          ch.size))
        return self._cache[1]

    def read_messages(self, topics: Optional[Sequence[str]] = None
                      ) -> Iterator[Tuple[str, object, Time]]:
        """(topic, message, record time) of the connections on ``topics``
        (all when None), by record time, ties in file order.  Raises before
        the first message when a selected connection's type is not read."""
        wanted = {cid: c for cid, c in self.connections.items()
                  if topics is None or c.topic in topics}
        for c in wanted.values():
            if c.type not in DEFINITIONS:
                raise ValueError(f"{self.path}: topic {c.topic!r} carries message type "
                                 f"{c.type!r}, which is not read (only "
                                 f"{', '.join(DEFINITIONS)}); pass topics=")
        for secs, nsecs, k, offset, cid in self._entries:
            c = wanted.get(cid)
            if c is None:
                continue
            buf = self._chunk(k)
            (n,) = struct.unpack_from("<I", buf, offset)
            fields = _fields(buf[offset + 4 : offset + 4 + n])
            (m,) = struct.unpack_from("<I", buf, offset + 4 + n)
            if _op(fields) != OP_MSG_DATA or _get(fields, "conn", "<I") != cid:
                raise ValueError(f"{self.path}: the index points at no message of "
                                 f"connection {cid}")
            start = offset + 8 + n
            yield c.topic, deserialize(c.type, memoryview(buf)[start : start + m]), Time(
                secs, nsecs)


# ---------------------------------------------------------------------- writer


def _lz4_literal_frame(data: bytes) -> bytes:
    """``data`` as one LZ4 frame of literal-only blocks (64 KiB each),
    independent, with the content checksum."""
    from .. import native

    desc = bytes([0x64, 0x70])  # version 1, independent blocks, content checksum; 4 MiB
    out = [struct.pack("<I", 0x184D2204), desc, bytes([(native.xxh32(desc) >> 8) & 0xFF])]
    for i in range(0, len(data), 1 << 16):
        lit = data[i : i + (1 << 16)]
        n = len(lit)
        ext = b"" if n < 15 else b"\xff" * ((n - 15) // 255) + bytes([(n - 15) % 255])
        block = bytes([min(n, 15) << 4]) + ext + lit
        out += [struct.pack("<I", len(block)), block]
    out += [struct.pack("<I", 0), struct.pack("<I", native.xxh32(data))]
    return b"".join(out)


COMPRESSORS = {"none": lambda b: b, "bz2": bz2.compress, "lz4": _lz4_literal_frame}


def write_bag(path: str, messages: Iterable[Tuple[str, object, Time]],
              compression: str = "bz2", chunk_threshold: int = CHUNK_THRESHOLD) -> None:
    """Write ``(topic, message, record time)`` in the given order, messages
    :class:`EventArray` or :class:`Image`, as a ROS1 bag (format 2.0) laid
    out as rosbag writes one: the bag header, chunks each followed by their
    index data records, then the connection and chunk info records."""
    if compression not in COMPRESSORS:
        raise ValueError(f"compression {compression!r}: one of {', '.join(COMPRESSORS)}")
    conns: Dict[str, Tuple[int, str]] = {}  # topic -> (id, type)
    chunks = []  # (pos, start, end, {conn: count})
    with open(path, "wb") as f:
        f.write(VERSION_LINE)
        f.write(b"\0" * BAG_HEADER_LENGTH)  # rewritten once the index is known
        buf = bytearray()
        index: Dict[int, List[bytes]] = {}
        times: List[Time] = []

        def flush():
            if not buf:
                return
            pos = f.tell()
            f.write(_record({"op": _u8(OP_CHUNK), "compression": compression.encode(),
                             "size": _u32(len(buf))}, COMPRESSORS[compression](bytes(buf))))
            for cid, rows in index.items():
                f.write(_record({"op": _u8(OP_INDEX_DATA), "ver": _u32(1), "conn": _u32(cid),
                                 "count": _u32(len(rows))}, b"".join(rows)))
            chunks.append((pos, min(times), max(times), {c: len(r) for c, r in index.items()}))
            buf.clear()
            index.clear()
            times.clear()

        for topic, msg, t in messages:
            msg_type = TYPES.get(type(msg))
            if msg_type is None:
                serialize(msg)  # raises, naming the type
            if topic not in conns:
                conns[topic] = (len(conns), msg_type)
                buf += _connection_record(len(conns) - 1, topic, msg_type)
            cid, known = conns[topic]
            if known != msg_type:
                raise ValueError(f"topic {topic!r} carries both {known} and {msg_type}")
            index.setdefault(cid, []).append(_time(t) + _u32(len(buf)))
            times.append(t)
            buf += _record({"op": _u8(OP_MSG_DATA), "conn": _u32(cid), "time": _time(t)},
                           serialize(msg))
            if len(buf) >= chunk_threshold:
                flush()
        flush()
        index_pos = f.tell()
        for topic, (cid, msg_type) in conns.items():
            f.write(_connection_record(cid, topic, msg_type))
        for pos, start, end, counts in chunks:
            f.write(_record({"op": _u8(OP_CHUNK_INFO), "ver": _u32(1), "chunk_pos": _u64(pos),
                             "start_time": _time(start), "end_time": _time(end),
                             "count": _u32(len(counts))},
                            b"".join(_u32(c) + _u32(n) for c, n in counts.items())))
        header = _pack_fields({"op": _u8(OP_BAG_HEADER), "index_pos": _u64(index_pos),
                               "conn_count": _u32(len(conns)), "chunk_count": _u32(len(chunks))})
        f.seek(len(VERSION_LINE))
        f.write(struct.pack("<I", len(header)) + header
                + struct.pack("<I", BAG_HEADER_LENGTH - 8 - len(header))
                + b" " * (BAG_HEADER_LENGTH - 8 - len(header)))


def _connection_record(cid: int, topic: str, msg_type: str) -> bytes:
    info = _pack_fields({"topic": topic.encode(), "type": msg_type.encode(),
                         "md5sum": MD5SUMS[msg_type].encode(),
                         "message_definition": DEFINITIONS[msg_type].encode()})
    return _record({"op": _u8(OP_CONNECTION), "conn": _u32(cid), "topic": topic.encode()}, info)


# ---------------------------------------------------------------------- extraction


@dataclass
class _Events:
    """Events in the window, gathered per message."""

    parts: List[Tuple[np.ndarray, ...]] = field(default_factory=list)
    num_pos: int = 0
    num_neg: int = 0
    last_ts: float = 0.0

    def add(self, xs, ys, ts, ps) -> None:
        if len(ts):
            self.parts.append((xs, ys, ts, ps))
            self.num_pos += int((ps > 0).sum())
            self.num_neg += int((ps <= 0).sum())
            self.last_ts = float(ts[-1])

    def arrays(self) -> Tuple[np.ndarray, ...]:
        if not self.parts:
            return tuple(np.zeros(0, np.float64) for _ in range(4))
        return tuple(np.concatenate([p[i] for p in self.parts]) for i in range(4))


def _first_stamp(msg) -> Time:
    if isinstance(msg, EventArray):  # the first event's stamp, without listing them all
        a = msg.array
        return Time(int(a["secs"][0]), int(a["nsecs"][0]))
    return msg.events[0].ts


def extract_bag(
    bag,
    output_path: str,
    event_topic: str,
    image_topic: Optional[str] = None,
    start_time: Optional[float] = None,
    end_time: Optional[float] = None,
    zero_timestamps: bool = False,
    is_color: bool = False,
    sensor_size=None,
    imgmsg_to_array=None,
) -> dict:
    """One bag -> one ``ebfi_clip_npz/1`` clip at ``output_path``
    (``tools/rosbag_to_h5.py:39-126``): event timestamps ``secs + nsecs /
    1e9`` in f64, offset to the first message of either topic with
    ``zero_timestamps``; the window ``[start_time, end_time]`` inclusive
    (``start_time`` defaults to 0 with ``zero_timestamps``, else to the
    first stamp); polarities +1 / -1; the sensor size from the images where
    there are any (over a given one), else the given one, else from the
    events; grey images repeated to 3 channels, images sorted by timestamp.
    ``imgmsg_to_array(msg, is_color)`` decodes images (default
    :func:`image_to_array`).  Returns the JAX function's summary."""
    decode = imgmsg_to_array or image_to_array
    topics = (event_topic, image_topic)
    first_ts = -1.0
    events = _Events()
    images = []  # (timestamp, array)
    if end_time is None:
        end_time = float("inf")
    if isinstance(bag, Bag):
        messages = bag.read_messages(topics=[t for t in topics if t is not None])
    else:
        messages = bag.read_messages()

    for topic, msg, _t in messages:
        if first_ts < 0 and topic in topics:
            stamp = _first_stamp(msg) if topic == event_topic else msg.header.stamp
            first_ts = timestamp_float(stamp)
            if start_time is None:
                start_time = 0.0 if zero_timestamps else first_ts
        offset = first_ts if zero_timestamps else 0.0
        if topic == image_topic:
            timestamp = timestamp_float(msg.header.stamp) - offset
            if start_time <= timestamp <= end_time:
                img = np.asarray(decode(msg, is_color))
                images.append((timestamp, img))
                sensor_size = img.shape[:2]
        elif topic == event_topic:
            if isinstance(msg, EventArray):
                a = msg.array
                ts = a["secs"].astype(np.float64) + a["nsecs"].astype(np.float64) / float(1e9)
                ts = ts - offset
                keep = (start_time <= ts) & (ts <= end_time)
                a = a[keep]
                events.add(a["x"].astype(np.float64), a["y"].astype(np.float64), ts[keep],
                           np.where(a["polarity"] != 0, 1.0, -1.0))
            else:
                rows = [(e.x, e.y, timestamp_float(e.ts) - offset, 1.0 if e.polarity else -1.0)
                        for e in msg.events]
                rows = [r for r in rows if start_time <= r[2] <= end_time]
                cols = np.asarray(rows, np.float64).reshape(-1, 4).T
                events.add(*cols)

    xs, ys, ts, ps = events.arrays()
    if sensor_size is None and len(xs):
        sensor_size = (int(ys.max()) + 1, int(xs.max()) + 1)
    if sensor_size is None:
        raise ValueError("no image, no event and no sensor size: nothing gives the clip's "
                         "resolution")
    H, W = (int(s) for s in sensor_size)
    frames, stamps = [], []
    for timestamp, img in sorted(images, key=lambda p_: p_[0]):
        frames.append(np.repeat(img[:, :, None], 3, axis=2) if img.ndim == 2 else img)
        stamps.append(timestamp)
    frames = np.stack(frames) if frames else np.zeros((0, H, W, 3), np.uint8)
    package_sequence(output_path, frames, stamps, (xs, ys, ts, ps), tuple(sensor_size))
    return {
        "num_events": len(xs),
        "num_pos": events.num_pos,
        "num_neg": events.num_neg,
        "num_images": len(images),
        "duration": (events.last_ts - (start_time or 0.0)) if len(xs) else 0.0,
        "sensor_size": tuple(sensor_size) if sensor_size else None,
    }
