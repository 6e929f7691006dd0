"""The port's ROS1 bag reader and writer (``ebfi_tpu_torch.data.rosbag``) and
the native LZ4 frame decoder, on the CPU.

- ``write_bag`` -> ``Bag.read_messages`` round-trips with none, bz2 and lz4
  chunks and yields the messages of the duck-typed bag of
  ``tests/test_rosbag.py``; ``extract_bag`` gives the same clip, bit for
  bit, on the reader (vectorized) and on the duck-typed bag (per event), and
  the same as the JAX package's ``tools/rosbag_to_h5.py`` through
  ``tools/h5_to_npz.py``.
- The LZ4 decoder takes a frame built here by hand from the LZ4 frame and
  block format descriptions (overlapping matches, length extensions, a
  stored block, a block reaching into the previous one, every checksum),
  and refuses corrupted ones.
- Images are decoded as ``cv_bridge`` hands them on (cv2's conversions);
  an unknown message type or image encoding raises, naming it.
"""
import hashlib
import os
import struct
import sys

import cv2
import numpy as np
import pytest

from ebfi_tpu_torch import native
from ebfi_tpu_torch.data import rosbag as rb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from h5_to_npz import h5_to_npz  # noqa: E402
from rosbag_to_h5 import extract_bag as jax_extract_bag  # noqa: E402
from test_rosbag import FakeBag  # noqa: E402
from test_torch_ingest import assert_same_clip  # noqa: E402
import torch_threads  # noqa: F401,E402  (one intra-op thread per test process)


# ---------------------------------------------------------------------- xxHash32, LZ4

P1, P2, P3, P4, P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 as its specification states it."""
    n, i = len(data), 0
    lane = lambda j: struct.unpack_from("<I", data, j)[0]
    if n >= 16:
        v = [(seed + P1 + P2) & M32, (seed + P2) & M32, seed, (seed - P1) & M32]
        while n - i >= 16:
            for k in range(4):
                v[k] = (_rotl((v[k] + lane(i + 4 * k) * P2) & M32, 13) * P1) & M32
            i += 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & M32
    else:
        h = (seed + P5) & M32
    h = (h + n) & M32
    while n - i >= 4:
        h = (_rotl((h + lane(i) * P3) & M32, 17) * P4) & M32
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * P5) & M32, 11) * P1) & M32
        i += 1
    h ^= h >> 15
    h = (h * P2) & M32
    h ^= h >> 13
    h = (h * P3) & M32
    return h ^ (h >> 16)


def test_xxh32_known_values_and_native():
    assert xxh32(b"") == 0x02CC5D05 and xxh32(b"a") == 0x550D7456
    assert xxh32(b"abc") == 0x32D153FF
    data = bytes(np.random.default_rng(0).integers(0, 256, 1000, dtype=np.uint8))
    for n in (0, 1, 3, 4, 15, 16, 17, 31, 64, 999, 1000):
        for seed in (0, 1, 0x9E3779B1):
            assert native.xxh32(data[:n], seed) == xxh32(data[:n], seed), (n, seed)


def _len_ext(n):
    """The 255-run extension of a length field holding 15 or more."""
    n -= 15
    return b"\xff" * (n // 255) + bytes([n % 255])


def _sequence(literals: bytes, offset: int = 0, match: int = 0) -> bytes:
    """One LZ4 sequence: the token, literals and, with ``match`` >= 4, the
    offset and match length (a last sequence has literals only)."""
    lit, ml = len(literals), (match - 4 if match else 0)
    token = min(lit, 15) << 4 | (min(ml, 15) if match else 0)
    out = bytes([token]) + (_len_ext(lit) if lit >= 15 else b"") + literals
    if match:
        out += struct.pack("<H", offset) + (_len_ext(ml) if ml >= 15 else b"")
    return out


def hand_built_frame():
    """(frame, content): three blocks of a dependent-block frame with block
    and content checksums and the content size in the header."""
    blocks, content = [], b""
    # block 1: "ab" then a run of 10 copied from offset 2 (overlapping),
    # "xyz" and a 40-byte match at offset 3 (overlapping, match extension),
    # then 20 literals (literal extension) and the 5 literals closing it
    lits20 = bytes(range(65, 85))
    b1 = (_sequence(b"ab", 2, 10) + _sequence(b"xyz", 3, 40) + _sequence(lits20, 1, 4)
          + _sequence(b"12345"))
    c1 = b"ab" * 6 + b"xyz" * 14 + b"x" + lits20 + lits20[-1:] * 4 + b"12345"
    blocks.append((b1, False))
    content += c1
    # block 2 stored uncompressed
    c2 = b"stored block bytes"
    blocks.append((c2, True))
    content += c2
    # block 3 reaches back into blocks 1 and 2 (offset 30: 12 bytes of
    # block 2's end and 18 more)
    b3 = _sequence(b"", 30, 30) + _sequence(b"end!!")
    start = len(content) - 30
    c3 = bytearray()
    for i in range(30):
        c3.append((content + bytes(c3))[start + i])
    c3 = bytes(c3) + b"end!!"
    blocks.append((b3, False))
    content += c3
    flg = 0x40 | 0x10 | 0x08 | 0x04  # version 01, dependent blocks, block + content sums, size
    desc = bytes([flg, 0x40]) + struct.pack("<Q", len(content))  # 64 KiB blocks
    out = struct.pack("<I", 0x184D2204) + desc + bytes([(xxh32(desc) >> 8) & 0xFF])
    for data, stored in blocks:
        out += struct.pack("<I", len(data) | (0x80000000 if stored else 0)) + data
        out += struct.pack("<I", xxh32(data))
    out += struct.pack("<I", 0) + struct.pack("<I", xxh32(content))
    return out, content


def test_lz4_frame_decoder_on_a_hand_built_frame():
    frame, content = hand_built_frame()
    assert content[:12] == b"abababababab" and content.endswith(b"end!!")
    assert native.lz4_frame_decode(frame, len(content)) == content
    # two frames back to back, with a skippable frame between them
    skip = struct.pack("<II", 0x184D2A53, 3) + b"???"
    assert native.lz4_frame_decode(frame + skip + frame, 2 * len(content)) == content * 2


@pytest.mark.parametrize("fault", ["header_sum", "block_sum", "content_sum", "magic", "offset",
                                   "truncated", "size"])
def test_lz4_frame_decoder_refuses_corrupt_frames(fault):
    frame, content = hand_built_frame()
    f, size = bytearray(frame), len(content)
    if fault == "header_sum":
        f[14] ^= 1
    elif fault == "block_sum":
        f[20] ^= 1  # a literal of block 1: its checksum no longer holds
    elif fault == "content_sum":
        f[-1] ^= 1
    elif fault == "magic":
        f[0] ^= 1
    elif fault == "truncated":
        f = f[:-9]
    elif fault == "size":
        size -= 1
    else:  # block 1's first match offset 2 -> 3: before the first byte
        f = bytearray(frame)
        pos = 15 + 4 + 1 + 2  # magic, descriptor, block size; token, "ab"
        assert f[pos : pos + 2] == b"\x02\x00"
        f[pos] = 3
    with pytest.raises(ValueError, match="LZ4 frame"):
        native.lz4_frame_decode(bytes(f), size)


# ---------------------------------------------------------------------- messages


def test_md5sums_are_the_published_ones():
    # genmsg's md5s of std_msgs/Header, sensor_msgs/Image, dvs_msgs/EventArray
    assert rb._HEADER_MD5 == "2176decaecbce78abc3b96ef049fabed"
    assert rb.MD5SUMS["sensor_msgs/Image"] == "060021388200f6f0f447d0fcd9c64743"
    event = hashlib.md5(b"uint16 x\nuint16 y\ntime ts\nbool polarity").hexdigest()
    assert rb.MD5SUMS["dvs_msgs/EventArray"] == hashlib.md5(
        f"{rb._HEADER_MD5} header\nuint32 height\nuint32 width\n{event} events".encode()
    ).hexdigest() == "5e8beee5a6c107e504c2e78903c224b8"


@pytest.mark.parametrize("encoding", ["mono8", "rgb8", "bgr8"])
@pytest.mark.parametrize("color", [False, True])
def test_image_to_array_matches_cv_bridge(rng, encoding, color):
    h, w, ch = 7, 9, rb.IMAGE_CHANNELS[encoding]
    px = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    step = w * ch + 3  # padded rows
    data = np.zeros((h, step), np.uint8)
    data[:, : w * ch] = px.reshape(h, -1)
    msg = rb.Image(rb.Header(), h, w, encoding, 0, step, data.tobytes())
    got = rb.image_to_array(msg, color)
    src = px[:, :, 0] if ch == 1 else px
    conv = {("mono8", True): cv2.COLOR_GRAY2BGR, ("rgb8", True): cv2.COLOR_RGB2BGR,
            ("rgb8", False): cv2.COLOR_RGB2GRAY, ("bgr8", False): cv2.COLOR_BGR2GRAY}
    key = (encoding, color)
    want = cv2.cvtColor(src, conv[key]) if key in conv else src
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_unknown_encoding_raises_and_names_it():
    msg = rb.Image(rb.Header(), 2, 2, "bayer_rggb8", 0, 2, bytes(4))
    with pytest.raises(ValueError, match="bayer_rggb8"):
        rb.image_to_array(msg, False)


# ---------------------------------------------------------------------- bags


def to_messages(bag, color=False):
    """FakeBag's messages as the reader's types, each record stamped with
    its header stamp (the image's) or its last event's time."""
    out = []
    for topic, msg, _ in bag.msgs:
        if topic == "/dvs/events":
            ev = msg.events
            stamp = rb.Time(ev[0].ts.secs, ev[0].ts.nsecs)
            m = rb.EventArray.from_arrays(
                rb.Header(len(out), stamp, "dvs"), 16, 24, [e.x for e in ev], [e.y for e in ev],
                [e.ts.secs for e in ev], [e.ts.nsecs for e in ev], [e.polarity for e in ev])
            t = rb.Time(ev[-1].ts.secs, ev[-1].ts.nsecs)
        else:
            stamp = rb.Time(msg.header.stamp.secs, msg.header.stamp.nsecs)
            data = msg.data if not color else np.repeat(msg.data[:, :, None], 3, axis=2)
            m = rb.Image.from_array(rb.Header(len(out), stamp, "cam"), data,
                                    "bgr8" if color else "mono8")
            t = stamp
        out.append((topic, m, t))
    return out


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_write_bag_round_trip_and_extract(tmp_path, compression):
    fake = FakeBag(np.random.default_rng(5), H=16, W=24, n_imgs=5, events_per_msg=400)
    messages = to_messages(fake)
    path = str(tmp_path / "rec.bag")
    rb.write_bag(path, messages, compression=compression, chunk_threshold=4096)
    with rb.Bag(path) as bag:
        assert len(bag.chunks) > 3 and {c.compression for c in bag.chunks} == {compression}
        got = list(bag.read_messages())
        assert [(t, tp) for tp, _, t in got] == [(t, tp) for tp, _, t in messages]
        for (topic, m, _), (_, want, _), (_, duck, _) in zip(got, messages, fake.msgs):
            assert m.header == want.header
            if topic == "/dvs/events":
                assert m.array.tobytes() == want.array.tobytes()
                assert m.events == [rb.Event(e.x, e.y, rb.Time(e.ts.secs, e.ts.nsecs),
                                             e.polarity) for e in duck.events]
            else:
                assert np.array_equal(rb.image_to_array(m, False), duck.data)
        kw = dict(event_topic="/dvs/events", image_topic="/dvs/image_raw", zero_timestamps=True,
                  start_time=0.05, end_time=0.35)
        stats = rb.extract_bag(bag, str(tmp_path / "reader.npz"), **kw)
    duck_stats = rb.extract_bag(fake, str(tmp_path / "duck.npz"),
                                imgmsg_to_array=lambda msg, color: msg.data, **kw)
    jax_stats = jax_extract_bag(fake, str(tmp_path / "jax.h5"),
                                imgmsg_to_array=lambda msg, color: msg.data, **kw)
    assert stats == duck_stats == jax_stats
    assert_same_clip(str(tmp_path / "reader.npz"), str(tmp_path / "duck.npz"))
    assert_same_clip(str(tmp_path / "reader.npz"),
                     h5_to_npz(str(tmp_path / "jax.h5"), str(tmp_path / "npz")))


def test_colour_bag_through_the_ingest_cli(tmp_path):
    """A bgr8 recording through ``python -m ebfi_tpu_torch.data.ingest bag``
    with ``--is_color``: the images as stored, the size from them."""
    from ebfi_tpu_torch.data import ingest

    fake = FakeBag(np.random.default_rng(6), H=16, W=24, n_imgs=4, events_per_msg=100)
    d = tmp_path / "bags"
    d.mkdir()
    rb.write_bag(str(d / "one.bag"), to_messages(fake, color=True), compression="bz2")
    assert ingest.main(["bag", str(d), "--output_dir", str(tmp_path / "out"), "--image_topic",
                        "/dvs/image_raw", "--is_color", "--height", "99", "--width", "99"]) == 0
    clip = np.load(tmp_path / "out" / "one.npz")
    assert clip["images"].shape == (4, 16, 24, 3)
    assert list(clip["sensor_resolution"]) == [16, 24]
    want = np.stack([np.repeat(m.data[:, :, None], 3, axis=2)
                     for t, m, _ in fake.msgs if t == "/dvs/image_raw"])
    assert np.array_equal(clip["images"], want)


def test_read_messages_orders_by_time_ties_in_file_order(tmp_path):
    img = lambda k: rb.Image.from_array(rb.Header(k), np.full((2, 3), k, np.uint8), "mono8")
    t = lambda s: rb.Time(s, 0)
    written = [("/a", img(0), t(5)), ("/b", img(1), t(3)), ("/a", img(2), t(3)),
               ("/b", img(3), t(1)), ("/a", img(4), t(5)), ("/b", img(5), t(5))]
    path = str(tmp_path / "order.bag")
    rb.write_bag(path, written, compression="none", chunk_threshold=100)  # a chunk or two each
    with rb.Bag(path) as bag:
        seqs = [m.header.seq for _, m, _ in bag.read_messages()]
        only_b = [m.header.seq for _, m, _ in bag.read_messages(topics=["/b"])]
    assert seqs == [3, 1, 2, 0, 4, 5] and only_b == [3, 1, 5]


def test_unknown_message_type_raises_and_names_it(tmp_path, monkeypatch):
    class Imu:
        pass

    path = str(tmp_path / "imu.bag")
    with monkeypatch.context() as m:  # a writer that knows one more type
        m.setitem(rb.TYPES, Imu, "sensor_msgs/Imu")
        m.setitem(rb.MD5SUMS, "sensor_msgs/Imu", "0" * 32)
        m.setitem(rb.DEFINITIONS, "sensor_msgs/Imu", "float64[9] orientation_covariance\n")
        real = rb.serialize
        m.setattr(rb, "serialize", lambda msg: bytes(72) if isinstance(msg, Imu) else real(msg))
        rb.write_bag(path, [("/dvs/imu", Imu(), rb.Time(1, 0)),
                            ("/dvs/image_raw", rb.Image.from_array(
                                rb.Header(), np.zeros((2, 2), np.uint8), "mono8"),
                             rb.Time(2, 0))])
    with rb.Bag(path) as bag:
        with pytest.raises(ValueError, match="sensor_msgs/Imu"):
            next(bag.read_messages())
        # extract_bag asks for its topics only
        stats = rb.extract_bag(bag, str(tmp_path / "c.npz"), "/dvs/events", "/dvs/image_raw")
    assert stats["num_images"] == 1 and stats["num_events"] == 0
    with pytest.raises(ValueError, match="sensor_msgs/Imu"):
        rb.deserialize("sensor_msgs/Imu", bytes(72))


def test_not_a_bag_raises(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"#ROSBAG V1.2\n" + bytes(100))
    with pytest.raises(ValueError, match="format 2.0"):
        rb.Bag(str(p))
