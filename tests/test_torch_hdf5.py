"""The port's HDF5 reader and writer (``ebfi_tpu_torch/data/hdf5.py``,
``hdf5_write.py``) against h5py, on the CPU.

- The reader on files h5py writes: every layout, filter, datatype and
  attribute kind of its scope, equal to h5py's reads exactly (dtype,
  shape, value; tolerance 0).
- One error per feature outside the scope, naming it.
- The writer: h5py reads back every dataset and attribute equal, chunk
  shapes are h5py's own for the same shapes, and h5py can append to the
  file.

h5py is used here only, never by the port.
"""
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import h5py
import numpy as np
import pytest

from ebfi_tpu_torch.data import hdf5, hdf5_write
import torch_threads  # noqa: F401  (one intra-op thread per test process)

ROOT = Path(__file__).resolve().parents[1]


def _equal(got, want):
    """h5py's value and the reader's: the same type, dtype, shape, values."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        if want.dtype == object:
            assert got.tolist() == want.tolist()
        else:
            np.testing.assert_array_equal(got, want)
    elif isinstance(want, np.generic):
        assert got.dtype == want.dtype and got == want
    else:
        assert got == want


def _same_tree(ours, theirs):
    """Every member, dataset value and attribute of the two views, equal."""
    assert sorted(ours.attrs) == sorted(theirs.attrs)
    for k in theirs.attrs:
        _equal(ours.attrs[k], theirs.attrs[k])
    if isinstance(theirs, h5py.Dataset):
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
        _equal(ours[()], theirs[()])
        return
    assert ours.keys() == sorted(theirs.keys())
    for k in theirs:
        _same_tree(ours[k], theirs[k])


# ------------------------------------------------------------------ reader


def _compact(f, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(data.shape)
    d = h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype), space, dcpl=dcpl)
    d.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def _partial(f, name):
    d = f.create_dataset(name, shape=(50, 7), chunks=(8, 4), dtype=np.float32, fillvalue=2.5)
    d[9:20, 1:3] = -1.0  # the chunks of rows 8-23, columns 0-3 written; the rest never
    f.create_dataset(name + "_zero", shape=(100,), chunks=(16,), dtype=np.int16)[40:45] = 7


READER_FILES = {
    "contiguous": lambda f, r: f.create_dataset("x", data=r.integers(-9, 9, (13, 5)).astype("i4")),
    "compact": lambda f, r: _compact(f, "x", r.integers(0, 200, (6, 4)).astype("u1")),
    "chunked_raw": lambda f, r: f.create_dataset("x", data=r.normal(size=(37, 11)), chunks=(8, 4)),
    "gzip_1": lambda f, r: f.create_dataset("x", data=r.integers(0, 99, 5000).astype("i8"),
                                            compression="gzip", compression_opts=1),
    "gzip_9": lambda f, r: f.create_dataset("x", data=r.integers(0, 99, (40, 30, 3)).astype("u1"),
                                            compression="gzip", compression_opts=9),
    "shuffle_gzip": lambda f, r: f.create_dataset("x", data=r.normal(size=3001).astype("f4"),
                                                  compression="gzip", shuffle=True, chunks=(256,)),
    "fletcher32": lambda f, r: f.create_dataset("x", data=r.integers(0, 9, 1001).astype("i2"),
                                                fletcher32=True, chunks=(100,)),
    "fletcher32_gzip_odd": lambda f, r: f.create_dataset(
        "x", data=r.integers(0, 9, (17, 3)).astype("u1"), fletcher32=True, shuffle=True,
        compression="gzip", chunks=(5, 3)),
    "edge_chunks_3d": lambda f, r: f.create_dataset(
        "x", data=r.integers(0, 255, (45, 70, 3)).astype("u1"), chunks=(20, 32, 2),
        compression="gzip"),
    "partial": lambda f, r: _partial(f, "x"),
    "big_endian": lambda f, r: (
        f.create_dataset("x", data=np.arange(-500, 500, dtype=">i2"), compression="gzip"),
        f.create_dataset("y", data=r.normal(size=77).astype(">f8")),
        f.create_dataset("z", data=r.normal(size=(9, 9)).astype(">f8"), chunks=(4, 4),
                         shuffle=True, compression="gzip")),
    "scalars_and_strings": lambda f, r: (
        f.create_dataset("s", data=np.float32(3.5)),
        f.create_dataset("u8", data=np.arange(7, dtype=np.uint64)),
        f.create_dataset("fixed", data=np.array([b"ab", b"cde", b""])),
        f.create_dataset("empty", data=np.zeros(0, "i2"), compression="gzip")),
}


def _attrs(f):
    f.attrs["int"] = 5
    f.attrs["float"] = 2.5
    f.attrs["f32"] = np.float32(0.1)
    f.attrs["i8"] = np.int8(-3)
    f.attrs["array"] = np.arange(6, dtype=np.uint16).reshape(2, 3)
    f.attrs["tuple"] = (720, 1280, 3)
    f.attrs["be"] = np.array([1.5, -2.0], ">f8")
    f.attrs["fixed"] = np.bytes_("fixed")
    f.attrs["fixed_array"] = np.array([b"ab", b"cde"])
    f.attrs["vlen"] = "hello, wörld"
    f.attrs["vlen_empty"] = ""
    f.attrs["vlen_array"] = ["x", "yz", "ünï"]


@pytest.mark.parametrize("case", sorted(READER_FILES) + ["attributes"])
def test_reader_matches_h5py(tmp_path, case):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        if case == "attributes":
            _attrs(f)
            _attrs(f.create_dataset("d", data=[1, 2, 3]))
            _attrs(f.create_group("g"))
        else:
            READER_FILES[case](f, np.random.default_rng(len(case)))
    with h5py.File(path, "r") as want:
        got = hdf5.File(path)
        _same_tree(got, want)
        if case in ("chunked_raw", "gzip_9", "edge_chunks_3d", "partial", "shuffle_gzip"):
            ds, ref = got["x"], want["x"]
            assert ds.chunks == ref.chunks
            for i in (0, 1, ref.shape[0] // 2, ref.shape[0] - 1, -1):
                _equal(ds[i], ref[i])
            for a, b in ((0, 3), (5, 29), (ref.shape[0] - 2, ref.shape[0] + 5), (9, 4)):
                _equal(ds[a:b], ref[a:b])
            with pytest.raises(IndexError):
                ds[ref.shape[0]]


def test_partial_dataset_reads_the_fill_value(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        _partial(f, "x")
    got = hdf5.File(path)
    assert got["x"].n_chunks == 2  # rows 8-15 and 16-23 of columns 0-3
    x = got["x"][:]
    assert (x[:8] == 2.5).all() and (x[24:] == 2.5).all() and (x[9:20, 1:3] == -1).all()
    assert (x[8:24, 4:] == 2.5).all() and (x[8, :] == 2.5).all()
    assert got["x_zero"][:].sum() == 35 and got["x_zero"].n_chunks == 1


def test_attribute_added_in_append_mode_lands_in_a_continuation_block(tmp_path):
    """h5py's ``"a"`` mode (as ``tools/h5_utils.py add-attr`` uses it) puts a
    new attribute of a full object header in a continuation block."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=np.arange(10), compression="gzip")
        f.attrs["first"] = 1
    with h5py.File(path, "a") as f:
        f["d"].attrs["later"] = np.arange(40.0)
        f.attrs["later"] = "a string, later"
    got = hdf5.File(path)
    with h5py.File(path, "r") as want:
        _same_tree(got, want)
    # the dataset's header: its first block holds a continuation message
    r = got._r
    addr = next(a for a, o in r.objects.items() if o is got["d"])
    pre = r.src.read(addr, 16)
    block = r.src.read(addr + 16, hdf5._u(pre, 8, 4))
    types, p = [], 0
    while p + 8 <= len(block):
        types.append(hdf5._u(block, p, 2))
        p += 8 + hdf5._u(block, p + 2, 2)
    assert 0x0010 in types


@pytest.mark.parametrize("n", [600, 3000])
def test_group_of_many_members_has_a_deep_btree(tmp_path, n):
    """``ori_images`` of a long clip: a group B-tree of two levels or more."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        g = f.create_group("ori_images")
        for i in range(n):
            g.create_dataset(f"image{i:09d}", data=np.array([i], np.int32)).attrs["t"] = i * 0.5
    got = hdf5.File(path)["ori_images"]
    assert len(got) == n and got.keys() == [f"image{i:09d}" for i in range(n)]
    for i in (0, n // 3, n - 1):
        assert got[f"image{i:09d}"][0] == i and got[f"image{i:09d}"].attrs["t"] == i * 0.5
    r = got._r
    addr = next(a for a, o in r.objects.items() if o is got)
    btree = next(hdf5._u(b, 0, 8) for t, _, b in r.header(addr) if t == 0x0011)
    level, _, _ = r.btree_node(btree, 0, 8)
    assert level >= 1


def test_user_block_moves_the_superblock(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", userblock_size=1024) as f:
        f.create_dataset("x", data=np.arange(100), compression="gzip")
        f.attrs["a"] = "text"
    with open(path, "r+b") as fh:
        fh.write(b"not hdf5 " * 10)  # a user block holds anything
    got = hdf5.File(path)
    np.testing.assert_array_equal(got["x"][:], np.arange(100))
    assert got.attrs["a"] == "text"
    # found by the same search wherever a clip's format is told apart
    from ebfi_tpu_torch.data.dataloader import is_clip

    assert hdf5.is_hdf5(path) and is_clip(path)
    text = tmp_path / "list.txt"
    text.write_text("clip.h5\n" * 200)
    assert not hdf5.is_hdf5(str(text)) and not is_clip(str(text))
    assert not hdf5.is_hdf5(str(tmp_path / "missing.h5"))


def test_reads_touch_only_overlapping_chunks_and_cache_them(tmp_path, monkeypatch):
    path = str(tmp_path / "f.h5")
    data = np.arange(10_000, dtype=np.int16)
    with h5py.File(path, "w") as f:
        f.create_dataset("xs", data=data, chunks=(1000,), compression="gzip")
    ds = hdf5.File(path)["xs"]
    decoded = []
    real = hdf5.Dataset._decode
    monkeypatch.setattr(hdf5.Dataset, "_decode", lambda self, k: decoded.append(k) or real(self, k))
    np.testing.assert_array_equal(ds[1500:2500], data[1500:2500])
    assert sorted(decoded) == [1, 2]
    np.testing.assert_array_equal(ds[2400:3100], data[2400:3100])  # chunk 2 cached
    assert sorted(decoded) == [1, 2, 3]
    assert ds[7777] == 7777 and decoded[-1] == 7


def _frames_file(path, n, shape=(24, 32, 3)):
    """A clip's ``ori_images``: n gzip frames in 18 chunks of (8, 16, 1)
    (128 bytes each decoded), and one event array."""
    rng = np.random.default_rng(n)
    frames = rng.integers(0, 255, (n,) + shape).astype(np.uint8)
    with h5py.File(path, "w") as f:
        g = f.create_group("ori_images")
        for i in range(n):
            g.create_dataset(f"image{i:09d}", data=frames[i], compression="gzip",
                             chunks=(8, 16, 1))
        f.create_dataset("ori_events/xs", data=rng.integers(0, 32, 50_000).astype(np.int16),
                         compression="gzip", chunks=(1000,))
    return frames


@pytest.mark.parametrize("read", ["whole_frames", "frame_rows"])
def test_chunk_lru_is_one_bounded_budget_per_file(tmp_path, monkeypatch, read):
    """Reading every frame of a long clip keeps at most the file's budget
    of decoded chunks however many datasets were opened; a whole-dataset
    read (a frame) keeps none, a partial read (an event window) keeps its
    chunks for the next window."""
    path = str(tmp_path / "clip.h5")
    n = 300
    frames = _frames_file(path, n)
    budget = 64 * 1024  # 512 chunks, 28.4 frames'; the clip's frames decode to 675 KiB
    monkeypatch.setattr(hdf5, "CHUNK_CACHE_BYTES", budget)
    f = hdf5.File(path)
    r = f._r
    images = f["ori_images"]
    for i in range(n):
        d = images[f"image{i:09d}"]
        if read == "whole_frames":
            np.testing.assert_array_equal(d[:], frames[i])
            assert r.chunk_bytes == 0 and not r.chunks
        else:
            np.testing.assert_array_equal(d[3:20], frames[i, 3:20])
            assert r.chunk_bytes == sum(c.nbytes for c in r.chunks.values()) <= budget
    assert not any(vars(o).get("_cache") for o in r.objects.values())
    if read == "frame_rows":
        assert len({addr for addr, _ in r.chunks}) == -(-budget // (18 * 128))
    xs = f["ori_events/xs"]
    want = xs[:]
    assert r.chunk_bytes == (0 if read == "whole_frames" else budget)
    np.testing.assert_array_equal(xs[10_500:12_500], want[10_500:12_500])
    decoded = []
    real = hdf5.Dataset._decode
    monkeypatch.setattr(hdf5.Dataset, "_decode", lambda self, k: decoded.append(k) or real(self, k))
    np.testing.assert_array_equal(xs[12_200:13_400], want[12_200:13_400])
    assert decoded == [13]  # chunk 12 kept from the window before
    clone = pickle.loads(pickle.dumps(f))
    assert clone._r.chunk_bytes == 0 and not clone._r.chunks


def test_threads_pickles_and_forks_read_alike(tmp_path):
    """Threads share a dataset (``pread``, a locked LRU); a file pickled or
    forked before its first read opens itself again in the new process
    (the fork runs in a fresh interpreter, which holds no other threads)."""
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 255, (64, 48, 3)).astype(np.uint8)
    with h5py.File(path, "w") as f:
        f.create_dataset("img", data=data, compression="gzip", chunks=(8, 16, 1))
    ds = hdf5.File(path)["img"]
    out = [None] * 16
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, ds[i % 64:i % 64 + 20]))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert all(np.array_equal(o, data[i:i + 20]) for i, o in enumerate(out))
    clone = pickle.loads(pickle.dumps(hdf5.File(path)))
    np.testing.assert_array_equal(clone["img"][:], data)
    again = pickle.loads(pickle.dumps(ds))
    np.testing.assert_array_equal(again[5], data[5])
    np.save(tmp_path / "want.npy", data)
    code = (
        "import os, sys, numpy as np\n"
        "from ebfi_tpu_torch.data import hdf5\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        f"fresh = hdf5.File({path!r})['img']  # opened, not yet read\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    os._exit(0 if np.array_equal(fresh[10:30], want[10:30]) else 3)\n"
        "_, status = os.waitpid(pid, 0)\n"
        "assert os.waitstatus_to_exitcode(status) == 0, status\n"
        "assert np.array_equal(fresh[:], want)  # the parent's handle is its own\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ what raises


def _dense_links(f):
    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    gcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED)
    h5py.h5g.create(f.id, b"g", gcpl=gcpl)
    for i in range(20):
        f["g"].create_dataset(f"d{i}", data=[i])


def _dense_attributes(f):
    d = f.create_dataset("x", data=[1], track_order=True)
    for i in range(20):
        d.attrs[f"a{i}"] = i


def _virtual(f):
    f.create_dataset("src", data=np.arange(10))
    layout = h5py.VirtualLayout(shape=(10,), dtype="i8")
    layout[:] = h5py.VirtualSource(f["src"])
    f.create_virtual_dataset("x", layout)


UNSUPPORTED = {
    # (writer, file keywords, the error's words)
    "superblock_v3": (lambda f: f.create_dataset("x", data=[1]), {"libver": "latest"},
                      "superblock version 3"),
    "superblock_v2": (lambda f: f.create_dataset("x", data=[1]), {"libver": ("v108", "v108")},
                      "superblock version 2"),
    "v2_object_header": (lambda f: f.create_group("g", track_order=True), {},
                         r"version 2 \(OHDR"),
    "dense_links": (_dense_links, {}, r"dense link storage \(fractal heap\)"),
    # h5py keeps dense attributes in v2 headers only: the header stops the reader first
    "dense_attributes": (_dense_attributes, {}, r"version 2 \(OHDR"),
    "lzf": (lambda f: f.create_dataset("x", data=np.arange(999), compression="lzf"), {},
            r"filter 32000 \(lzf\)"),
    "scaleoffset": (lambda f: f.create_dataset("x", data=np.arange(999), scaleoffset=0), {},
                    r"filter 6 \(scaleoffset\)"),
    "compound": (lambda f: f.create_dataset("x", data=np.zeros(3, [("a", "i4"), ("b", "f4")])),
                 {}, "datatype compound"),
    "enum_bool": (lambda f: f.create_dataset("x", data=np.array([True, False])), {},
                  "datatype enum"),
    "reference": (lambda f: f.create_dataset("x", data=[f.ref], dtype=h5py.ref_dtype), {},
                  "datatype reference"),
    "array_type": (lambda f: f.create_dataset("x", (2,), dtype=np.dtype("(3,)i4")), {},
                   "datatype array"),
    "opaque": (lambda f: f.create_dataset("x", data=np.void(b"abc")), {}, "datatype opaque"),
    "vlen_sequence": (lambda f: f.create_dataset("x", (2,), dtype=h5py.vlen_dtype(np.int32)),
                      {}, "variable-length sequence"),
    "vlen_string_dataset": (lambda f: f.create_dataset("x", data=["a", "bb"],
                                                       dtype=h5py.string_dtype()), {},
                            "variable-length strings in a dataset"),
    "external_storage": (lambda f: f.create_dataset(
        "x", data=np.arange(10), external=[(os.devnull, 0, h5py.h5f.UNLIMITED)]), {},
        "external storage"),
    "virtual_dataset": (_virtual, {}, "virtual dataset layout"),
    "soft_link": (lambda f: (f.create_dataset("y", data=[1]),
                             f.__setitem__("x", h5py.SoftLink("/y"))), {}, "soft link"),
    "external_link": (lambda f: f.__setitem__("x", h5py.ExternalLink("other.h5", "/y")), {},
                      "external link"),
    "committed_datatype": (lambda f: (f.__setitem__("t", np.dtype("i4")),
                                      f.create_dataset("x", (3,), dtype=f["t"])), {},
                           "is shared"),
}


def _touch_all(node):
    for k in node.keys():
        obj = node[k]
        if isinstance(obj, hdf5.Group):
            _touch_all(obj)
        else:
            obj[()]
        dict(obj.attrs)
    dict(node.attrs)


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_feature_raises_naming_it(tmp_path, case):
    write, kwargs, words = UNSUPPORTED[case]
    path = str(tmp_path / f"{case}.h5")
    with h5py.File(path, "w", **kwargs) as f:
        write(f)
    with pytest.raises(hdf5.HDF5Error, match=words) as err:
        f = hdf5.File(path)
        if case == "committed_datatype":
            f["x"]
        _touch_all(f)
    assert path in str(err.value)


@pytest.mark.parametrize("case", ["not_hdf5", "truncated", "fletcher32_mismatch"])
def test_damaged_files_raise(tmp_path, case):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(4000, dtype=np.int32), chunks=(500,), fletcher32=True)
    raw = bytearray(open(path, "rb").read())
    if case == "not_hdf5":
        raw[:8] = b"PK\x03\x04xxxx"
        words = "not an HDF5 file"
    elif case == "truncated":
        raw = raw[: len(raw) // 2]
        words = "past the end of the file"
    else:
        with h5py.File(path, "r") as f:
            off = f["x"].id.get_chunk_info(3).byte_offset
        raw[off + 10] ^= 0xFF
        words = "fletcher32 checksum"
    open(path, "wb").write(bytes(raw))
    with pytest.raises(hdf5.HDF5Error, match=words):
        hdf5.File(path)["x"][:]


# ------------------------------------------------------------------ writer


WRITER_ARRAYS = {
    "u8_frame": (np.arange(720 * 1280 * 3, dtype=np.int64).reshape(720, 1280, 3) % 251)
    .astype(np.uint8),
    "i16_events": (np.arange(6_537_641 // 50) % 1280).astype(np.int16),
    "f64_ts": np.linspace(0.0, 0.13, 130_753),
    "i8_ps": np.tile(np.array([-1, 1], np.int8), 65_377),
    "f32_2d": np.linspace(-1, 1, 333 * 17, dtype=np.float32).reshape(333, 17),
    "be_i2": np.arange(-700, 700, dtype=">i2"),
    "be_f8": np.linspace(0, 1, 257).astype(">f8"),
    "u64": np.arange(5000, dtype=np.uint64) * 7,
    "empty": np.zeros(0, np.int16),
    "bytes": np.array([b"ab", b"cde", b""]),
    "scalar": np.array(2.75),
}


@pytest.mark.parametrize("storage", ["contiguous", "gzip"])
def test_writer_files_read_back_equal_in_h5py(tmp_path, storage):
    path = str(tmp_path / "w.h5")
    kw = {"contiguous": {}, "gzip": {"compression": "gzip"}}[storage]
    with hdf5_write.Writer(path) as w:
        w.attrs["sensor_resolution"] = np.array([720, 1280], np.int64)
        w.attrs["num_imgs"] = 33
        w.attrs["name"] = "clip é"
        w.attrs["names"] = ["a", "bc"]
        w.attrs["fixed"] = np.bytes_("xy")
        w.attrs["fps"] = 240.0
        w.attrs["size"] = (720, 1280, 3)
        w.attrs["f32s"] = np.linspace(0, 1, 7, dtype=np.float32)
        g = w.create_group("data/nested")
        for name, arr in WRITER_ARRAYS.items():
            d = g.create_dataset(name, data=arr, **({} if arr.ndim == 0 else kw))
            d.attrs["timestamp"] = 0.25
            d.attrs["ori_event_idx"] = 12345
            d.attrs["label"] = name
        w.create_group("empty_group")
    with h5py.File(path, "r") as f:
        assert f.attrs["name"] == "clip é" and f.attrs["fixed"] == b"xy"
        assert f.attrs["names"].tolist() == ["a", "bc"]
        assert f.attrs["size"].dtype == np.int64 and isinstance(f.attrs["num_imgs"], np.int64)
        assert list(f["empty_group"]) == []
        for name, arr in WRITER_ARRAYS.items():
            d = f[f"data/nested/{name}"]
            assert d.dtype == arr.dtype and d.shape == arr.shape
            _equal(d[()], arr[()] if arr.ndim == 0 else arr)
            assert d.attrs["label"] == name and d.attrs["ori_event_idx"] == 12345
            if arr.ndim and kw:
                assert d.compression == "gzip" and d.compression_opts == 4
                assert not d.shuffle and not d.fletcher32
            else:
                assert d.chunks is None and d.compression is None
        _same_tree(hdf5.File(path), f)


def test_writer_chunk_shapes_are_h5pys(tmp_path):
    """The same chunk shapes as h5py's for the same data, here and by rule."""
    from h5py._hl.filters import guess_chunk

    path, ref = str(tmp_path / "w.h5"), str(tmp_path / "ref.h5")
    with hdf5_write.Writer(path) as w, h5py.File(ref, "w") as f:
        for name, arr in WRITER_ARRAYS.items():
            if arr.ndim:
                w.create_dataset(name, data=arr, compression="gzip")
                f.create_dataset(name, data=arr, compression="gzip")
    with h5py.File(path, "r") as a, h5py.File(ref, "r") as b:
        for name in a:
            assert a[name].chunks == b[name].chunks, name
    rng = np.random.default_rng(1)
    shapes = [(720, 1280, 3), (6_537_641,), (0,), (1,), (3, 0, 5), (260, 346, 3), (33, 720, 1280)]
    shapes += [tuple(int(s) for s in rng.integers(1, 3000, rng.integers(1, 4))) for _ in range(40)]
    for shape in shapes:
        for size in (1, 2, 4, 8, 16):
            assert hdf5_write.guess_chunk(shape, size) == guess_chunk(shape, None, size), shape


def test_writer_groups_of_thousands_and_h5py_appends(tmp_path):
    """Names sorted in SNODs under a multi-level B-tree (h5py finds each by
    binary search), and h5py can add members and attributes afterwards."""
    path = str(tmp_path / "w.h5")
    n = 3000
    with hdf5_write.Writer(path) as w:
        g = w.create_group("ori_images")
        for i in reversed(range(n)):  # created out of order
            g.create_dataset(f"image{i:09d}", data=np.full((2, 3, 3), i % 256, np.uint8),
                             compression="gzip").attrs["timestamp"] = i / 240.0
        w["ori_images"].create_dataset("zz", data=[1])
    with h5py.File(path, "r") as f:
        assert len(f["ori_images"]) == n + 1
        for i in (0, 1, 1234, n - 1):
            d = f[f"ori_images/image{i:09d}"]
            assert d[0, 0, 0] == i % 256 and d.attrs["timestamp"] == i / 240.0
    with h5py.File(path, "a") as f:
        f["ori_images/image000000007"].attrs["ori_event_idx"] = 99
        f["ori_images"].create_dataset("image000003000", data=np.zeros((2, 3, 3), np.uint8))
        f.attrs["num_imgs"] = n + 1
    got = hdf5.File(path)
    assert len(got["ori_images"]) == n + 2
    assert got["ori_images/image000000007"].attrs["ori_event_idx"] == 99
    assert got.attrs["num_imgs"] == n + 1


@pytest.mark.parametrize("value, kind", [(True, "bool"), (np.array([1 + 2j]), "complex"),
                                         (np.zeros(9000), "too large")])
def test_writer_refuses_what_it_cannot_write(tmp_path, value, kind):
    path = str(tmp_path / "w.h5")
    with pytest.raises((TypeError, ValueError)):
        with hdf5_write.Writer(path) as w:
            w.attrs["x"] = value
    with pytest.raises(ValueError, match="lzf"):
        with hdf5_write.Writer(str(tmp_path / "v.h5")) as w:
            w.create_dataset("x", data=[1], compression="lzf")
    with pytest.raises(ValueError, match="scalar"):
        with hdf5_write.Writer(str(tmp_path / "s.h5")) as w:
            w.create_dataset("x", data=2.5, compression="gzip")
