"""The loader's host data plane in C++ (``ebfi_host.cpp`` beside this file),
bound with ``ctypes``: event stacks, blur synthesis and event timestamp
normalisation, each bit for bit with its numpy plain version in
:mod:`ebfi_tpu_torch.data.encodings`; and two byte codecs, the LZ4 frame
decoder of ROS bags' lz4 chunks (:mod:`ebfi_tpu_torch.data.rosbag`) and the
GIF LZW encoder of :mod:`ebfi_tpu_torch.utils.vis`'s movies.

The library is built at first use with the host's C++ compiler (``$CXX``,
else ``g++``) into ``ebfi_tpu_torch/_build/``, named by a hash of the
source and the flags, so a warm checkout loads it without building.  A
build writes to a temporary name and renames it into place: any number of
processes (test workers, the CLI's spawned fetch workers) may ask at once,
and none loads a half-written library.  A failed build raises with the
compiler's output; nothing falls back to numpy.

The flags keep numpy's rounding: ``-ffp-contract=off`` (no fused
multiply-adds), no ``-march=native`` and no ``-ffast-math``.

ctypes releases the GIL for each call, so fetch threads encode in
parallel; the calls touch only the arrays' buffers, which the callers here
keep alive until the call returns.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().with_name("ebfi_host.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-ffp-contract=off")
BUILD_TIMEOUT_S = 300

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_U8 = ctypes.POINTER(ctypes.c_uint8)
SIGNATURES = {
    "ebfi_events_to_stack": [_D, _D, _D, _D, _I64, ctypes.c_int, _I64, _I64, _F],
    "ebfi_blurry_mean": [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64), _I64,
                         _I64, _I64, _F],
    "ebfi_normalize_ts": [_D, _I64, _D],
    "ebfi_lz4_frame_decode": [_U8, _I64, _U8, _I64],
    "ebfi_xxh32": [_U8, _I64, ctypes.c_uint32],
    "ebfi_gif_lzw": [_U8, _I64, ctypes.c_int, _U8, _I64],
}
RESTYPES = {"ebfi_lz4_frame_decode": ctypes.c_int64, "ebfi_xxh32": ctypes.c_uint32,
            "ebfi_gif_lzw": ctypes.c_int64}
LZ4_ERRORS = {-1: "truncated", -2: "not an LZ4 frame (bad magic number)",
              -3: "an unsupported frame option (version, dictionary or block size)",
              -4: "a checksum mismatch", -5: "more data than the expected size",
              -6: "a match offset outside the decoded data"}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler for the native host plane: install g++ or set CXX")
    return cxx


def library_path(source: Path = SOURCE) -> Path:
    """Where the library of ``source`` and the flags lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libebfi_host_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless its library is there; returns the path.
    Raises with the compiler's output when the build fails."""
    out = library_path(source)
    if out.exists():
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}.{threading.get_ident()}")
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"building the native host plane from {source.name} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name)
    return lib


def _f64(a) -> np.ndarray:
    """A contiguous f64 copy or view; every stored dtype of a clip (int8/16/32,
    f32, f64, bool) converts without changing a value."""
    return np.ascontiguousarray(a, np.float64)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def events_to_stack(xs, ys, ts, ps, num_bins: int, sensor_size: Tuple[int, int]) -> np.ndarray:
    """Per-polarity temporal-bin count stack in the loader's item layout:
    float32 (H, W, 2 * num_bins), bin-major and polarity-minor.  ``ts``
    sorted.  Equal, bit for bit, to :func:`ebfi_tpu_torch.data.encodings.
    events_to_stack` put in that layout by :func:`~ebfi_tpu_torch.data.
    encodings.item_layout`, for any weights."""
    H, W = (int(s) for s in sensor_size)
    out = np.zeros((H, W, 2 * num_bins), np.float32)
    ts = _f64(ts)
    if len(ts) <= 3 or ts.sum() == 0:  # numpy's own sum decides, as in the plain version
        return out
    xs, ys, ps = _f64(xs), _f64(ys), _f64(ps)
    if not len(xs) == len(ys) == len(ps) == len(ts):
        raise ValueError(f"events of unequal lengths: xs {len(xs)}, ys {len(ys)}, "
                         f"ts {len(ts)}, ps {len(ps)}")
    load_library().ebfi_events_to_stack(
        _ptr(xs, ctypes.c_double), _ptr(ys, ctypes.c_double), _ptr(ts, ctypes.c_double),
        _ptr(ps, ctypes.c_double), len(ts), num_bins, H, W, _ptr(out, ctypes.c_float))
    return out


def blurry_mean(images: np.ndarray, indices: Sequence[int]) -> np.ndarray:
    """The blurry frame of ``images[indices]`` (uint8 (N, H, W, 3) BGR, a
    clip's memory map as it is): float32 (H, W, 3) RGB, the uint8 mean in
    f64 cast to f32, then divided by 255 in f32.  Equal, bit for bit, to
    :func:`ebfi_tpu_torch.data.encodings.blurry_mean`."""
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"blurry_mean takes uint8 (N, H, W, 3) frames, got {images.dtype} "
                         f"{images.shape}")
    idx = np.ascontiguousarray(indices, np.int64)
    if len(idx) == 0 or idx.min() < 0 or idx.max() >= images.shape[0]:
        raise IndexError(f"frame indices {idx.tolist()} outside the clip's "
                         f"{images.shape[0]} frames")
    _, H, W, _ = images.shape
    out = np.empty((H, W, 3), np.float32)
    load_library().ebfi_blurry_mean(_ptr(images, ctypes.c_uint8), _ptr(idx, ctypes.c_int64),
                                    len(idx), H, W, _ptr(out, ctypes.c_float))
    return out


def normalize_ts(ts) -> np.ndarray:
    """``(ts - ts[0]) / (ts[-1] - ts[0] + 1e-6)`` in f64, equal bit for bit to
    :func:`ebfi_tpu_torch.data.encodings.normalize_event_ts`."""
    ts = _f64(ts)
    out = np.empty_like(ts)
    load_library().ebfi_normalize_ts(_ptr(ts, ctypes.c_double), len(ts),
                                     _ptr(out, ctypes.c_double))
    return out


def _bytes_ptr(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _U8)


def lz4_frame_decode(data: bytes, size: int) -> bytes:
    """The content of the LZ4 frame(s) in ``data``, which must be ``size``
    bytes long; raises ValueError naming what is wrong with the frame."""
    data = bytes(data)
    out = np.empty(size, np.uint8)
    got = load_library().ebfi_lz4_frame_decode(_bytes_ptr(data), len(data),
                                                _ptr(out, ctypes.c_uint8), size)
    if got < 0:
        raise ValueError(f"LZ4 frame: {LZ4_ERRORS.get(got, f'error {got}')}")
    if got != size:
        raise ValueError(f"LZ4 frame: {got} bytes decoded, {size} expected")
    return out.tobytes()


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 of ``data``: the checksum LZ4 frames carry."""
    data = bytes(data)
    return load_library().ebfi_xxh32(_bytes_ptr(data), len(data), seed)


def gif_lzw(indices: np.ndarray, min_code_size: int) -> bytes:
    """The LZW code stream of one GIF image of palette ``indices`` (uint8,
    each below ``2 ** min_code_size``), without the sub-block framing."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    if not 2 <= min_code_size <= 8:
        raise ValueError(f"GIF LZW minimum code size {min_code_size} outside 2..8")
    if len(idx) and int(idx.max()) >= 1 << min_code_size:
        raise ValueError(f"palette index {int(idx.max())} needs more than {min_code_size} bits")
    cap = 2 * len(idx) + 64  # at most 12 bits a pixel, plus the clear codes
    out = np.empty(cap, np.uint8)
    got = load_library().ebfi_gif_lzw(_ptr(idx, ctypes.c_uint8), len(idx), min_code_size,
                                       _ptr(out, ctypes.c_uint8), cap)
    if got < 0:
        raise RuntimeError("GIF LZW: the output buffer was too small")
    return out[:got].tobytes()
