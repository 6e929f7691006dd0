"""Build and load the hand-written CUDA kernels.

All ``csrc/*.cu`` sources go through one ``nvcc`` call into one shared
library with a plain C interface, loaded with ``ctypes``.  The library's
name carries a hash of the sources and flags, so a warm checkout loads it
without rebuilding; a build writes to a temporary name and renames it into
place, so an interrupted build leaves no half-written library.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
NVCC_TIMEOUT_S = 300

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so 64-bit addresses are not cut to 32 bits)
SIGNATURES = {
    "ebfi_fac_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ebfi_mod_fac_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ebfi_mod_fac_shared": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ebfi_mod_fac_fused_wgmma": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ebfi_mod_fac_shared_wgmma": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libebfi_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def build() -> tuple[Path, float, str]:
    """Compile the library if it is missing.  Returns (path, seconds spent
    building, compiler log); seconds is 0.0 when the library was cached."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu, _ = _sources()
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S, check=False
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}{proc.stdout}"
            )
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    log = proc.stderr + proc.stdout
    (BUILD_DIR / f"{out.stem}.log").write_text(log)
    return out, time.perf_counter() - t0, log


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ebfi_error_string.argtypes = [ctypes.c_int]
    lib.ebfi_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.ebfi_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
