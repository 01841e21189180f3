"""ctypes bindings for the native host-runtime library (native/ingest.cpp).

The reference's host runtime is C++ (decoders in preprocess.cpp, scan
filters via pcl::VoxelGrid); this module exposes the equivalent native
kernels, each with a numpy or pure-Python twin that the callers use when
the library cannot be built or loaded (`load()` returns None then).

Port of the JAX package's native.py. The library is built from the
repository's `native/ingest.cpp` with the flags of `native/Makefile`
(`g++ -O3 -march=native -std=c++17 -Wall -shared -fPIC`), by calling
`g++` directly, into `build/fastlivo_tpu_torch/` at the repository root
(git ignores it). The file name carries a hash of the source, the flags
and the compiler's resolved target (`-march=native` differs between
hosts), and the file is published by an atomic rename, so processes that
build at once never load half a file. Nothing is built when the module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "ingest.cpp"
BUILD_DIR = ROOT / "build" / "fastlivo_tpu_torch"
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-Wall", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for this source, these flags and this host's
    target lives."""
    target = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60, check=True)
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([CXX, *CXXFLAGS]).encode())
    h.update(target.stdout.encode())
    return BUILD_DIR / f"libfastlivo_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile native/ingest.cpp unless an up-to-date library exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([CXX, *CXXFLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{CXX} failed for {SOURCE.name}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.decode_avia.restype = ctypes.c_int
    lib.decode_avia.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.lz4_decompress_block.restype = ctypes.c_longlong
    lib.lz4_decompress_block.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong,
    ]
    lib.xxh32_native.restype = ctypes.c_uint32
    lib.xxh32_native.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_uint32]
    lib.voxel_downsample_f32.restype = ctypes.c_int
    lib.voxel_downsample_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int,
    ]
    lib.give_feature_ring.restype = ctypes.c_int
    lib.give_feature_ring.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (tried once per process)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError, AttributeError):
                _lib = None
    return _lib


def decode_avia_native(points: np.ndarray, n_scans: int, blind: float,
                       point_filter_num: int):
    """points: structured array with the livox CustomPoint layout
    (offset_time u4, x/y/z f4, reflectivity/tag/line u1). Returns
    (xyzi (M,4) f32, t_rel (M,) f64) or None if the library is absent."""
    lib = load()
    if lib is None:
        return None
    buf = np.ascontiguousarray(points)
    if buf.dtype.itemsize != 19:
        raise ValueError(f"decode_avia_native: {buf.dtype} is not the 19-byte CustomPoint")
    n = len(buf)
    out_xyzi = np.empty((n, 4), np.float32)
    out_t = np.empty(n, np.float64)
    m = lib.decode_avia(buf.ctypes.data, n, n_scans, blind, point_filter_num,
                        out_xyzi.ctypes.data, out_t.ctypes.data)
    return out_xyzi[:m], out_t[:m]


def voxel_downsample_native(pts: np.ndarray, leaf: float,
                            max_out: int | None = None):
    """Centroid voxel filter; the contract of
    ops.voxel_filter.voxel_downsample. None if the library is absent or
    the rows are wider than the kernel's 8 accumulated columns."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(pts, np.float32)
    n, cols = pts.shape
    if cols > 8:
        return None
    cap = n if max_out is None else max(n, max_out)
    out = np.empty((cap, cols), np.float32)
    m = lib.voxel_downsample_f32(pts.ctypes.data, n, cols, leaf, out.ctypes.data, cap)
    if max_out is None:
        return out[:m], np.ones(m, bool)
    buf = np.zeros((max_out, cols), np.float32)
    k = min(m, max_out)
    buf[:k] = out[:k]
    mask = np.zeros(max_out, bool)
    mask[:k] = True
    return buf, mask


def give_feature_ring_native(pl, curv, rng, dista, blind, point_filter_num,
                             is_avia):
    """One ring through the native give_feature; the contract of
    features.give_feature. None if the library is absent."""
    lib = load()
    if lib is None:
        return None
    pl = np.ascontiguousarray(pl, np.float64)
    curv = np.ascontiguousarray(curv, np.float64)
    rng = np.ascontiguousarray(rng, np.float64)
    dista = np.ascontiguousarray(dista, np.float64)
    n = len(pl)
    cap = max(n, 8)
    surf = np.empty((cap, 4), np.float64)
    corn = np.empty((cap, 4), np.float64)
    counts = np.zeros(2, np.int32)
    rc = lib.give_feature_ring(
        pl.ctypes.data, curv.ctypes.data, rng.ctypes.data, dista.ctypes.data,
        n, blind, point_filter_num, int(is_avia),
        surf.ctypes.data, cap, corn.ctypes.data, cap, counts.ctypes.data)
    if rc != 0:
        return None
    return surf[: counts[0]].copy(), corn[: counts[1]].copy()
