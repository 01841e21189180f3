"""Build and load the package's CUDA kernels at first use.

Each source in `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface under `build/fastlivo_tpu_torch/` at the
repository root, and loaded with ctypes. The library's file name carries
a hash of its source, the `csrc/*.cuh` headers it includes and the flags,
so an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
# every csrc/<name>.cu: the LIO search in one launch on the tiled map and
# on the hash and dense maps, and the fused 5-NN + plane fit on a
# gathered block, which the host loop's search runs under `cache_knn`
# (ops/knn_plane.py); one photometric EKF iteration's measurement, and
# the whole photometric cascade and its step alone (ops/photometric.py);
# the patch + gradient sampling (ops/patches_grads.py), the TPU kernel's
# signature, on no path; one measurement group's IMU propagation
# (ops/imu_scan.py); the LIO iterated EKF of one scan on any map, with
# any LIO option (ops/lio_cascade.py: lio_cascade at radius 1,
# lio_cascade_125 at 2, lio_cascade_any at any other radius); the camera
# frame's selection (ops/vio_select.py)
# and its visual-map upkeep (ops/vio_observations.py); the tiled map's box
# delete and its insert's three passes (ops/tiled_map.py), the voxel
# filter's segmented centroid (ops/voxel_filter.py), the scan's
# undistortion (imu.py); the hash map's insert (ops/voxel_map.py), the
# dense grid's (ops/dense_map.py) and the box delete of both; the voxel
# filter's key pass (ops/voxel_filter.py), the camera frame's voxel dedup
# (ops/vio_dedup.py) and image-pool push (ops/vio_push.py)
SOURCES = ("knn5_plane_tiled", "knn5_plane_hashed", "knn5_plane", "photometric_err_H",
           "photometric_cascade", "patches_and_grads", "imu_propagate", "lio_cascade",
           "vio_select", "vio_observations", "tiled_delete_boxes", "voxel_centroids",
           "tiled_insert", "undistort", "hash_insert", "dense_insert", "flat_delete_boxes",
           "lio_cascade_125", "lio_cascade_any", "voxel_keys", "vio_dedup", "vio_push")
BUILD_DIR = PKG_DIR.parent / "build" / "fastlivo_tpu_torch"
# -fmad=false: no multiply-add contraction, so a kernel rounds every
# product as its plain PyTorch version (one op per product) does; with
# contraction, nearly degenerate plane fits (two close eigenvalues) pick
# a different eigenvector than their oracle. The kernels are bound by
# memory, not by arithmetic. No --use_fast_math: the fits need the
# accurate acosf/cosf/sqrtf. --cudart shared: the libraries launch through
# the process's libcudart.so (the one PyTorch loaded, where the sonames
# match), the runtime whose calls torch.profiler traces; `profiled` then
# gives each launch an op to be linked to.
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "--cudart", "shared",
]

_loaded: dict = {}
_load_lock = threading.Lock()  # the server estimates on reader threads


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(cuda_home) / "bin" / "nvcc")] if cuda_home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+\.cuh)"', re.M)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for header in _INCLUDE.findall(src):  # the package's own headers
        h.update((CSRC / header.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    tag = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        nvcc = _nvcc()
        # where no libcudart.so of that soname is loaded yet, the
        # toolkit's own is found beside nvcc
        rpath = Path(nvcc).resolve().parents[1] / "lib64"
        cmd = [nvcc, *NVCC_FLAGS, "-Xlinker", f"-rpath,{rpath}", "-o", tmp,
               str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def profiled(name: str, fn):
    """`fn` (a ctypes launch function) called inside a profiler op named
    `name`: torch.profiler links a device kernel to the op around its
    launch, not to a `record_function` range, so without one the
    hand-written kernels stand unattributed in a trace."""
    import torch

    def call(*args):
        with torch._C._profiler._RecordFunctionFast(name):
            return fn(*args)

    return call


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed.
    Thread-safe; the launches take the calling thread's current stream
    from their wrappers."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                _loaded[name] = lib
    return lib
