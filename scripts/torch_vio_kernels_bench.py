"""Device time of the camera frame's kernels (vio_select, vio_observations,
and the stage kernels vio_push, vio_dedup, voxel_keys and the voxel
filter's keys and sort) of several checkouts on one card, whether their
outputs are bit-equal, and where each one's time goes.

Usage: python scripts/torch_vio_kernels_bench.py [--variant TREE ...]
           [--stamps TREE ...] [--reps 30] [--frames 24] [--seed 0]
           [--push-pools R ...] [--out FILE]

Each variant is csrc/vio_select.cu and csrc/vio_observations.cu of the
checkout at TREE, relative to this one (default: this one, `.`; e.g.
`build/parent` for an unpacked parent commit), built with this
checkout's nvcc flags into build/fastlivo_tpu_torch/vio_bench/ and
launched through ctypes on arguments prepared once (so that a call is the
C launcher and the kernel). A launcher that takes the state's rot and pos
with the extrinsics (this checkout's) gets those; an older one that takes
the camera poses gets them from vio._cam_pose, which is what the newer
kernels compute inside. The inputs are seeded, at the LIVO path's shapes:
a 640x512 camera (f = 400, no distortion), 16 x 12 cells of 40 px (G =
192), P = 8; the shipped visual map (65536 points x KO = 20 observations,
T = 2^18 voxel slots x VC = 8, a pool of 256 u8 images) grown by the
port's map operations over `--frames` noisy copies of one texture, 192
points a frame, the first three frames' points observed again every
frame (their rings full); then a frame near the identity pose with a
scan cloud of M = 8192 rows (noisy copies of map points and free points)
and its Nv = 4096 voxels; vio_observations after it at a posterior state
0.6 m away (every tracked row writes its ring).

The stage kernels, where a checkout has their sources (csrc/vio_push.cu,
vio_dedup.cu, voxel_keys.cu, tiled_insert.cu; a checkout without one
reports null for it): vio_push on a copy of that map with the frame's
image and the next frame id (every call pushes that fid again: the same
refcount, rank and key work, the same slot), where the launcher has two
forms also forced into the two-barrier one ("vio_push two") and into the
one-barrier one on two blocks an SM; vio_dedup on the scan cloud (M = 8192 into 4096)
and on that cloud tiled three times (24576 rows, the scratch route);
voxel_keys on a seeded LIO scan (32768 rows of 4 columns, 24000 valid, a
0.5 m leaf, uniform over +-40 m: 3 passes), on the scan cloud at the
camera's reciprocal 0.2 m leaf and on a room scan (the synthetic room's
faces about the sensor, the LIO path's shape: 2 passes); the keys and
their stable sort ("voxel_sort") on those three: a checkout's
voxel_sort launch where its csrc/voxel_keys.cu has one, else the route
it replaced, its voxel_keys launch and torch.sort(stable=True); the
tiled insert's keys and sort ("tiled_insert_sort") on a LIO-shaped batch
(16384 rows on the synthetic room about the world origin, 12000 valid:
2 passes) and on a +-70 m batch (3 passes), beside the route it replaced
in the same checkout ("insert keys + torch.sort": its tiled_insert_keys
launch and torch.sort(stable=True)); each variant's sorts launch on a
scratch of their own, since checkouts lay it out differently. Every
buffer whose pointer a launch holds is kept for the whole run (`KEEP`).
Each is held bit for bit against its plain version
(visual_map.push_image_plain, vio._dedup_voxels_plain,
ops/voxel_filter.voxel_keys_plain and _sorted_keys_plain,
ops/tiled_map.insert_sort_plain) and timed in turns as the two above.
With --push-pools, this checkout's push in its two forms, in turns, on
pools of R slots of 640 x 512 u8 frames (a second JSON line).

Each variant's outputs are compared bit for bit with the plain versions
(ops/vio_select.vio_select_plain, ops/vio_observations.
vio_observations_plain: every output, every map field), each on a fresh
copy of the map. The variants are then timed in turns, forwards and
backwards (A B ... B A), each a median of `--reps` queued calls
(chip_smoke.time_ms; vio_observations on one copy of the map, which each
call writes again), beside an empty kernel, with the launcher's host
wall a call (chip_smoke.host_ms over `--reps` calls). A `--stamps`
variant is built again with -DPHASE_STAMPS (csrc/phase_stamps.cuh; and
-DVIO_PHASE_STAMPS, the define of a checkout older than that header) and
launched `--reps` times alone, synchronised, reading its phase stamps
after each launch: the median of each phase (ms, %globaltimer) beside the
median of the stamped launch's first-to-last stamp (the sorts' phases in
the layout of the checkout's csrc/radix_passes.cuh: `sort_phases`). The
shape holds each sort input's rank bits and 8-bit passes, each voxel
input's bits and passes under a rank whose z field is aligned to 256
(`aligned_rank_bits`: the rank whose low byte would be the key's own),
and each variant's ptxas -v lines (registers, stack, spills) of its sort
kernels. Prints one JSON line with the card's `nvidia-smi` name and
power limit (and writes it to `--out`).
"""
import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNELS = ("vio_select", "vio_observations")
STAGE_KERNELS = ("vio_push", "vio_dedup", "voxel_keys", "tiled_insert")
# the stage kernels' phases: (name, from stamp, to stamp)
STAGE_PHASES = {
    "vio_push": [("counts", 0, 1), ("barrier 1", 1, 2), ("slot keys", 2, 3),
                 ("barrier 2", 3, 4), ("copy", 4, 5), ("total", 0, 5)],
    # the one-barrier form: the ranks and the image read before its barrier
    "vio_push one": [("counts", 0, 1), ("ranks and image loads", 1, 6), ("barrier", 6, 2),
                     ("slot keys", 2, 3), ("copy", 4, 5), ("total", 0, 5)],
    "vio_dedup": [("keys", 0, 1), ("rounds", 1, 2), ("compaction", 2, 3), ("total", 0, 3)],
    "voxel_keys": [("total", 0, 1)],
}
IT_BASE, IT_NPH = 16, 8  # csrc/phase_stamps.cuh: a pass's stamps
# the tensors whose pointers the stage calls' launches hold: kept for the
# run (a launch's buffer freed and reused would be another tensor's)
KEEP = []


def sort_phases(passes, published):
    """The stamped phases of a sort's launch (voxel_sort, tiled_insert_sort:
    csrc/radix_passes.cuh) of `passes` passes. `published` (the header's
    form whose blocks publish each pass's counts for the others to read):
    the keys (the insert's with pass 0's ranking and published counts),
    the first barrier, what follows it (the insert's bitmap prefix sums),
    then each pass's work before its histogram column is read (its
    ranking, its counts published and, with one tile a block, its staging
    in shared memory), the column read and the offsets (the wait on the
    other blocks' counts), the scatter (with several tiles a block, their
    ranking and staging too) and its barrier. Else (the form
    before it): the keys, the first barrier, pass 0's count and second
    barrier, then each pass's offsets, ranking and scatter (with the next
    pass's histogram by atomics), and barrier."""
    it = lambda p, k: IT_BASE + p * IT_NPH + k  # noqa: E731
    ph = [("keys", 0, 1), ("barrier A", 1, 2)]
    if passes == 0:
        return ph
    if published:
        ph.append(("after barrier A", 2, it(0, 1)))
        for p in range(passes):
            ph += [(f"pass {p} before the column", it(p, 1), it(p, 2)),
                   (f"pass {p} column and offsets", it(p, 2), it(p, 3)),
                   (f"pass {p} scatter", it(p, 3), it(p, 4))]
            if p < passes - 1:
                ph.append((f"pass {p} barrier", it(p, 4), it(p, 5)))
        return ph + [("total", 0, it(passes - 1, 4))]
    ph += [("pass 0 count", 2, it(0, 0)), ("barrier B", it(0, 0), it(0, 1))]
    for p in range(passes):
        ph += [(f"pass {p} offsets", it(p, 1), it(p, 2)),
               (f"pass {p} rank and scatter", it(p, 2), it(p, 3))]
        if p < passes - 1:
            ph.append((f"pass {p} barrier", it(p, 3), it(p, 4)))
    return ph + [("total", 0, it(passes - 1, 3))]


def published_form(tree: str) -> bool:
    """Whether the checkout's csrc/radix_passes.cuh publishes each pass's
    counts (its stamps' layout)."""
    path = os.path.join(tree, "fastlivo_tpu_torch", "csrc", "radix_passes.cuh")
    with open(path) as fh:
        return "publish_count" in fh.read()


# the phases a stamped variant reports: (name, from stamp, to stamp), by
# kernel and launcher generation ("state": takes the state's rot and pos)
PHASES = {
    ("vio_select", "pose"): [
        ("reset and barrier", 0, 1), ("scan rows", 1, 2), ("voxels", 2, 3),
        ("barrier", 3, 4), ("cells", 4, 5), ("total", 0, 5)],
    ("vio_select", "state"): [
        ("pose and reset", 0, 5), ("barrier", 5, 1), ("voxels and scan rows", 1, 2),
        ("barrier 2", 2, 3), ("cells", 3, 4), ("total", 0, 4)],
    ("vio_observations", "pose"): [
        ("setup", 0, 1), ("prep", 1, 2), ("ring choice", 2, 3), ("ring writes", 3, 4),
        ("capacity mask (one thread)", 4, 5), ("new rows' writes", 5, 6), ("rank", 6, 7),
        ("groups (one thread)", 7, 8), ("claim rounds", 8, 9), ("appends", 9, 10),
        ("total", 0, 10)],
    ("vio_observations", "state"): [
        ("setup", 0, 1), ("row blocks: prep", 1, 6), ("insert: capacity mask", 1, 7),
        ("insert: rank", 7, 8), ("insert: groups", 8, 9), ("insert: claim rounds", 9, 10),
        ("insert: followers and appends", 10, 5), ("both", 1, 2), ("barrier", 2, 3),
        ("writes", 3, 4), ("total", 0, 4)],
}


def build(tree: str, name: str, stamps: bool):
    """csrc/<name>.cu of `tree`, compiled with this checkout's flags (and
    the stamps' defines); its source kept on the library as `source`, its
    ptxas -v output as `ptxas`."""
    from fastlivo_tpu_torch.ops import _build

    csrc = os.path.join(tree, "fastlivo_tpu_torch", "csrc")
    src = os.path.join(csrc, f"{name}.cu")
    flags = _build.NVCC_FLAGS + (["-DPHASE_STAMPS", "-DVIO_PHASE_STAMPS"] if stamps else [])
    flags = flags + ["-Xptxas", "-v"]
    h = hashlib.sha256(os.path.abspath(src).encode())
    for f in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    out_dir = _build.BUILD_DIR / "vio_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = str(out_dir / f"lib{name}-{h.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        res = subprocess.run([_build._nvcc(), *flags, "-o", out, src], capture_output=True,
                             text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
        with open(out + ".ptxas", "w") as fh:
            fh.write(res.stderr)
    lib = ctypes.CDLL(out)
    with open(src, "rb") as fh:
        lib.source = fh.read()
    lib.ptxas = ""
    if os.path.exists(out + ".ptxas"):
        with open(out + ".ptxas") as fh:
            lib.ptxas = fh.read()
    return lib


def aligned_rank_bits(keys) -> tuple:
    """(bits, 8-bit passes) of the voxel filter's rank over the packed keys
    (N,) int64 with its z field based at min_z rounded down to a multiple
    of 256 and R_z rounded up to one: the form whose low byte is the key's
    own z byte (fz & 255), so that pass 0's digit would be the key's alone;
    (0, 0) without a valid row. ops/voxel_filter.sort_span_plain gives the
    compact rank's, which the kernel sorts by."""
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    k = keys.cpu()
    vs = k != vf.INVALID
    if not bool(vs.any()):
        return 0, 0
    f = [((k[vs] >> s) & 0xFFFFF) for s in (40, 20, 0)]
    lo, hi = [int(x.min()) for x in f], [int(x.max()) for x in f]
    lz = lo[2] & ~255
    rz = -(-(hi[2] - lz + 1) // 256) * 256
    rinv = (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * rz  # an invalid row's rank
    bits = (rinv if bool((~vs).any()) else rinv - 1).bit_length()
    return bits, -(-bits // 8)


def sort_registers(ptxas: str) -> dict:
    """ptxas -v's registers, stack and spills of each sort kernel instance
    (a mangled name with `sort_kernel`) in a build's output."""
    out, name = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)",
                      line)
        if m:
            name = m.group(1) if "sort_kernel" in m.group(1) else None
            continue
        if name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(line.split(": ", 1)[-1].strip())
    return out


def inputs(dev, frames: int, seed: int):
    """vio_select's arguments (a dict: the map, the camera, the state, the
    frame; see the module docstring)."""
    import numpy as np
    import torch

    from fastlivo_tpu_torch import camera, vio
    from fastlivo_tpu_torch import visual_map as tvm
    from fastlivo_tpu_torch.config import CameraConfig
    from fastlivo_tpu_torch.ops import so3

    W, H, F = 640, 512, 400.0
    rng = np.random.default_rng(seed)
    cam = camera.from_config(CameraConfig(width=W, height=H, fx=F, fy=F, cx=(W - 1) / 2.0,
                                          cy=(H - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0]), dev)
    vm = tvm.empty_visual_map(n_points=1 << 16, n_obs=20, table_size=1 << 18, voxel_cap=8,
                              ring=256, height=H, width=W, img_dtype=torch.uint8, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    f64 = dict(dtype=torch.float64, device=dev)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 128.0 + 50.0 * np.sin(xx / 7.0 + rng.uniform(0, 6)) * np.cos(yy / 11.0)
    base = np.clip(base + 30.0 * np.sin((xx + 2 * yy) / 23.0) + rng.normal(0, 6.0, (H, W)),
                   0, 255).astype(np.float32)

    def pose(scale):  # a camera pose near the identity
        rot = so3.exp(torch.as_tensor(rng.normal(0, 0.03 * scale, 3), dtype=torch.float64))
        return (rot.numpy().astype(np.float32),
                rng.normal(0, 0.15 * scale, 3).astype(np.float32))

    def project(pts, rcw, pcw):
        return camera.world2cam(cam, t(pts @ rcw.T + pcw)).cpu().numpy().astype(np.float32)

    for f in range(frames):
        vm = tvm.push_image(vm, t(base + rng.normal(0, 2.0, base.shape).astype(np.float32)), f)
        rcw, pcw = pose(0.03)
        z = rng.uniform(2.0, 8.0, 192)
        pts = np.stack([z * rng.uniform(-0.6, 0.6, 192), z * rng.uniform(-0.45, 0.45, 192),
                        z], -1).astype(np.float32)
        vm = tvm.add_points(vm, t(pts), t(project(pts, rcw, pcw)), t(rcw), t(pcw),
                            t(rng.uniform(-5.0, 50.0, 192).astype(np.float32)), f,
                            t(rng.random(192) < 0.9))
        n = int(vm.n_pts)
        if f > 0:
            idx = np.unique(np.concatenate([np.arange(min(n, 576)),
                                            rng.integers(0, n, 150)])).astype(np.int32)
            K = len(idx)
            vm = tvm.add_observations(
                vm, t(idx), t(project(vm.pos[t(idx).long()].cpu().numpy(), rcw, pcw)),
                t(rcw), t(pcw), t(rng.uniform(0, 50, K).astype(np.float32)), f,
                t(rng.integers(0, 3, K).astype(np.int32)), t(rng.random(K) < 0.9))
    rot = so3.exp(torch.as_tensor(rng.normal(0, 0.0009, 3), **f64)).contiguous()
    pos = torch.as_tensor(rng.normal(0, 0.0045, 3), **f64)
    Rci = so3.exp(torch.as_tensor(rng.normal(0, 0.0009, 3), **f64)).float().contiguous()
    Pci = torch.as_tensor(rng.normal(0, 0.003, 3), dtype=torch.float32, device=dev)
    n, M = int(vm.n_pts), 8192
    pg = np.zeros((M, 3), np.float32)
    k = min(n, 3000)
    pg[:k] = vm.pos[:n].cpu().numpy()[rng.permutation(n)[:k]] + rng.normal(0, 0.05, (k, 3))
    z = rng.uniform(1.0, 10.0, 2000)
    pg[k:k + 2000] = np.stack([z * rng.uniform(-0.9, 0.9, 2000),
                               z * rng.uniform(-0.7, 0.7, 2000), z], -1)
    pg_mask = np.arange(M) < k + 2000
    pg_mask[rng.integers(0, k + 2000, 300)] = False
    pg, pg_mask = t(pg), t(pg_mask)
    vox, vox_mask = vio._dedup_voxels(pg, pg_mask, M // 2)
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(vm=vm, cam=cam, rot=rot, pos=pos, Rci=Rci, Pci=Pci, img=t(base), pg=pg,
                pg_mask=pg_mask, vox=vox, vox_mask=vox_mask,
                outlier_threshold=torch.tensor(300.0, **f32), ncc_thre=torch.tensor(0.5, **f32),
                grid_size=40, patch_size=8, gw=16, gh=12, ncc_en=False)


def obs_inputs(a, sel, seed: int):
    """vio_observations' arguments after vio_select's outputs `sel`: a
    posterior state 0.6 m from the prior, the pool's last frame id."""
    import numpy as np
    import torch

    from fastlivo_tpu_torch.ops import so3

    tracked, (npos, npx, nscore, nadd), (rcw, pcw) = sel
    rng = np.random.default_rng(seed + 1)
    f64 = dict(dtype=torch.float64, device=a["img"].device)
    rot2 = (so3.exp(torch.as_tensor(rng.normal(0, 0.003, 3), **f64)) @ a["rot"]).contiguous()
    pos2 = a["pos"] + torch.as_tensor(rng.normal(0, 0.015, 3) + [0.6, 0.0, 0.0], **f64)
    fid = a["vm"].img_fid.max().to(torch.int32)
    return (a["cam"], a["img"], rot2, pos2, a["Rci"], a["Pci"], tracked.idx, tracked.valid,
            tracked.search_level, rcw, pcw, npos, npx, nscore, nadd, fid)


def generation(lib) -> str:
    """"state" for a launcher that takes the state's rot and pos, "pose"
    for an older one that takes the camera poses."""
    return "state" if b"const void* rot" in lib.source else "pose"


def select_call(lib, a):
    """(launch, outputs): the variant's vio_select launch on `a`'s
    pointers, its outputs in vio_select_plain's order."""
    import torch

    from fastlivo_tpu_torch import vio

    gen = generation(lib)
    wide = hasattr(lib, "vio_select_wide_floats")  # takes the wide instance's scratch
    fn = lib.vio_select_launch
    fn.argtypes = ([ctypes.c_void_p] * ((48 if gen == "state" else 44) + wide)
                   + [ctypes.c_int] * 16 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    vm, cam, img, dev = a["vm"], a["cam"], a["img"], a["img"].device
    G, P, M, Nv = 192, 8, a["pg"].shape[0], a["vox"].shape[0]
    T, VC = vm.vox_idx.shape
    H, W = img.shape
    i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
    # the candidates (an index a row in the older kernels, index and
    # position, 16 bytes, in the newer), the cell keys, the owner image,
    # the rows' depth, pixels and scores
    NC = Nv * VC
    ws = torch.empty(4 * NC + 4 * G + H * W + 4 * M, **i32)
    o = 4 * NC
    scratch = [ws[o:o + 2 * G].view(torch.int64), ws[o + 2 * G:o + 4 * G].view(torch.int64),
               ws[o + 4 * G:o + 4 * G + H * W], ws[:4 * NC]]
    o += 4 * G + H * W
    scratch += [ws[o:o + M].view(torch.float32), ws[o + M:o + 3 * M].view(torch.float32),
                ws[o + 3 * M:o + 4 * M].view(torch.float32)]
    outs = [torch.empty(G, **i32), torch.empty((G, 3), **f32), torch.empty((G, 3, P, P), **f32),
            torch.empty(G, **i32), torch.empty(G, dtype=torch.bool, device=dev),
            torch.empty(G, **f32), torch.empty(G, **f32), torch.empty((G, 3), **f32),
            torch.empty((G, 2), **f32), torch.empty(G, **f32),
            torch.empty(G, dtype=torch.bool, device=dev)]
    if gen == "state":
        pose_in, pose_out = [a["rot"], a["pos"], a["Rci"], a["Pci"]], [
            torch.empty((3, 3), **f32), torch.empty(3, **f32)]
    else:
        pose_in, pose_out = list(vio._cam_pose(a["Rci"], a["Pci"], a["rot"], a["pos"])), []
    ptrs = [x.data_ptr() for x in (
        vm.pos, vm.value, vm.obs_px, vm.obs_rcw, vm.obs_pcw, vm.obs_slot, vm.obs_fid,
        vm.vox_keys, vm.vox_count, vm.vox_idx, vm.imgs, vm.img_fid, cam.fx, cam.fy, cam.cx,
        cam.cy, cam.d, *pose_in, img, a["pg"], a["pg_mask"], a["vox"], a["vox_mask"],
        a["outlier_threshold"], a["ncc_thre"], *scratch, *outs, *pose_out)] + [None] * wide
    ints = [vm.pos.shape[0], vm.obs_fid.shape[1], T, VC, vm.img_fid.shape[0], H, W, M, Nv, 40,
            12, G, P, 0, 12, 1]
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(*ptrs, *ints, ctypes.byref(grid), stream)
        if err:
            raise RuntimeError(f"vio_select: cudaError {err}")

    KEEP.append((ws, outs, pose_out))
    if gen == "pose":  # the pose it was given, as the newer ones return theirs
        pose_out = [t.clone() for t in pose_in]
    return launch, outs + pose_out, grid


def observations_call(lib, vm, oa):
    """(launch, outputs): the variant's vio_observations launch on the map
    `vm` (written in place) and the arguments `oa`; its outputs: the map's
    fields, opc, oscore, n_pts' and the posterior pose."""
    import torch

    from fastlivo_tpu_torch import vio

    gen = generation(lib)
    fn = lib.vio_observations_launch
    ws = b"void* nrow, void* ws" in lib.source  # the global scratch past 2048 rows
    n_ptr = (41 if ws else 40) if gen == "state" else 35
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                   + ([ctypes.POINTER(ctypes.c_int)] if gen == "state" else [])
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    (cam, img, rot2, pos2, Rci, Pci, t_idx, t_valid, t_slevel, rcw, pcw, npos, npx, nscore,
     nadd, fid) = oa
    dev, B = img.device, t_idx.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    opc, oscore = torch.empty((B, 2), **f32), torch.empty(B, **f32)
    n_pts = torch.empty((), dtype=torch.int32, device=dev)
    if gen == "state":  # and the new rows' scratch (and the global one)
        pose_in = [rot2, pos2, Rci, Pci]
        pose_out = [torch.empty((3, 3), **f32), torch.empty(3, **f32)]
        scratch = [torch.empty(B, dtype=torch.int32, device=dev)]
        if ws:
            size = lib.vio_observations_scratch_ints
            size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
            scratch.append(torch.zeros(max(size(B), 1), dtype=torch.int32, device=dev))
    else:
        pose_in = list(vio._cam_pose(Rci, Pci, rot2, pos2))
        pose_out, scratch = [], []
    ptrs = [x.data_ptr() for x in (
        vm.pos, vm.value, vm.n_obs, vm.n_pts, vm.obs_px, vm.obs_rcw, vm.obs_pcw, vm.obs_slot,
        vm.obs_fid, vm.obs_level, vm.vox_keys, vm.vox_count, vm.vox_idx, vm.img_fid, cam.fx,
        cam.fy, cam.cx, cam.cy, cam.d, img, *pose_in, rcw, pcw, fid, t_idx, t_valid, t_slevel,
        npos, npx, nscore, nadd, opc, oscore, n_pts, *pose_out, *scratch)]
    H, W = img.shape
    ints = [vm.pos.shape[0], vm.obs_fid.shape[1], vm.vox_keys.shape[0], vm.vox_idx.shape[1],
            vm.img_fid.shape[0], H, W, B, 12]
    grid = ctypes.c_int(0)
    tail = [ctypes.byref(grid)] if gen == "state" else []
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = fn(*ptrs, *ints, *tail, stream)
        if err:
            raise RuntimeError(f"vio_observations: cudaError {err}")

    KEEP.append((opc, oscore, n_pts, pose_out, scratch))
    if gen == "pose":
        pose_out = [t.clone() for t in pose_in]
    return launch, [*(getattr(vm, f) for f in vm._fields if f != "n_pts"), opc, oscore, n_pts,
                    *pose_out], grid


def stage_inputs(a, seed: int):
    """The stage kernels' inputs beside vio_select's `a`: the push's map,
    image and next frame id; the dedup's cloud; the key pass's LIO scan
    and camera cloud (see the module docstring)."""
    import numpy as np
    import torch

    dev = a["img"].device
    rng = np.random.default_rng(seed + 2)
    n = 32768
    scan = rng.uniform(-40, 40, (n, 4)).astype(np.float32)
    valid = np.arange(n) < 24000
    cloud = torch.zeros((n, 3), device=dev)
    cloud[:a["pg"].shape[0]] = a["pg"]
    f32 = dict(dtype=torch.float32, device=dev)
    pg3 = torch.cat([a["pg"], a["pg"] + 100.0, a["pg"] + 200.0])
    # the insert's batches: the LIO path's shape (16384 rows, 12000 valid,
    # on the synthetic room about the world origin, where every axis
    # straddles the directory's wrap) and a batch over +-70 m (3 passes)
    from fastlivo_tpu_torch.ops import tiled_map as tm

    lo, hi = np.array([-6.0, -5.0, -1.2]), np.array([6.0, 5.0, 2.0])
    face = rng.integers(0, 6, 16384)
    room = lo + rng.uniform(0, 1, (16384, 3)) * (hi - lo)
    room[np.arange(16384), face // 2] = np.where(face % 2 == 1, hi[face // 2], lo[face // 2])
    room += rng.normal(0, 0.004, room.shape)
    wide = np.stack([rng.uniform(-70, 70, 16384), rng.uniform(-70, 70, 16384),
                     rng.uniform(-3, 3, 16384)], 1)
    insert = {"lio batch": (tm.empty_tiled_map((128, 128, 64), 64, 0.5, device=dev),
                            torch.as_tensor(room.astype(np.float32), device=dev),
                            torch.arange(16384, device=dev) < 12000),
              "frame batch": (tm.empty_tiled_map((64, 64, 16), 64, 0.5, device=dev),
                              torch.as_tensor(wide.astype(np.float32), device=dev),
                              torch.as_tensor(rng.random(16384) > 0.05, device=dev))}
    # the LIO path's scan shape for the voxel sort: the room's faces about
    # the sensor, 24000 of 32768 rows valid, at 0.5 m (2 passes)
    face = rng.integers(0, 6, n)
    body = lo + rng.uniform(0, 1, (n, 3)) * (hi - lo)
    body[np.arange(n), face // 2] = np.where(face % 2 == 1, hi[face // 2], lo[face // 2])
    body = np.concatenate([body + rng.normal(0, 0.004, body.shape),
                           rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
    return {"push": (a["vm"], a["img"], (a["vm"].img_fid.max() + 1).to(torch.int32)),
            "dedup": (a["pg"], a["pg_mask"], a["pg"].shape[0] // 2),
            "dedup 24576": (pg3, a["pg_mask"].repeat(3), a["pg"].shape[0] // 2),
            "keys": {"lio scan": (torch.as_tensor(scan, device=dev),
                                  torch.as_tensor(valid, device=dev),
                                  torch.tensor(0.5, **f32), 1),
                     "camera cloud": (cloud, torch.arange(n, device=dev) < 8192,
                                      torch.tensor(np.float32(1) / np.float32(0.2), **f32),
                                      0),
                     "room scan": (torch.as_tensor(body, device=dev),
                                   torch.as_tensor(valid, device=dev),
                                   torch.tensor(0.5, **f32), 1)},
            "insert": insert}


def stage_plain(si):
    """The plain versions' outputs of the stage inputs."""
    import chip_smoke
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch import visual_map as tvm
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    vm, img, fid = si["push"]
    m = tvm.push_image_plain(chip_smoke.clone_map(vm), img, fid)
    out = {"vio_push": [m.img_fid, m.imgs], "vio_push two": [m.img_fid, m.imgs],
           "vio_push one 2 blocks an SM": [m.img_fid, m.imgs],
           "vio_dedup": list(vio._dedup_voxels_plain(*si["dedup"])),
           "vio_dedup 24576": list(vio._dedup_voxels_plain(*si["dedup 24576"]))}
    for src, (pts, valid, scale, divide) in si["keys"].items():
        args = (pts, valid, scale if divide else None, None if divide else scale)
        out[f"voxel_keys {src}"] = [vf.voxel_keys_plain(*args)]
        out[f"voxel_sort {src}"] = list(vf._sorted_keys_plain(*args))
    from fastlivo_tpu_torch.ops import tiled_map as tm

    for src, (m, pts, valid) in si["insert"].items():
        out[f"tiled_insert_sort {src}"] = list(tm.insert_sort_plain(m, pts, valid))
        out[f"insert keys + torch.sort {src}"] = out[f"tiled_insert_sort {src}"]
    return out


def stage_calls(lib, name, si):
    """{label: (launch, outputs)} of the variant's stage kernel `name` on
    the stage inputs (through its C entry, on the current stream)."""
    import torch

    import chip_smoke
    from fastlivo_tpu_torch.ops.photometric import _ticket

    i32 = dict(dtype=torch.int32)
    grid = ctypes.c_int(0)
    fn = getattr(lib, f"{name}_launch", None)  # (tiled_insert: its two entries below)
    if fn is not None:
        fn.restype = ctypes.c_int
    calls = {}

    def run(*args):
        def launch():
            err = fn(*args, ctypes.byref(grid), stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        return launch

    if name == "vio_push":
        vm, img, fid = si["push"]
        m = chip_smoke.clone_map(vm)
        stream = torch.cuda.current_stream(img.device).cuda_stream
        size = lib.vio_push_scratch_ints
        size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
        R = m.img_fid.shape[0]
        k = size(R)
        NP, KO = m.obs_fid.shape
        _, H, W = m.imgs.shape
        u8 = int(m.imgs.dtype == torch.uint8)
        if hasattr(lib, "vio_push_one_barrier_max_r"):  # two forms: the launcher's, forced
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
                ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
            form = ctypes.c_int(0)
            for label, f, blocks in (("vio_push", 0, 0), ("vio_push two", 2, 0),
                                     ("vio_push one 2 blocks an SM", 1, 264)):
                m2 = chip_smoke.clone_map(vm)
                KEEP.append(m2)
                p2 = [t.data_ptr() for t in (m2.obs_slot, m2.obs_fid, m2.n_pts, m2.img_fid,
                                             m2.imgs, img, fid)]

                def launch(p2=p2, f=f, blocks=blocks):
                    # the stream's scratch as the wrapper takes it, at each call
                    ws = _ticket(img.device, stream, k).data_ptr()
                    err = fn(*p2, ws, NP, KO, R, H, W, u8, f, blocks, ctypes.byref(grid),
                             ctypes.byref(form), stream)
                    if err:
                        raise RuntimeError(f"vio_push: cudaError {err}")

                calls[label] = (launch, [m2.img_fid, m2.imgs])
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
            KEEP.append(m)
            p1 = [t.data_ptr() for t in (m.obs_slot, m.obs_fid, m.n_pts, m.img_fid, m.imgs,
                                         img, fid)]

            def launch():
                ws = _ticket(img.device, stream, k).data_ptr()
                err = fn(*p1, ws, NP, KO, R, H, W, u8, ctypes.byref(grid), stream)
                if err:
                    raise RuntimeError(f"vio_push: cudaError {err}")

            calls["vio_push"] = (launch, [m.img_fid, m.imgs])
    elif name == "tiled_insert":
        keys = lib.tiled_insert_keys_launch
        keys.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
        keys.restype = ctypes.c_int
        sort = getattr(lib, "tiled_insert_sort_launch", None)
        for src, (m, pts, valid) in si["insert"].items():
            dev, B = pts.device, pts.shape[0]
            stream = torch.cuda.current_stream(dev).cuda_stream
            gkey = torch.empty(B, dtype=torch.int32, device=dev)
            rows = torch.empty((5, B), dtype=torch.int32, device=dev)
            res = [None, None, rows]
            KEEP.append(gkey)

            def route(args=(pts.data_ptr(), valid.data_ptr(), m.voxel_size.data_ptr(),
                            m.log2_dims.data_ptr(), gkey.data_ptr(), rows.data_ptr(), B),
                      stream=stream, gkey=gkey, res=res):
                err = keys(*args, stream)
                if err:
                    raise RuntimeError(f"tiled_insert_keys: cudaError {err}")
                res[0], res[1] = torch.sort(gkey, stable=True)

            calls[f"insert keys + torch.sort {src}"] = (route, res)
            if sort is None:
                continue
            sort.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] + [
                ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
            sort.restype = ctypes.c_int
            size = lib.tiled_insert_sort_scratch_ints
            size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
            sg = torch.empty(B, dtype=torch.int32, device=dev)
            order = torch.empty(B, dtype=torch.int64, device=dev)
            tmp = torch.empty(2 * B, dtype=torch.int32, device=dev)
            rows2 = torch.empty((5, B), dtype=torch.int32, device=dev)
            KEEP.append(tmp)
            tiles = ctypes.c_int(0)

            # each variant's sort on a scratch of its own (layouts differ
            # between checkouts), which every launch leaves at 0
            ws = torch.zeros(size(B), dtype=torch.int32, device=dev)
            KEEP.append(ws)

            def launch(args=(pts.data_ptr(), valid.data_ptr(), m.voxel_size.data_ptr(),
                             m.log2_dims.data_ptr(), sg.data_ptr(), order.data_ptr(),
                             tmp.data_ptr(), tmp[B:].data_ptr(), rows2.data_ptr(),
                             ws.data_ptr()),
                       stream=stream, tiles=tiles, B=B):
                err = sort(*args, B, ctypes.byref(grid), ctypes.byref(tiles), stream)
                if err:
                    raise RuntimeError(f"tiled_insert_sort: cudaError {err}")

            calls[f"tiled_insert_sort {src}"] = (launch, [sg, order, rows2])
    elif name == "vio_dedup":
        size = lib.vio_dedup_scratch_ints
        size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        for label in ("vio_dedup", "vio_dedup 24576"):
            pg, mask, max_vox = si[label.replace("vio_", "")]
            dev = pg.device
            stream = torch.cuda.current_stream(dev).cuda_stream
            vox = torch.empty((max_vox, 3), device=dev, **i32)
            vmask = torch.empty(max_vox, dtype=torch.bool, device=dev)

            def launch(args=(pg.data_ptr(), mask.data_ptr(), vox.data_ptr(), vmask.data_ptr()),
                       rest=(pg.shape[0], max_vox), k=size(pg.shape[0]), dev=dev,
                       stream=stream):
                ws = _ticket(dev, stream, k).data_ptr() if k else None
                err = fn(*args, ws, *rest, ctypes.byref(grid), stream)
                if err:
                    raise RuntimeError(f"vio_dedup: cudaError {err}")

            calls[label] = (launch, [vox, vmask])
    else:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [
            ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        for src, (pts, valid, scale, divide) in si["keys"].items():
            stream = torch.cuda.current_stream(pts.device).cuda_stream
            out = torch.empty(pts.shape[0], dtype=torch.int64, device=pts.device)
            calls[f"voxel_keys {src}"] = (run(pts.data_ptr(), valid.data_ptr(),
                                              scale.data_ptr(), divide, out.data_ptr(),
                                              pts.shape[0], pts.shape[1]), [out])
        sort = getattr(lib, "voxel_sort_launch", None)
        if sort is None:  # the route it replaced: the key pass, then torch.sort
            for src in si["keys"]:
                key_launch, (out,) = calls[f"voxel_keys {src}"]
                res = [None, None]

                def route(key_launch=key_launch, out=out, res=res):
                    key_launch()
                    res[0], res[1] = torch.sort(out, stable=True)

                calls[f"voxel_sort {src}"] = (route, res)
        else:
            sort.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
                ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
            sort.restype = ctypes.c_int
            size = lib.voxel_sort_scratch_ints
            size.argtypes, size.restype = [ctypes.c_int], ctypes.c_int
            tiles = ctypes.c_int(0)
            for src, (pts, valid, scale, divide) in si["keys"].items():
                dev, n = pts.device, pts.shape[0]
                stream = torch.cuda.current_stream(dev).cuda_stream
                keys = torch.empty(n, dtype=torch.int64, device=dev)
                order = torch.empty(n, dtype=torch.int64, device=dev)
                tmp = torch.empty(3 * n, dtype=torch.int32, device=dev)
                ws = torch.zeros(size(n), dtype=torch.int32, device=dev)  # its own, as above
                KEEP.extend([tmp, ws])

                def launch(args=(pts.data_ptr(), valid.data_ptr(), scale.data_ptr(), divide,
                                 keys.data_ptr(), order.data_ptr(), tmp.data_ptr(),
                                 tmp[2 * n:].data_ptr(), ws.data_ptr()),
                           rest=(n, pts.shape[1]), stream=stream):
                    err = sort(*args, *rest, ctypes.byref(grid), ctypes.byref(tiles), stream)
                    if err:
                        raise RuntimeError(f"voxel_sort: cudaError {err}")

                calls[f"voxel_sort {src}"] = (launch, [keys, order])
    return calls


def bits_equal(outs, want) -> bool:
    import chip_smoke

    return len(outs) == len(want) and all(
        chip_smoke.bits_diff(x, y) == 0.0 for x, y in zip(outs, want))


def stamped(lib, name, launch, reps, phases=None):
    """The stamped launch `reps` times alone: the median of each phase."""
    import numpy as np
    import torch

    if not hasattr(lib, f"{name}_stamps"):
        raise SystemExit(f"torch_vio_kernels_bench: {name} of this checkout has no phase "
                         "stamps (csrc/phase_stamps.cuh)")
    read = getattr(lib, f"{name}_stamps")
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    read.restype = ctypes.c_int
    phases = phases or PHASES[(name, generation(lib))]
    nst = max(max(a, b) for _, a, b in phases) + 1
    buf = (ctypes.c_ulonglong * nst)()
    read(buf, nst)  # reset
    rows = []
    for _ in range(reps + 1):
        launch()
        torch.cuda.synchronize()
        if read(buf, nst):
            raise RuntimeError(f"{name}: reading the stamps failed")
        rows.append([(int(buf[b]) - int(buf[a])) / 1e6 for _, a, b in phases])
    med = np.median(np.array(rows[1:]), axis=0)  # the first launch warms up
    return {p[0]: float(m) for p, m in zip(phases, med)}


def push_pools(pools, reps):
    """vio_push's two forms of this checkout timed in turns (one, two, two,
    one) on pools of R slots of 640 x 512 u8 frames, every slot holding a
    frame, over 65536 x 20 rings whose first 1400 rows observe random live
    slots (the LIVO path's live rows): {R: {form: ms}}, each the median of
    `reps` queued calls, the slot bit-equal to the plain version's."""
    import numpy as np
    import torch

    import chip_smoke
    from fastlivo_tpu_torch import visual_map as tvm
    from fastlivo_tpu_torch.ops import vio_push

    dev = torch.device("cuda")
    out = {}
    for R in pools:
        rng = np.random.default_rng(R)
        m = tvm.empty_visual_map(n_points=1 << 16, n_obs=20, table_size=1 << 10, voxel_cap=4,
                                 ring=R, height=512, width=640, img_dtype=torch.uint8,
                                 device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        m.img_fid.copy_(torch.as_tensor(rng.permutation(4 * R)[:R], **i32))
        slot = rng.integers(0, R, (1400, 20))
        m.obs_slot[:1400] = torch.as_tensor(slot, **i32)
        m.obs_fid[:1400] = m.img_fid[torch.as_tensor(slot, device=dev).long()]
        m.n_pts.fill_(1400)
        img = torch.as_tensor(rng.uniform(0, 255, (512, 640)).astype(np.float32), device=dev)
        fid = (m.img_fid.max() + 1).to(torch.int32)  # on the card: a call uploads nothing
        want = tvm.push_image_plain(chip_smoke.clone_map(m), img, fid).img_fid
        times = {1: [], 2: []}
        for form in (1, 2, 2, 1):
            mk = chip_smoke.clone_map(m)
            vio_push.vio_push(mk, img, fid, form=form)
            if not torch.equal(mk.img_fid, want):
                raise SystemExit(f"torch_vio_kernels_bench: vio_push form {form} at R = {R}: "
                                 f"not the plain version's slot")
            times[form].append(chip_smoke.time_ms(
                lambda: vio_push.vio_push(mk, img, fid, form=form), reps))
            del mk
        out[R] = {f"form {f}": t for f, t in times.items()}
        print(f"vio_push at R = {R}: " + ", ".join(f"{k} {v}" for k, v in out[R].items()),
              flush=True)
        del m
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--stamps", action="append", default=[])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--push-pools", type=int, nargs="*", default=[])
    args = ap.parse_args()
    variants = args.variant or ["."]

    import torch

    import chip_smoke
    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs

    if not torch.cuda.is_available():
        raise SystemExit("torch_vio_kernels_bench: needs a CUDA device")
    dev = torch.device("cuda")
    a = inputs(dev, args.frames, args.seed)
    kw = {k: v for k, v in a.items() if k != "vm"}
    plain_sel = vs.vio_select_plain(a["vm"], **kw)
    oa = obs_inputs(a, plain_sel, args.seed)
    pm = chip_smoke.clone_map(a["vm"])
    pvm, popc, posc, ppose = vo.vio_observations_plain(pm, *oa)
    want = {"vio_select": [*plain_sel[0], *plain_sel[1], *plain_sel[2]],
            "vio_observations": [*(getattr(pvm, f) for f in pvm._fields if f != "n_pts"),
                                 popc, posc, pvm.n_pts, *ppose]}
    del pm, pvm
    shape = {"G": 192, "M": a["pg"].shape[0], "Nv": a["vox"].shape[0],
             "KO": a["vm"].obs_fid.shape[1], "VC": a["vm"].vox_idx.shape[1],
             "T": a["vm"].vox_keys.shape[0], "map_points": int(a["vm"].n_pts),
             "full_rings": int((a["vm"].n_obs >= a["vm"].obs_fid.shape[1]).sum()),
             "tracked": int(plain_sel[0].valid.sum()), "added": int(plain_sel[1][3].sum())}
    si = stage_inputs(a, args.seed)
    want.update(stage_plain(si))
    calls, equal, grids, res = {}, {}, {}, {}
    stage_labels = ["vio_push", "vio_push two", "vio_push one 2 blocks an SM", "vio_dedup",
                    "vio_dedup 24576", "voxel_keys lio scan", "voxel_keys camera cloud",
                    "voxel_sort lio scan", "voxel_sort camera cloud", "voxel_sort room scan",
                    "tiled_insert_sort lio batch", "insert keys + torch.sort lio batch",
                    "tiled_insert_sort frame batch", "insert keys + torch.sort frame batch"]
    from fastlivo_tpu_torch.ops import tiled_map as tm
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    shape["sort_bits_passes"] = {src: vf.sort_span_plain(want[f"voxel_sort {src}"][0])
                                 for src in si["keys"]}
    shape["aligned_sort_bits_passes"] = {src: aligned_rank_bits(want[f"voxel_sort {src}"][0])
                                         for src in si["keys"]}
    shape["insert_sort_bits_passes"] = {
        src: tm.insert_span_plain(m, want[f"tiled_insert_sort {src}"][0])
        for src, (m, _, _) in si["insert"].items()}
    shape["sort_registers"] = {}
    for v in variants:
        tree = os.path.join(ROOT, v)
        for name in STAGE_KERNELS:
            if not os.path.exists(os.path.join(tree, "fastlivo_tpu_torch", "csrc",
                                               f"{name}.cu")):
                continue  # an older checkout: the stage ran as torch ops
            lib = build(tree, name, False)
            if name in ("voxel_keys", "tiled_insert"):
                shape["sort_registers"].setdefault(v, {}).update(sort_registers(lib.ptxas))
            for label, (launch, outs) in stage_calls(lib, name, si).items():
                launch()
                torch.cuda.synchronize()
                equal[(label, v)] = bits_equal(outs, want[label])
                calls[(label, v)] = launch
                KEEP.append(outs)
    for v in variants:
        libs = {name: build(os.path.join(ROOT, v), name, False) for name in KERNELS}
        launch, outs, grid = select_call(libs["vio_select"], a)
        launch()
        torch.cuda.synchronize()
        equal[("vio_select", v)] = bits_equal(outs, want["vio_select"])
        calls[("vio_select", v)] = launch
        KEEP.append(outs)
        grids[("vio_select", v)] = grid.value
        m = chip_smoke.clone_map(a["vm"])
        launch, outs, grid = observations_call(libs["vio_observations"], m, oa)
        launch()
        torch.cuda.synchronize()
        equal[("vio_observations", v)] = bits_equal(outs, want["vio_observations"])
        calls[("vio_observations", v)] = launch  # writes its copy again
        KEEP.append(outs)
        grids[("vio_observations", v)] = grid.value
    for name in list(KERNELS) + stage_labels:
        print(f"timing {name}", file=sys.stderr, flush=True)
        times = {v: [] for v in variants}
        host = {v: [] for v in variants}
        empty = []
        for v in variants + variants[::-1]:
            empty.append(chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps))
            if (name, v) not in calls:
                times[v], host[v] = None, None
                continue
            times[v].append(chip_smoke.time_ms(calls[(name, v)], args.reps))
            host[v].append(chip_smoke.host_ms(calls[(name, v)], args.reps))
            torch.cuda.synchronize()
        res[name] = {"ms": times, "launch_host_ms": host, "empty_kernel_ms": empty,
                     "bit_equal_to_plain": {v: equal.get((name, v)) for v in variants},
                     "grid": {v: grids.get((name, v)) for v in variants}}
    stamps = {}
    for v in args.stamps:
        tree = os.path.join(ROOT, v)
        libs = {name: build(tree, name, True) for name in KERNELS}
        launch, outs, _ = select_call(libs["vio_select"], a)
        s = {"vio_select": stamped(libs["vio_select"], "vio_select", launch, args.reps)}
        ok = bits_equal(outs, want["vio_select"])
        m = chip_smoke.clone_map(a["vm"])
        launch, outs, _ = observations_call(libs["vio_observations"], m, oa)
        s["vio_observations"] = stamped(libs["vio_observations"], "vio_observations", launch,
                                        args.reps)
        for name in STAGE_KERNELS:
            if not os.path.exists(os.path.join(tree, "fastlivo_tpu_torch", "csrc",
                                               f"{name}.cu")):
                continue
            lib = build(tree, name, True)
            for label, (launch, outs) in stage_calls(lib, name, si).items():
                if label.startswith("insert keys"):
                    continue  # the library route: no stamps
                if label.startswith("voxel_sort"):
                    if not hasattr(lib, "voxel_sort_launch"):
                        continue  # the library route: no stamps
                    passes = shape["sort_bits_passes"][label[len("voxel_sort "):]][1]
                    phases = sort_phases(passes, published_form(tree))
                elif label.startswith("tiled_insert_sort"):
                    passes = shape["insert_sort_bits_passes"][
                        label[len("tiled_insert_sort "):]][1]
                    phases = sort_phases(passes, published_form(tree))
                elif label.startswith("vio_push"):
                    one = hasattr(lib, "vio_push_one_barrier_max_r") and "two" not in label
                    phases = STAGE_PHASES["vio_push one" if one else "vio_push"]
                else:
                    phases = STAGE_PHASES[label.split(" ")[0]]
                print(f"stamps {label} ({v})", file=sys.stderr, flush=True)
                s[label] = stamped(lib, name, launch, args.reps, phases)
                ok = ok and bits_equal(outs, want[label])
        s["bit_equal_to_plain"] = ok
        stamps[v] = s
    line = json.dumps({"variants": variants, "shape": shape, "runs": res, "stamps": stamps,
                       "card": chip_smoke.nvidia_smi_line()})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    if args.push_pools:  # a second line
        line = json.dumps({"push_pools": push_pools(args.push_pools, args.reps),
                           "card": chip_smoke.nvidia_smi_line()})
        print(line)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    if not all(equal.values()):
        raise SystemExit(f"torch_vio_kernels_bench: not bit-equal to the plain versions: "
                         f"{[k for k, e in equal.items() if not e]}")


if __name__ == "__main__":
    main()
