"""Device time of the camera frame's two kernels (vio_select,
vio_observations) of several checkouts on one card, whether their outputs
are bit-equal, and where each one's time goes.

Usage: python scripts/torch_vio_kernels_bench.py [--variant TREE ...]
           [--stamps TREE ...] [--reps 30] [--frames 24] [--seed 0]
           [--out FILE]

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
median of the stamped launch's first-to-last stamp. Prints one JSON line
with the card's `nvidia-smi` name and power limit (and writes it to
`--out`).
"""
import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KERNELS = ("vio_select", "vio_observations")
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
    the stamps' defines); its source kept on the library as `source`."""
    from fastlivo_tpu_torch.ops import _build

    csrc = os.path.join(tree, "fastlivo_tpu_torch", "csrc")
    src = os.path.join(csrc, f"{name}.cu")
    flags = _build.NVCC_FLAGS + (["-DPHASE_STAMPS", "-DVIO_PHASE_STAMPS"] if stamps else [])
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
    lib = ctypes.CDLL(out)
    with open(src, "rb") as fh:
        lib.source = fh.read()
    return lib


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

    if gen == "pose":
        pose_out = [t.clone() for t in pose_in]
    return launch, [*(getattr(vm, f) for f in vm._fields if f != "n_pts"), opc, oscore, n_pts,
                    *pose_out], grid


def bits_equal(outs, want) -> bool:
    import chip_smoke

    return len(outs) == len(want) and all(
        chip_smoke.bits_diff(x, y) == 0.0 for x, y in zip(outs, want))


def stamped(lib, name, launch, reps):
    """The stamped launch `reps` times alone: the median of each phase."""
    import numpy as np
    import torch

    if not hasattr(lib, f"{name}_stamps"):
        raise SystemExit(f"torch_vio_kernels_bench: {name} of this checkout has no phase "
                         "stamps (csrc/phase_stamps.cuh)")
    read = getattr(lib, f"{name}_stamps")
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    read(buf, 16)  # reset
    phases = PHASES[(name, generation(lib))]
    rows = []
    for _ in range(reps + 1):
        launch()
        torch.cuda.synchronize()
        if read(buf, 16):
            raise RuntimeError(f"{name}: reading the stamps failed")
        rows.append([(int(buf[b]) - int(buf[a])) / 1e6 for _, a, b in phases])
    med = np.median(np.array(rows[1:]), axis=0)  # the first launch warms up
    return {p[0]: float(m) for p, m in zip(phases, med)}


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--stamps", action="append", default=[])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
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
    calls, equal, grids, res = {}, {}, {}, {}
    for v in variants:
        tree = os.path.join(ROOT, v)
        libs = {name: build(tree, name, False) for name in KERNELS}
        launch, outs, grid = select_call(libs["vio_select"], a)
        launch()
        torch.cuda.synchronize()
        equal[("vio_select", v)] = bits_equal(outs, want["vio_select"])
        calls[("vio_select", v)] = launch
        grids[("vio_select", v)] = grid.value
        m = chip_smoke.clone_map(a["vm"])
        launch, outs, grid = observations_call(libs["vio_observations"], m, oa)
        launch()
        torch.cuda.synchronize()
        equal[("vio_observations", v)] = bits_equal(outs, want["vio_observations"])
        calls[("vio_observations", v)] = launch  # writes its copy again
        grids[("vio_observations", v)] = grid.value
    for name in KERNELS:
        times = {v: [] for v in variants}
        host = {v: [] for v in variants}
        empty = []
        for v in variants + variants[::-1]:
            empty.append(chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps))
            times[v].append(chip_smoke.time_ms(calls[(name, v)], args.reps))
            host[v].append(chip_smoke.host_ms(calls[(name, v)], args.reps))
            torch.cuda.synchronize()
        res[name] = {"ms": times, "launch_host_ms": host, "empty_kernel_ms": empty,
                     "bit_equal_to_plain": {v: equal[(name, v)] for v in variants},
                     "grid": {v: grids[(name, v)] for v in variants}}
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
        s["bit_equal_to_plain"] = ok
        stamps[v] = s
    line = json.dumps({"variants": variants, "shape": shape, "runs": res, "stamps": stamps,
                       "card": chip_smoke.nvidia_smi_line()})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    if not all(equal.values()):
        raise SystemExit(f"torch_vio_kernels_bench: not bit-equal to the plain versions: "
                         f"{[k for k, e in equal.items() if not e]}")


if __name__ == "__main__":
    main()
