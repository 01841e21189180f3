"""Device time of the photometric kernels of several checkouts on one
card, and whether their outputs are bit-equal.

Usage: python scripts/torch_photometric_bench.py [--variant TREE ...]
           [--stamps TREE ...] [--g 192] [--reps 30] [--out FILE]

Each variant is csrc/photometric_err_H.cu and, where the checkout has
it, csrc/photometric_cascade.cu (the cascade and the step alone) of the
checkout at TREE, relative to this one (default: this one, `.`; e.g.
`build/parent` for an unpacked parent commit), built with this
checkout's nvcc flags into build/fastlivo_tpu_torch/photometric_bench/
and launched through this checkout's wrappers (ops/photometric.py; a
cascade launcher that still takes the pose and level in device scratch
gets its own). The inputs are seeded: a textured 640x512 image, a camera
with some distortion, G tracked points at 2-8 m whose reference patches
were sampled at a pose ~2 cm and ~5 mrad from the start pose, 85% valid,
P = 8, the cascade over levels (2, 1, 0) with at most 10 iterations a
level. Each variant's outputs are compared bit for bit with the first
variant's: one photometric_err_H launch at level 0, one cascade and one
step (at the start pose, on the plain measurement's [HᵀH | Hᵀz]; a step
kernel without the convergence thresholds among its arguments is called
without them); each cascade also with the host loop vio.photometric_loop
(this checkout's measurement and step kernels). The variants are then
timed in turns, forwards and backwards (A B ... B A), each a median of
`--reps` queued calls (chip_smoke.time_ms), beside an empty kernel. A
`--stamps` variant is built again with -DPHASE_STAMPS
(csrc/phase_stamps.cuh) and its cascade launched `--reps` times alone,
synchronised, reading its phase stamps after each launch: each phase
summed over the iterations (stamped_phases), the median over the
launches. Prints one JSON line with the card's `nvidia-smi` name and
power limit (and writes it to `--out`).
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


# a cascade's phases: (name, from boundary, to boundary) of each
# iteration's PHASE_STAMP_IT slots; a kernel without a boundary (one grid
# barrier an iteration has no 6) reports no such phase
PHASES = [("measurement or search", 0, 1), ("barrier", 1, 2), ("reduction", 2, 3),
          ("step", 3, 4), ("carry", 4, 5), ("second barrier", 5, 6)]
IT_BASE, IT_MAX, IT_NPH = 16, 64, 8  # csrc/phase_stamps.cuh


def build(tree: str, name: str, stamps: bool = False):
    """csrc/<name>.cu of the checkout at `tree`, compiled with this
    checkout's flags (and -DPHASE_STAMPS) into
    build/fastlivo_tpu_torch/photometric_bench/; None where the checkout
    has no such source. Its source is kept on the library as `source`."""
    from fastlivo_tpu_torch.ops import _build

    src = os.path.join(tree, "fastlivo_tpu_torch", "csrc", f"{name}.cu")
    if not os.path.exists(src):
        return None
    flags = _build.NVCC_FLAGS + (["-DPHASE_STAMPS"] if stamps else [])
    h = hashlib.sha256(os.path.abspath(src).encode())
    for f in sorted(os.listdir(os.path.dirname(src))):
        with open(os.path.join(os.path.dirname(src), f), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    out_dir = _build.BUILD_DIR / "photometric_bench"
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


def stamped_phases(lib, name, launch, reps):
    """The stamped cascade `launch` `reps` times alone (after one warm-up
    launch), synchronised, its stamps read after each: per launch each
    phase summed over the recorded iterations, the setup (kernel start to
    the first iteration) and the total (kernel start to its last block's
    end); the median of each over the launches (ms), with the iterations
    recorded."""
    import numpy as np
    import torch

    if not hasattr(lib, f"{name}_stamps"):
        raise SystemExit(f"{name} of this checkout has no phase stamps (csrc/phase_stamps.cuh)")
    read = getattr(lib, f"{name}_stamps")
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
    read.restype = ctypes.c_int
    n = IT_BASE + IT_MAX * IT_NPH
    buf = (ctypes.c_ulonglong * n)()
    read(buf, n)  # reset
    rows = []
    for _ in range(reps + 1):
        launch()
        torch.cuda.synchronize()
        if read(buf, n):
            raise RuntimeError(f"{name}: reading the stamps failed")
        t = np.array(buf[IT_BASE:], dtype=np.float64).reshape(IT_MAX, IT_NPH)
        its = int((t[:, 0] > 0).sum())
        t = t[:its]
        row = {"setup": (t[0, 0] - buf[0]) / 1e6, "total": (int(buf[1]) - int(buf[0])) / 1e6,
               "iterations": its}
        for label, a, b in PHASES:
            if (t[:, b] > 0).all():
                row[label] = float((t[:, b] - t[:, a]).sum()) / 1e6
        rows.append(row)
    rows = rows[1:]  # the first launch warms up
    return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def inputs(dev, G, seed=0):
    """photometric_cascade's arguments (see the module docstring)."""
    import numpy as np
    import torch

    from fastlivo_tpu_torch import camera
    from fastlivo_tpu_torch.config import CameraConfig
    from fastlivo_tpu_torch.ops import image, so3

    rng = np.random.default_rng(seed)
    H, W, P = 512, 640, 8
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = torch.from_numpy((100 + 50 * np.sin(0.21 * xx) * np.cos(0.17 * yy)
                            + rng.normal(0, 5, (H, W))).astype(np.float32))
    cc = CameraConfig(width=W, height=H, fx=400.0, fy=400.0, cx=319.5, cy=255.5,
                      d=[0.01, -0.005, 0.001, 0.0005])
    Rci = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    Pci = np.array([0.05, -0.02, 0.1])
    Pic = -Rci.T @ Pci
    skew_pic = np.array([[0, -Pic[2], Pic[1]], [Pic[2], 0, -Pic[0]], [-Pic[1], Pic[0], 0]])
    f64 = dict(dtype=torch.float64)
    rot = so3.exp(torch.tensor([0.05, -0.1, 0.3], **f64))
    pos = torch.tensor([1.0, -2.0, 0.5], **f64)
    z = rng.uniform(2, 8, G)
    px = np.stack([rng.uniform(0, W - 1, G), rng.uniform(0, H - 1, G)], 1)
    pf = np.stack([(px[:, 0] - 319.5) / 400 * z, (px[:, 1] - 255.5) / 400 * z, z], 1)
    rcw = Rci.astype(np.float32) @ rot.numpy().astype(np.float32).T
    pcw = -rcw @ pos.numpy().astype(np.float32) + Pci.astype(np.float32)
    tr_pos = ((pf - pcw) @ rcw).astype(np.float32)
    slevel = rng.integers(0, 3, G).astype(np.int32)
    pc = camera.world2cam(camera.from_config(cc, "cpu"), torch.from_numpy(pf.astype(np.float32)))
    patch = np.stack([
        image.patches_and_grads(img, pc, P, torch.from_numpy((1 << lv) << slevel))[0].numpy()
        + rng.normal(0, 2, (G, P, P)) for lv in range(3)], 1).astype(np.float32)
    rot0 = (rot @ so3.exp(torch.tensor([0.004, -0.003, 0.002], **f64))).contiguous()
    x0 = torch.cat([pos + torch.tensor([0.02, -0.015, 0.01], **f64),
                    torch.tensor([0.3, -0.1, 0.0, 1e-3, -2e-3, 5e-4, 0.01, 0.02, -0.01,
                                  0.0, 0.0, -9.81], **f64)])
    A = rng.normal(size=(18, 18)) * 0.003
    cov = A @ A.T + np.diag(np.r_[np.full(3, 1e-4), np.full(3, 1e-3), np.full(12, 1e-4)])
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    return (img.to(dev), t32(tr_pos), t32(patch), torch.from_numpy(slevel).to(dev),
            torch.from_numpy(rng.random(G) < 0.85).to(dev), rot0.to(dev), x0.to(dev),
            rot0.to(dev), x0.clone().to(dev), torch.as_tensor(cov / 100.0, **f64).to(dev),
            t32(Rci), t32(Pci), t32(Rci), t32(-Rci @ skew_pic),
            camera.from_config(cc, dev), (2, 1, 0), P, 10, "none", 10.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--stamps", action="append", default=[])
    ap.add_argument("--g", type=int, default=192)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    variants = args.variant or ["."]

    import torch

    import chip_smoke
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import photometric as ph

    if not torch.cuda.is_available():
        raise SystemExit("torch_photometric_bench: needs a CUDA device")
    dev = torch.device("cuda")
    a = inputs(dev, args.g)
    meas = [a[0], a[1], a[2][:, 0], a[3], a[4], a[5], a[6][0:3], a[10], a[11], a[12], a[13],
            a[14], 0, a[16], a[18], a[19]]
    HT = ph.photometric_err_H_plain(*meas, partials=True)[0][:42].view(6, 7).contiguous()
    step = (a[5], a[6], a[7], a[8], a[9], HT)
    real = (ph._launcher, ph._cascade_launcher, ph._step_launcher)
    loop = vio.photometric_loop(*a)
    calls, outs = {}, {}
    try:
        for v in variants:
            libs = [build(os.path.join(ROOT, v), n)
                    for n in ("photometric_err_H", "photometric_cascade")]
            for kernel, lib, launcher, fn in (
                    ("photometric_err_H", libs[0], "_launcher",
                     lambda: ph.photometric_err_H(*meas)),
                    ("photometric_cascade", libs[1], "_cascade_launcher",
                     lambda: ph.photometric_cascade(*a)),
                    ("photometric_step", libs[1], "_step_launcher",
                     lambda: ph.photometric_step(*step))):
                if lib is None:
                    continue

                # this checkout's wrapper, that variant's library
                def call(bound=_bind(lib, kernel), launcher=launcher, fn=fn):
                    setattr(ph, launcher, lambda: bound)
                    return fn()

                outs[(kernel, v)] = call()
                torch.cuda.synchronize()
                calls[(kernel, v)] = call
    finally:
        ph._launcher, ph._cascade_launcher, ph._step_launcher = real
    res = {}
    for kernel in ("photometric_err_H", "photometric_cascade", "photometric_step"):
        vs = [v for v in variants if (kernel, v) in calls]
        ref = outs[(kernel, vs[0])]
        equal = {v: all(torch.equal(x, y) for x, y in zip(outs[(kernel, v)], ref)) for v in vs}
        times = {v: [] for v in vs}
        empty = []
        for v in vs + vs[::-1]:
            empty.append(chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps))
            times[v].append(chip_smoke.time_ms(calls[(kernel, v)], args.reps))
        res[kernel] = {"ms": times, "bit_equal_to_first": equal, "empty_kernel_ms": empty}
        if kernel == "photometric_cascade":
            res[kernel]["iterations"] = int(ref[5])
            res[kernel]["bit_equal_to_host_loop"] = {
                v: int(outs[(kernel, v)][5]) == loop[5]
                and all(torch.equal(x, y) for x, y in zip(outs[(kernel, v)][:5], loop[:5]))
                for v in vs}
    stamps = {}
    try:
        for v in args.stamps:
            bound = _bind(build(os.path.join(ROOT, v), "photometric_cascade", stamps=True),
                          "photometric_cascade")
            ph._cascade_launcher = lambda bound=bound: bound
            stamps[v] = stamped_phases(bound.lib, "photometric_cascade",
                                       lambda: ph.photometric_cascade(*a), args.reps)
    finally:
        ph._launcher, ph._cascade_launcher, ph._step_launcher = real
    line = json.dumps({"variants": variants, "g": args.g, "runs": res, "stamps": stamps,
                       "card": chip_smoke.nvidia_smi_line()})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


def _bind(lib, kernel):
    """The variant's launch function with this checkout's ctypes
    signature (ops/photometric.py's launchers)."""
    from fastlivo_tpu_torch.ops import _build

    if kernel == "photometric_err_H":
        fn = lib.photometric_err_H_launch
        fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    elif kernel == "photometric_step":
        fn = lib.photometric_step_launch
        fn.restype = ctypes.c_int
        if b"conv_rot_deg" in lib.source:
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
            return _build.profiled(kernel, fn)
        fn.argtypes = [ctypes.c_void_p] * 11  # its thresholds were constants

        def old(*args):  # (10 pointers, conv_rot, conv_pos, stream)
            return fn(*args[:10], args[12])

        return _build.profiled(kernel, old)
    else:
        fn = lib.photometric_cascade_launch
        tail = ([ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        if b"void* ctl" in lib.source:  # the pose and level in device scratch
            import torch

            fn.argtypes = [ctypes.c_void_p] * 29 + tail
            cur = torch.empty(24, dtype=torch.float64, device="cuda")
            ctl = torch.empty(2, dtype=torch.int32, device="cuda")

            def old(*args):  # 19 inputs, partial, perr_cur, 6 outputs, ...
                return fn(*args[:19], cur.data_ptr(), ctl.data_ptr(), *args[19:])

            call = _build.profiled(kernel, old)
            call.lib = lib
            return call
        fn.argtypes = [ctypes.c_void_p] * 27 + tail
    fn.restype = ctypes.c_int
    call = _build.profiled(kernel, fn)
    call.lib = lib
    return call


if __name__ == "__main__":
    main()
