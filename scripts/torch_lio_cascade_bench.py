"""Device time of the LIO cascade kernel (csrc/lio_cascade.cu) of several
checkouts on one card, whether their outputs are bit-equal, and where its
time goes.

Usage: python scripts/torch_lio_cascade_bench.py [--variant TREE ...]
           [--stamps TREE ...] [--n 16384] [--reps 30] [--out FILE]
           [--case MAP:ROUTE ...] [--radius R]

Each variant is csrc/lio_cascade.cu of the checkout at TREE, relative to
this one (default: this one, `.`; e.g. `build/parent` for an unpacked
parent commit), built with this checkout's nvcc flags into
build/fastlivo_tpu_torch/photometric_bench/ and launched through this
checkout's wrapper (ops/lio_cascade.py; a launcher of the older
signature, with the pose, the flags and a second level of chunk sums in
device scratch, gets that scratch). The inputs are seeded, at the LIO
path's shapes: a tiled map at the shipped directory dims (128 x 128 x 64
tiles of 8³ voxels of 0.5 m) holding 120000 points of a gently curved
surface, a scan of `--n` of them (drawn with replacement past 120000)
with 5 mm noise (every 17th masked out), a start pose ~6 mrad and ~4 cm
off, P' = 10 I, max_iter 4, radius 1 (M = 27). Each variant's outputs
are compared bit for bit with the first variant's and with the host loop
lio.lio_loop (this checkout's knn5_plane_tiled and step kernel; also
with knn5_plane_tiled_plain). The variants are then timed in turns,
forwards and backwards (A B ... B A), each a median of `--reps` queued
calls (chip_smoke.time_ms), beside an empty kernel. A `--stamps` variant
is built again with -DPHASE_STAMPS (csrc/phase_stamps.cuh) and launched
`--reps` times alone, synchronised, reading its phase stamps after each
launch: each phase summed over the iterations, the median over the
launches (torch_photometric_bench.stamped_phases).

Each `--route` (walk_tls, the default's; gather_tls: `cache_knn`, the
candidate block written by the cascade's first search and re-ranked at
the later ones, the host loop's gathered at the start pose by
tiled_map.knn_candidates; walk_ref and gather_ref: the reference's plane
fit) runs this checkout's cascade on the same scan and map, held bit for
bit against the host loop lio.lio_loop with lio.host_search (the kernel
search, or the backend's knn / topk_from_candidates and fit_plane_ref)
and the step kernel, then
both timed in turns (cascade, loop, loop, cascade): the cascade as the
variants are (queued calls, chip_smoke.time_ms), the loop one call alone
between two CUDA events (chip_smoke.event_ms: it reads its convergence
flag every iteration), each the median of `--reps`. Prints one
JSON line with the card's `nvidia-smi` name and power limit beside every
number (and writes it to `--out`).

Each `--case` MAP:ROUTE (MAP tiled, hash or dense; ROUTE as `--route`'s)
runs every variant on that map and route at `--radius` (default 1; 2:
M = 125, 3: M = 343): the hash map holds the same points in 2^20 slots
(inserted by this checkout's voxel_map.insert), the dense grid in 64 x
64 x 16 cells of 0.5 m. Each variant's outputs are held bit for bit
against the first variant's and against the host loop (lio.lio_loop
with lio.host_search, the kernels and the step kernel) and given its
bound (chip_smoke.lio_cascade_bound_ms), then the variants are timed in
turns, forwards and backwards, each a median of
`--reps` queued calls: e.g. `--variant build/p25 --variant . --radius 2`
times two trees' M = 125 instances (e.g. one tree's generic-M walks
against another's templated ones), each tree's csrc/lio_cascade_125.cu
or, where it has none, its lio_cascade.cu. At a
radius other than 1 and 2 each tree's lio_cascade_any.cu runs (the walks'
generic form); a tree without one is left out.
"""
import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_photometric_bench import build, stamped_phases  # noqa: E402

DIMS, POOL, VOXEL = (128, 128, 64), 2048, 0.5
MAX_ITER, RADIUS = 4, 1


def inputs(dev, n, seed=7):
    """lio_cascade's arguments (see the module docstring)."""
    import numpy as np
    import torch

    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import so3
    from fastlivo_tpu_torch.ops import tiled_map as tm

    rng = np.random.default_rng(seed)
    x_, y_ = rng.uniform(-8, 8, 120000), rng.uniform(-8, 8, 120000)
    z_ = 0.3 * np.sin(0.5 * x_) + 0.2 * np.cos(0.3 * y_) - 0.6 + rng.normal(0, 0.01, 120000)
    world = np.stack([x_, y_, z_], 1).astype(np.float32)
    m = tm.build_host(world, DIMS, POOL, VOXEL, device=dev)
    body = world[rng.choice(len(world), n, replace=n > len(world))]
    body = torch.from_numpy(body + rng.normal(0, 0.005, body.shape).astype(np.float32)).to(dev)
    pmask = torch.ones(n, dtype=torch.bool, device=dev)
    pmask[::17] = False
    bns = torch.sqrt(torch.sqrt(torch.sum(body * body, dim=-1)))
    f64 = dict(dtype=torch.float64, device=dev)
    rot = so3.exp(torch.tensor([0.004, -0.003, 0.006], **f64)).contiguous()
    x = torch.zeros(15, **f64)
    x[0:3] = torch.tensor([0.03, -0.02, 0.015], **f64)
    P_ = torch.eye(18, **f64) * 10.0
    return (m, body, bns, pmask, rot, x, rot, x.clone(), P_, MAX_ITER, RADIUS,
            lio.PLANE_THRESH, lio.GATES, lio.CONV)


def host_loop(a, plain_search=False):
    """lio.lio_loop on the cascade's arguments `a`: its search
    knn5_plane_tiled (or knn5_plane_tiled_plain), the step kernel."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import knn_plane

    knn = knn_plane.knn5_plane_tiled_plain if plain_search else knn_plane.knn5_plane_tiled
    m, radius, threshold = a[0], a[10], a[11]
    return lio.lio_loop(lambda pw: knn(m, pw, radius, threshold), *a[1:10])


def same(got, want) -> bool:
    """The cascade's outputs bit-equal to another run's (a loop's
    iterations are an int)."""
    import torch

    return int(got[6]) == int(want[6]) and all(
        torch.equal(x, y) for x, y in zip(got[:6], want[:6]))


ROUTES = ("walk_tls", "gather_tls", "walk_ref", "gather_ref")


def route_args(a, route):
    """The cascade's arguments `a` for a route: cache_knn or not, and the
    fit."""
    search, fit = route.split("_")
    return (*a, 12, search == "gather", fit)


def case_args(a, kind, route, radius, dev):
    """The cascade's arguments `a` on the map `kind` (tiled: a's own; hash:
    2^20 slots; dense: 64 x 64 x 16 cells, both holding a's map points), at
    `radius`, for a route."""
    import torch

    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    m = a[0]
    if kind != "tiled":
        live = m.cell_check != vm.EMPTY_CHECK
        pts = m.pts[live].contiguous()
        valid = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        m = (vm.insert(vm.empty_map(1 << 20, VOXEL, device=dev), pts, valid) if kind == "hash"
             else dm.insert(dm.empty_dense_map((64, 64, 16), VOXEL, device=dev), pts, valid))
    return route_args((m, *a[1:10], radius, *a[11:]), route)


def bind_hashed(lib):
    """The variant's hashed launch function, with this checkout's ctypes
    signature (ops/lio_cascade.py's hashed launcher)."""
    from fastlivo_tpu_torch.ops import _build
    from fastlivo_tpu_torch.ops import lio_cascade as lc

    fn = lib.lio_cascade_hashed_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 6 + lc._TAIL
    return _build.profiled("lio_cascade", fn)


def run_cases(cases, variants, a, radius, reps, dev):
    """Every variant on each MAP:ROUTE case at `radius`: bit-equal to the
    first variant and to the host loop, then timed in turns."""
    import torch

    import chip_smoke
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade as lc

    card = chip_smoke.nvidia_smi_line()
    # the templated walks' library at 27 and 125 candidates, the generic
    # form's (lio_cascade_any.cu, where a tree has one) at any other M
    name = lc.LIBRARIES.get((2 * radius + 1) ** 3, "lio_cascade_any")
    libs = {v: build(os.path.join(ROOT, v), name) or build(os.path.join(ROOT, v), "lio_cascade")
            for v in variants}
    variants = [v for v in variants if libs[v] is not None]
    bound = {v: (bind(libs[v]), bind_hashed(libs[v])) for v in variants}
    real = lc._launcher, lc._hashed_launcher
    out = {}
    try:
        for case in cases:
            kind, route = case.split(":")
            b = case_args(a, kind, route, radius, dev)
            calls, outs = {}, {}
            for v in variants:
                def call(t=bound[v][0], h=bound[v][1]):
                    lc._launcher = lambda lib=None: t
                    lc._hashed_launcher = lambda lib=None: h
                    return lc.lio_cascade(*b)

                outs[v] = call()
                torch.cuda.synchronize()
                calls[v] = call
            lc._launcher, lc._hashed_launcher = real
            loop = route_loop(b)
            ref = outs[variants[0]]
            # the bound (chip_smoke.lio_cascade_bound_ms) from the world
            # points of the host loop's searches
            pws = []
            knn = chip_smoke.map_search(b)
            lio.lio_loop(lambda pw: (pws.append(pw), knn(pw))[1], *b[1:10])
            bound_ms, by, _ = chip_smoke.lio_cascade_bound_ms(
                b[0], torch.cat(pws), b[1].shape[0], int(ref[6]), radius,
                **chip_smoke.cascade_options(b))
            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                times[v].append(chip_smoke.time_ms(calls[v], reps))
            out[case] = {"radius": radius, "iterations": int(ref[6]), "bound_ms": bound_ms,
                         "bound_by": by,
                         "bit_equal_to_first": {v: same(outs[v], ref) for v in variants},
                         "bit_equal_to_host_loop": {v: same(outs[v], loop) for v in variants},
                         "ms": times, "card": card}
            print(f"{case} radius {radius}: " + ", ".join(
                f"{v} {times[v]} ms" for v in variants) + f", bound {bound_ms:.6f} ms ({by}), "
                f"{int(ref[6])} iterations, "
                f"bit-equal {out[case]['bit_equal_to_first']} / host loop "
                f"{out[case]['bit_equal_to_host_loop']}; {card}")
            del b
            torch.cuda.empty_cache()
    finally:
        lc._launcher, lc._hashed_launcher = real
    return out


def route_loop(b):
    """lio.lio_loop on a route's arguments `b`, its search lio.host_search
    with the kernels (under cache_knn on the block knn_candidates gathers
    at the start pose, chip_smoke.gathered_block), the step kernel."""
    import chip_smoke

    return chip_smoke.lio_loop_on(b)


def bind(lib):
    """The variant's launch function with this checkout's ctypes signature
    (ops/lio_cascade.py's launcher). A launcher that still takes the pose
    and flags in device scratch (cur (24) f64 and ctl (2) int32 after x0)
    and a second level of chunk sums (part2 after part), and no group sums
    or tickets, gets scratch of its own: a call of this checkout's
    signature is passed on with those pointers in place of gsum and
    tickets (this checkout's part is at least as large as it needs). A
    launcher without the fit argument (the TLS fit only, its threshold an
    f32) gets the call without it, and one without the candidate block's
    two pointers (after the iteration count; null on the walk route) the
    call without those."""
    import torch

    from fastlivo_tpu_torch.ops import _build
    from fastlivo_tpu_torch.ops import lio_cascade as lc

    fn = lib.lio_cascade_launch
    fn.restype = ctypes.c_int
    tail = [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_double] * 2 \
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    if b"void* cand_out" in lib.source or b'"lio_cascade.cuh"' in lib.source:  # this signature
        fn.argtypes = [ctypes.c_void_p] * 27 + [ctypes.c_int] * 4 + lc._TAIL
        call = _build.profiled("lio_cascade", fn)
    elif b"int fit" in lib.source:  # no block: the call without its two pointers
        fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 4 + lc._TAIL

        def call(*args):
            with torch._C._profiler._RecordFunctionFast("lio_cascade"):
                return fn(*args[:25], *args[27:])
    elif b"void* part2" not in lib.source:  # no fit: the TLS fit, f32 threshold
        fn.argtypes = [ctypes.c_void_p] * 25 + tail

        def call(*args):
            with torch._C._profiler._RecordFunctionFast("lio_cascade"):
                return fn(*args[:25], *args[27:30], *args[31:])
    else:
        fn.argtypes = [ctypes.c_void_p] * 26 + tail
        scratch = {}

        def call(*args):  # 15 inputs, part, gsum, tickets, 7 outputs, the block, n, ...
            n = args[27]
            if n not in scratch:
                nch = max(-(-n // 64), 1)
                scratch[n] = [torch.empty(24, dtype=torch.float64, device="cuda"),
                              torch.empty(2, dtype=torch.int32, device="cuda"),
                              torch.empty((max(-(-nch // 64), 1), 42), device="cuda")]
            cur, ctl, part2 = (t.data_ptr() for t in scratch[n])
            with torch._C._profiler._RecordFunctionFast("lio_cascade"):
                return fn(*args[:15], cur, ctl, args[15], part2, *args[18:25], *args[27:30],
                          *args[31:])
    call.lib = lib
    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--stamps", action="append", default=[])
    ap.add_argument("--route", action="append", default=None, choices=ROUTES)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    ap.add_argument("--case", action="append", default=[])
    ap.add_argument("--radius", type=int, default=RADIUS)
    args = ap.parse_args()
    variants = args.variant or ["."]

    import torch

    import chip_smoke
    from fastlivo_tpu_torch.ops import lio_cascade as lc

    if not torch.cuda.is_available():
        raise SystemExit("torch_lio_cascade_bench: needs a CUDA device")
    a = inputs(torch.device("cuda"), args.n)
    loops = {"knn5_plane_tiled": host_loop(a), "knn5_plane_tiled_plain": host_loop(a, True)}
    real = lc._launcher
    calls, outs, grids = {}, {}, {}
    try:
        for v in variants:
            def call(bound=bind(build(os.path.join(ROOT, v), "lio_cascade"))):
                lc._launcher = lambda lib=None: bound
                return lc.lio_cascade(*a)

            outs[v] = call()
            torch.cuda.synchronize()
            calls[v], grids[v] = call, lc.lio_cascade.grid
        ref = outs[variants[0]]
        res = {"iterations": int(ref[6]), "grid": grids,
               "bit_equal_to_first": {v: same(outs[v], ref) for v in variants},
               "bit_equal_to_host_loop": {k: {v: same(outs[v], w) for v in variants}
                                          for k, w in loops.items()}}
        times = {v: [] for v in variants}
        empty = []
        for v in variants + variants[::-1]:
            empty.append(chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps))
            times[v].append(chip_smoke.time_ms(calls[v], args.reps))
        res.update(ms=times, empty_kernel_ms=empty)
        stamps = {}
        for v in args.stamps:
            bound = bind(build(os.path.join(ROOT, v), "lio_cascade", stamps=True))
            lc._launcher = lambda lib=None, bound=bound: bound
            stamps[v] = stamped_phases(bound.lib, "lio_cascade", lambda: lc.lio_cascade(*a),
                                       args.reps)
    finally:
        lc._launcher = real
    card = chip_smoke.nvidia_smi_line()
    routes = {}
    for route in args.route or []:
        b = route_args(a, route)
        got, loop = lc.lio_cascade(*b), route_loop(b)
        ms = {"cascade": [], "host_loop": []}
        for k in ("cascade", "host_loop", "host_loop", "cascade"):
            if k == "cascade":
                ms[k].append(chip_smoke.time_ms(lambda: lc.lio_cascade(*b), args.reps))
            else:
                ms[k].append(chip_smoke.event_ms(lambda: route_loop(b), args.reps))
        routes[route] = {"iterations": int(got[6]), "bit_equal_to_host_loop": same(got, loop),
                         "grid": lc.lio_cascade.grid, "ms": ms, "card": card}
        print(f"{route}: cascade {ms['cascade']} ms, host loop {ms['host_loop']} ms, "
              f"{int(got[6])} iterations, bit-equal {routes[route]['bit_equal_to_host_loop']}; "
              f"{card}")
    cases = run_cases(args.case, variants, a, args.radius, args.reps, torch.device("cuda"))
    line = json.dumps({"variants": variants, "n": args.n, "runs": res, "stamps": stamps,
                       "routes": routes, "cases": cases, "card": card})
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
