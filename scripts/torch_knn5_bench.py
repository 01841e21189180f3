"""Device time of the standalone knn5_plane kernel of several checkouts
on one card.

Usage: python scripts/torch_knn5_bench.py [--variant TREE ...]
           [--n 16384] [--m 27] [--reps 30]

Each variant is csrc/knn5_plane.cu of the checkout at TREE, relative to
this one (default: this one, `.`; e.g. `build/parent` for an unpacked
parent commit), built with this checkout's nvcc flags into
build/fastlivo_tpu_torch/knn5_bench/. Every variant runs on the same
seeded candidate block (chip_smoke.random_block, N queries, M
candidates) and must be bit-exact against this checkout's
knn5_plane_plain. The variants are then timed in turns, forwards and
backwards (A B ... B A), each a median of `--reps` queued calls
(chip_smoke.time_ms), beside an empty kernel. Prints one JSON line with
the card's `nvidia-smi` name and power limit.
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


def build(tree: str) -> str:
    from fastlivo_tpu_torch.ops import _build

    src = os.path.join(tree, "fastlivo_tpu_torch", "csrc", "knn5_plane.cu")
    flags = _build.NVCC_FLAGS
    tag = hashlib.sha256((os.path.abspath(src) + " ".join(flags)).encode()).hexdigest()[:12]
    out_dir = _build.BUILD_DIR / "knn5_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = str(out_dir / f"libknn5_plane-{tag}.so")
    res = subprocess.run([_build._nvcc(), *flags, "-o", out, src], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--m", type=int, default=27)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    variants = args.variant or ["."]

    import torch

    import chip_smoke
    from fastlivo_tpu_torch.ops import knn_plane

    if not torch.cuda.is_available():
        raise SystemExit("torch_knn5_bench: needs a CUDA device")
    dev = torch.device("cuda")
    cand, found, q = (torch.from_numpy(a).to(dev)
                      for a in chip_smoke.random_block(args.n, args.m))
    want = knn_plane.knn5_plane_plain(cand, found, q)
    outs = [torch.empty_like(t) for t in want]
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for v in variants:
        fn = ctypes.CDLL(build(os.path.join(ROOT, v))).knn5_plane_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def call(fn=fn):
            err = fn(cand.data_ptr(), found.data_ptr(), q.data_ptr(), outs[0].data_ptr(),
                     outs[1].data_ptr(), outs[2].data_ptr(), args.n, args.m, 0.1, stream)
            if err:
                raise RuntimeError(f"{v}: cudaError {err}")

        call()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, want)):
            raise AssertionError(f"{v} is not bit-exact against knn5_plane_plain")
        calls[v] = call
    times = {v: [] for v in variants}
    empty = []
    for v in variants + variants[::-1]:
        empty.append(chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps))
        times[v].append(chip_smoke.time_ms(calls[v], args.reps))
    print(json.dumps({"n": args.n, "m": args.m, "ms": times, "empty_kernel_ms": empty,
                      "bound_ms": chip_smoke.knn5_bound_ms(args.n, args.m)[0],
                      "card": chip_smoke.nvidia_smi_line()}))


if __name__ == "__main__":
    main()
