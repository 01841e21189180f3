"""Device time of the imu_propagate kernel of several checkouts on one
card, and whether their outputs are bit-equal.

Usage: python scripts/torch_imu_bench.py [--variant TREE ...]
           [--b 8 32 64 256 300 512] [--reps 30]

Each variant is csrc/imu_propagate.cu of the checkout at TREE, relative
to this one (default: this one, `.`; e.g. `build/parent` for an unpacked
parent commit), built with this checkout's nvcc flags into
build/fastlivo_tpu_torch/imu_bench/. At each group size B every variant
runs on the same seeded group (chip_smoke.imu_inputs: a 200 Hz stream
through imu.prepare_pairs, min(B, 21 at B = 32) valid pairs) and its
outputs are compared bit for bit with the first variant's; a variant
that refuses B (the launch returns an error) is listed as refusing it.
The variants are then timed in turns, forwards and backwards (A B ... B
A), each a median of `--reps` queued calls (chip_smoke.time_ms), beside
an empty kernel. Prints one JSON line with the card's `nvidia-smi` name
and power limit.
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

    src = os.path.join(tree, "fastlivo_tpu_torch", "csrc", "imu_propagate.cu")
    flags = _build.NVCC_FLAGS
    with open(src, "rb") as f:
        body = f.read()
    tag = hashlib.sha256(os.path.abspath(src).encode() + body
                         + " ".join(flags).encode()).hexdigest()[:12]
    out_dir = _build.BUILD_DIR / "imu_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = str(out_dir / f"libimu_propagate-{tag}.so")
    res = subprocess.run([_build._nvcc(), *flags, "-o", out, src], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None)
    ap.add_argument("--b", type=int, nargs="+", default=[8, 32, 64, 256, 300, 512])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    variants = args.variant or ["."]

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("torch_imu_bench: needs a CUDA device")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    for v in variants:
        fn = ctypes.CDLL(build(os.path.join(ROOT, v))).imu_propagate_launch
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[v] = fn
    res = []
    for B in args.b:
        nv = 21 if B == 32 else B
        s, w, a, g, calib = chip_smoke.imu_inputs(dev, B, nv, seed=B)
        ins = [w, s.rot, s.pos, s.vel, s.bg, s.ba, s.grav, s.cov, a, g, calib.acc_scale,
               calib.cov_acc, calib.cov_gyr, calib.cov_bias_acc, calib.cov_bias_gyr]
        f64 = dict(dtype=torch.float64, device=dev)
        calls, outs, refused = {}, {}, []
        for v, fn in fns.items():
            out = [torch.empty((3, 3), **f64), torch.empty(3, **f64), torch.empty(3, **f64),
                   torch.empty((18, 18), **f64), torch.empty((B + 2, 24), **f64),
                   torch.empty(3, **f64), torch.empty(3, **f64)]
            ptrs = [t.data_ptr() for t in ins + out]

            def call(fn=fn, ptrs=ptrs, v=v):
                err = fn(*ptrs, B, stream)
                if err:
                    raise RuntimeError(f"{v}: cudaError {err}")

            if fn(*ptrs, B, stream):
                refused.append(v)
                continue
            torch.cuda.synchronize()
            calls[v], outs[v] = call, out
        ref = next(iter(outs.values()))
        equal = {v: all(torch.equal(x, y) for x, y in zip(o, ref)) for v, o in outs.items()}
        times = {v: [] for v in calls}
        empty = []
        order = list(calls)
        for v in order + order[::-1]:
            empty.append(chip_smoke.time_ms(lambda: torch.cuda._sleep(0), args.reps))
            times[v].append(chip_smoke.time_ms(calls[v], args.reps))
        res.append({"B": B, "valid_pairs": nv, "ms": times, "bit_equal_to_first": equal,
                    "refused": refused, "empty_kernel_ms": empty,
                    "bound_ms": chip_smoke.imu_bound_ms(B, nv)[0]})
    print(json.dumps({"variants": variants, "runs": res, "card": chip_smoke.nvidia_smi_line()}))


if __name__ == "__main__":
    main()
