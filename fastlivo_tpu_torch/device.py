"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU
(`device="cpu"`, as the tests do). Without a GPU and without that
explicit request they raise: nothing carries on on the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.

    Also pins float32 matrix products to full precision. TF32 keeps ~10
    mantissa bits, which would drift the f32 point batches away from
    the reference's arithmetic."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
