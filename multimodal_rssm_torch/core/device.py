"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A CUDA
request without a visible GPU raises: a run never carries on on the CPU
behind the caller's back.
"""

from __future__ import annotations

import os
import statistics
from typing import Callable, Optional

import torch


def resolve_device(name: Optional[str] = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, or for a rank of
    a world (``LOCAL_RANK`` set) ``cuda:LOCAL_RANK`` (``cuda:0`` where the
    launcher leaves each rank one visible card); ``"cuda:k"`` -> that
    card; ``"cpu"`` -> the CPU.  A CUDA request raises without a GPU, or
    where the card it names is missing."""
    device = torch.device(name or "cuda")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass --device cpu (or device='cpu') "
            "to run on the CPU")
    if device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                              if torch.cuda.device_count() > 1 else 0)
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"{device} is missing: {torch.cuda.device_count()} GPU(s) "
            "visible (a rank needs a card of its own under NCCL)")
    return device


def configure_float32(allow_tf32: bool = False) -> None:
    """Pin float32 matmul and convolution precision.

    PyTorch defaults to full float32 matmuls but TF32 cuDNN convolutions;
    the port states both.  With TF32 off, a float32 run on the card is held
    to the CPU and to the JAX reference at float32 tolerances.  The mixed
    precision path (``train.use_amp``) computes in bf16 and is unaffected.
    """
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32


def cuda_time_ms(fn: Callable[[], object], reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream: ``warmup``
    untimed calls, then ``reps`` calls each between two CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
