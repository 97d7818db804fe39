"""Kernel-level attribution of the training step: a ``torch.profiler`` trace
of ``--steps`` train steps, the kernels' self time by category and the top
kernels.

    python -m multimodal_rssm_torch.cli.op_profile [--batch-size 50 --chunk-size 50]
        [--override rssm.remat=false] [--top 30] [--steps 5] [--trace-dir DIR]
        [--device cuda|cpu]

The port's counterpart of the JAX package's ``scripts/op_profile.py`` (same
flags and defaults): the step of ``cli/_profiling_common.build_step_setup``
(the normalise through K1 on the card), 3 warm-up steps and one the profiler
drops, then ``--steps`` steps traced (the card's kernels; on the CPU, the
operators) in a ``core/profiling.ProfilerWindow`` (quiet at both edges).
In place of the TPU trace's ``hlo_category`` it sums the device kernels'
self time by ``op_category``: ``gemm`` (cuBLAS / CUTLASS /
``sm90_xmma`` GEMMs), ``conv`` (cuDNN forward, dgrad and wgrad), ``layout``
(cuDNN's NCHW <-> NHWC transposes), ``elementwise``, ``reduction``,
``memcpy/memset``, ``collective``, ``hand-written`` (the kernels named in
``ops/cuda_kernels.KERNELS``) and ``other``.  It also prints the device's idle
share of the traced window (kernel time over wall time, the window's own
reading, as ``cli/profile_step``'s).  With ``--device cpu`` the same tables
hold the operators' self CPU time: they check the harness, not the card.

The Chrome trace goes to ``--trace-dir``/op_profile.json.
"""

from __future__ import annotations

import argparse
import collections
import os
import tempfile
from typing import Dict, Iterable, Optional, Sequence

from multimodal_rssm_torch.cli._profiling_common import (
    add_device_argument, build_step_setup, synchronize)
from multimodal_rssm_torch.core.profiling import (
    ProfilerWindow, hand_written_names)

CATEGORIES = ("gemm", "conv", "layout", "elementwise", "reduction",
              "memcpy/memset", "collective", "hand-written", "other")
_RULES = (   # (category, substrings of the lower-cased name), in order
    ("memcpy/memset", ("memcpy", "memset")),
    ("collective", ("nccl", "all_reduce", "allreduce", "all_gather",
                    "allgather", "reduce_scatter", "broadcast", "gloo")),
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "cudnn")),
    # cuBLAS on Hopper names its GEMMs nvjet_*; splitKreduce finishes one
    ("gemm", ("gemm", "gemv", "nvjet", "splitkreduce", "cublas", "cutlass",
              "xmma", "aten::mm", "aten::bmm", "aten::addmm", "matmul")),
    ("reduction", ("reduce", "collect_statistics", "welford", "softmax",
                   "aten::sum", "aten::mean", "aten::max", "aten::norm")),
    ("elementwise", ("elementwise", "multi_tensor_apply", "aten::add",
                     "aten::mul", "aten::sub", "aten::div", "aten::where",
                     "aten::copy_")),
)


def op_category(name: str, hand_written: Iterable[str] = ()) -> str:
    """The category of a device kernel (or, on the CPU, an operator) by its
    name; a name holding one of ``hand_written`` is ``hand-written``."""
    low = name.lower()
    if any(h.lower() in low for h in hand_written):
        return "hand-written"
    for category, keys in _RULES:
        if any(k in low for k in keys):
            return category
    return "other"


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv``, trace, print the tables; returns them as a dict."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch-size", type=int, default=50)
    parser.add_argument("--chunk-size", type=int, default=50)
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--override", action="append", default=[])
    parser.add_argument("--trace-dir",
                        default=os.path.join(tempfile.gettempdir(),
                                             "rssm_trace"))
    add_device_argument(parser)
    args = parser.parse_args(argv)

    s = build_step_setup(args.batch_size, args.chunk_size, args.override,
                         args.device)
    for _ in range(3):
        metrics = s.train_step(s.raw, s.draws, s.generator)
    float(metrics["loss"])
    synchronize(s.device)

    # the card's kernels (on the CPU: the operators), after one step the
    # profiler traces and drops: the first kernels after a trace starts can
    # be missed
    window = ProfilerWindow(s.device, cpu=False).open(
        warmup=lambda: s.train_step(s.raw, s.draws, s.generator))
    for _ in range(args.steps):
        metrics = s.train_step(s.raw, s.draws, s.generator)
    float(metrics["loss"])
    window.close()
    os.makedirs(args.trace_dir, exist_ok=True)
    path = window.export(os.path.join(args.trace_dir, "op_profile.json"))

    hand = hand_written_names()
    n = args.steps
    summary = window.summary()
    total = summary["kernel_ms"] * 1e3   # us over the n steps
    per_step = total / 1e3 / n
    kernels = [{"name": name, "ms_per_step": us / 1e3 / n,
                "share": us / total, "count": count,
                "category": op_category(name, hand)}
               for name, us, count in sorted(window.kernels(),
                                             key=lambda k: -k[1])]
    cat = collections.Counter()
    for k in kernels:
        cat[k["category"]] += k["ms_per_step"]
    wall_us = window.wall_ms * 1e3
    idle = summary["device_idle_share"]
    what = "kernel" if s.device.type == "cuda" else "operator (CPU)"
    print(f"trace: {path}")
    print(f"total {what} self time: {total / 1e3:.1f} ms over {n} steps "
          f"-> {per_step:.1f} ms/step")
    print(f"device idle: {100 * idle:.1f} % of the {wall_us / 1e3:.1f} ms "
          "window")
    print("\ncategory attribution:")
    print(f"{'ms/step':>10s} {'%':>6s}  category")
    for name, ms in cat.most_common():
        print(f"{ms:10.3f} {100 * ms / per_step:6.2f}  {name}")
    print(f"\n{'self_ms/step':>12s} {'%':>6s} {'count':>6s}  {what}")
    for k in kernels[:args.top]:
        print(f"{k['ms_per_step']:12.3f} {100 * k['share']:6.2f} "
              f"{k['count']:6d}  {k['name'][:160]}")
    return {"trace": path, "steps": n, "device": str(s.device),
            "total_ms_per_step": per_step,
            "window_ms": wall_us / 1e3, "device_idle_share": idle,
            "launches": summary["launches"],
            "categories_ms_per_step": {k: cat[k] for k in CATEGORIES
                                       if k in cat},
            "hand_written": {k["name"]: {"ms_per_step": k["ms_per_step"],
                                         "count": k["count"]}
                             for k in kernels
                             if k["category"] == "hand-written"},
            "top": kernels[:args.top], "kernels": kernels}

if __name__ == "__main__":
    main()
