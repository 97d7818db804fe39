"""Per-codec forward and forward + backward times at the training step's
scale (T x B = 2450 frames), in bf16 (the codecs' compute dtype).

    python -m multimodal_rssm_torch.cli.micro_bench [--modules sound_enc_v2,...]
        [--frames 2450] [--device cuda|cpu]

The port's counterpart of the JAX package's ``scripts/micro_bench.py``: the
same six cases (``CASES``: the v2 and v1 sound codecs, the 64 px image
encoder and decoder with BatchNorm and relu, embeddings 256 / 1024) on the
same inputs (sound [N, 128, 20], images [N, 64, 64, 3], beliefs
[49, N / 49, 1024], states [49, N / 49, 128]), each module in train mode on
the torch initialisation (seed 1).  The forward sums every output in
float32; the backward takes the gradient of that sum.  Each is called twice
to warm up, then 10 times between two CUDA events (on the CPU: the host
clock), and the mean is printed in the JAX script's line format.  The
fused conv + InstanceNorm + GLU op is not in any case, as in the JAX
script.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from multimodal_rssm_torch.cli._profiling_common import (
    add_device_argument, setup_device, synchronize)
from multimodal_rssm_torch.models import decoders as dec
from multimodal_rssm_torch.models import encoders as enc

# case -> (the module, the inputs it takes: "sound", "image" or "hs")
CASES = {
    "sound_enc_v2": (lambda: enc.SoundEncoderV2(embedding_size=256), "sound"),
    "sound_dec_v2": (lambda: dec.SoundDecoderV2(1024, 128), "hs"),
    "sound_enc_v1": (lambda: enc.SoundEncoder(embedding_size=256), "sound"),
    "sound_dec_v1": (lambda: dec.SoundDecoder(1024, 128), "hs"),
    "image_enc_64": (lambda: enc.ImageEncoder64(
        embedding_size=1024, activation_function="relu",
        normalization="BatchNorm"), "image"),
    "image_dec_64": (lambda: dec.ImageDecoder64(
        1024, 128, embedding_size=1024, normalization="BatchNorm"), "hs"),
}


def mean_ms(fn: Callable[[], object], device: torch.device, n: int = 10,
            warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e3


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Parse ``argv``, time the cases, print a line each; returns
    ``{case: {"fwd_ms", "fwd_bwd_ms"}}``."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=2450)
    parser.add_argument("--modules", type=str, default="")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.models.layers import set_compute_dtype

    device = setup_device(args.device)
    N = args.frames
    T, B = 49, N // 49
    g = torch.Generator().manual_seed(0)
    inputs = {"sound": (torch.randn(N, 128, 20, generator=g),),
              "image": (torch.randn(N, 64, 64, 3, generator=g),),
              "hs": (torch.randn(T, B, 1024, generator=g),
                     torch.randn(T, B, 128, generator=g))}
    inputs = {k: tuple(x.to(device) for x in v) for k, v in inputs.items()}

    only = [m for m in args.modules.split(",") if m]
    unknown = sorted(set(only) - set(CASES))
    if unknown:
        parser.error(f"unknown --modules {unknown}; cases: {list(CASES)}")
    out = {}
    for name, (make, kind) in CASES.items():
        if only and name not in only:
            continue
        torch.manual_seed(1)
        module = set_compute_dtype(make().to(device).train(), torch.bfloat16)
        xs = inputs[kind]
        params = [p for p in module.parameters() if p.requires_grad]

        def fwd():
            y = module(*xs)
            y = y["loc"] if isinstance(y, dict) else y
            return y.float().sum()

        def fwdbwd():
            return torch.autograd.grad(fwd(), params)

        with torch.no_grad():
            t_f = mean_ms(fwd, device)
        t_fb = mean_ms(fwdbwd, device)
        out[name] = {"fwd_ms": t_f, "fwd_bwd_ms": t_fb}
        print(f"{name:16s} fwd {t_f:7.2f} ms   fwd+bwd {t_fb:7.2f} ms   "
              f"(bwd ~ {t_fb - t_f:7.2f})", flush=True)
        del module, params
    return out


if __name__ == "__main__":
    main()
