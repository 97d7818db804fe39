"""Verify the fused conv + InstanceNorm + GLU op at the sound codec's stage
shapes, and time one gradient step of it against the unfused PyTorch one.

    python -m multimodal_rssm_torch.cli.verify_fused_codec [--n 2450] \\
        [--dtype bfloat16|float32] [--device cuda|cpu] [--reps 20]

For ``down4`` (x [N, 32, 5, 256], k (3, 4), 512 channels, pad (1, 1)) and
``up0`` in its conv form (x [N, 32, 4, 256], pad (1, 2)), with inputs drawn
from ``np.random.default_rng(0)``, it holds the op's y, mean and var, and
dx, dw, dscale and dbias of sum(y * r), against ``reference_conv_in_glu``
in f32 and its autograd: max |diff| over the reference's max |value| must
stay under 3e-2 (bf16) or 2e-4 (f32).  On the card it then times the fused
grad step and the unfused one (cuDNN conv + InstanceNorm + GLU, in the
same dtype) with CUDA events: 3 warm-up calls, then the median of ``--reps``.

Prints one JSON line per stage and returns {stage: result}; raises if a
check fails.  Runs on the GPU unless given ``--device cpu`` (no timing
there).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multimodal_rssm_torch.core.device import (
    configure_float32, cuda_time_ms, resolve_device)
from multimodal_rssm_torch.ops.fused_codec import (
    conv_in_glu, reference_conv_in_glu)

# (H, W, Cin, kh, kw, Cout, ph, pw) of the two stride-1 codec stages
STAGES = {"down4": (32, 5, 256, 3, 4, 512, 1, 1),
          "up0": (32, 4, 256, 3, 4, 512, 1, 2)}
TOLERANCE = {torch.bfloat16: 3e-2, torch.float32: 2e-4}


def make_inputs(n: int, stage: str, dtype: torch.dtype,
                device: torch.device):
    """(x, w, scale, bias, r) as the JAX package's verify script draws
    them: x ~ 0.3 N(0, 1), w ~ 0.05 N(0, 1), scale ~ U(0.5, 1.5),
    bias ~ 0.1 N(0, 1), the cotangent r ~ N(0, 1)."""
    h, wd, cin, kh, kw, cout, ph, pw = STAGES[stage]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, h, wd, cin)).astype(np.float32) * 0.3
    w = rng.normal(size=(kh, kw, cin, cout)).astype(np.float32) * 0.05
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32) * 0.1
    ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
    r = rng.normal(size=(n, ho, wo, cout // 2)).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(w).to(device, dtype),
            torch.from_numpy(scale).to(device),
            torch.from_numpy(bias).to(device),
            torch.from_numpy(r).to(device, dtype))


def _grad_step(fn, x, w, scale, bias, r, padding):
    """Gradients of sum(y * r) with respect to (x, w, scale, bias)."""
    leaves = [t.detach().requires_grad_() for t in (x, w, scale, bias)]
    y, _, _ = fn(*leaves, padding)
    loss = (y.float() * r.float()).sum()
    return torch.autograd.grad(loss, leaves)


def _error(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    d = (got.float() - want.float()).abs().max().item()
    return {"max_abs": d, "rel": d / (want.float().abs().max().item() + 1e-6)}


def check_stage(stage: str, n: int, dtype: torch.dtype,
                device: torch.device, reps: int) -> Dict:
    x, w, scale, bias, r = make_inputs(n, stage, dtype, device)
    padding = STAGES[stage][6:]
    tol = TOLERANCE[dtype]
    errors = {}
    with torch.no_grad():
        got = conv_in_glu(x, w, scale, bias, padding)
        want = reference_conv_in_glu(x.float(), w.float(), scale, bias,
                                     padding)
    for name, a, b in zip(("y", "mean", "var"), got, want):
        errors[name] = _error(a, b)
    del got, want
    fused = _grad_step(conv_in_glu, x, w, scale, bias, r, padding)
    ref = _grad_step(reference_conv_in_glu, x.float(), w.float(), scale,
                     bias, r, padding)
    for name, a, b in zip(("dx", "dw", "dscale", "dbias"), fused, ref):
        errors[name] = _error(a, b)
    del fused, ref
    result = {"stage": stage, "n": n, "dtype": str(dtype).split(".")[-1],
              "device": str(device), "tolerance": tol, "errors": errors,
              "passed": all(e["rel"] < tol for e in errors.values()),
              "fused_grad_step_ms": None, "unfused_grad_step_ms": None}
    if device.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(device)
        result["fused_grad_step_ms"] = cuda_time_ms(
            lambda: _grad_step(conv_in_glu, x, w, scale, bias, r, padding),
            reps)
        result["unfused_grad_step_ms"] = cuda_time_ms(
            lambda: _grad_step(reference_conv_in_glu, x, w, scale, bias, r,
                               padding), reps)
    return result


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n", type=int, default=2450,
                        help="samples (T * B of the training step)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--reps", type=int, default=20,
                        help="timed grad steps per stage (on the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    configure_float32()     # the f32 reference without TF32
    dtype = getattr(torch, args.dtype)
    results = {}
    for stage in STAGES:
        results[stage] = check_stage(stage, args.n, dtype, device, args.reps)
        print(json.dumps(results[stage]), flush=True)
    failed = [s for s, res in results.items() if not res["passed"]]
    if failed:
        raise AssertionError(f"fused op disagrees with the reference at "
                             f"{failed}")
    return results


if __name__ == "__main__":
    main()
