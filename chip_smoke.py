#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (multimodal_rssm_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (Hopper, sm_90a) and the CUDA toolkit's nvcc.  Phases,
each printed as one JSON line:

1. build    -- compile every hand-written kernel from the checkout's sources;
2. kernel   -- hold each kernel against its plain PyTorch version on the card
               at the main path's shapes (the bit-depth normalise on
               [50, 50, 64, 64, 3] f32, bit depth 5: exact equality, the
               quantised part against normalize_image_deterministic, noise
               range and moments, seed determinism) and time both;
3. train    -- the port's train CLI, in process, on a synthetic COBOTTA-schema
               dataset at the default configuration's full width, batch 50 x
               chunk 50, with train.pallas_normalize=true: finite losses and
               every kernel of the path launched (counts reset just before);
4. parity   -- the same weights on the card and on the CPU, float32,
               deterministic (generator=None), batch 2 x chunk 4 at full
               width: loss, every metric and the gradient norms agree;
5. fused_codec -- the fused conv + InstanceNorm + GLU op (kernels K2, K3a,
               K3b, K3c) at its stage shapes, N = 2450, bf16: each kernel
               against its plain version (f32 arithmetic from the same
               inputs, rounded to the kernel's output dtype, max |diff| <=
               1e-2 of the plain version's max |value|), K3a's and K3c's
               sums bit-equal across two calls, K2, K3b and K3c shown to
               take their Hopper (wgmma) kernels at these shapes (by the
               variants' launch counts), each kernel, its plain version
               and its library yardstick timed (the bound counts only the
               products with in-range taps; K2 also beside F.conv2d alone
               and the unfused forward, reference_conv_in_glu); the
               WMMA K2, K3b and K3c, which f32 and other channel counts
               still take, once each against their plain versions at
               down4's shape in f32 and in bf16 with 248 / 504 channels;
               then the verify CLI (cli/verify_fused_codec.py, the op's
               main path) with the launch counts reset just before: forward
               and gradients against the unfused reference, fused and
               unfused grad-step times, and every one of the four kernels
               launched there, in the wgmma variants for K2, K3b and K3c
               and never the WMMA ones (and none of them in the train
               phase).  The kernels line gives each two-kernel step's
               launches by variant from that run.

Then the {"kernels": [...]} line, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Without a GPU it exits non-zero
and prints no result.  A failing phase raises.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SHAPE = (50, 50, 64, 64, 3)      # image_horizon batch at batch 50 x chunk 50
BIT_DEPTH = 5                    # env/SingleHoleDrilling.yaml
TRAIN_STEPS = 6
PARITY_RTOL = 1e-3
# Peak device-memory rates (bytes/s) and the f32 rate outside the tensor
# cores (NVIDIA data sheets; dense, full power).
HBM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H100": 3.35e12}
F32_RATE = 67e12
BF16_RATE = 989e12     # tensor cores, dense
FUSED_N = 2450         # T * B of the training step: the codec's batch
FUSED_TOL = 1e-2       # kernel vs plain version, relative to max |plain|
FUSED_KERNELS = {      # kernel on the op's main path -> the JAX package's
    "conv_in_glu_fwd_wgmma": "ops/fused_codec.py:142 (_fwd_kernel, JAX "
                             "package)",
    "in_glu_bwd_dz": "ops/fused_codec.py:166 (_bwd_dz_kernel_full, JAX "
                     "package)",
    "conv_dgrad_wgmma": "ops/fused_codec.py:200 (_dgrad_kernel, JAX package)",
    "conv_wgrad_wgmma": "ops/fused_codec.py:209 (_wgrad_kernel, JAX package)",
}                      # Pallas kernel it replaces
# K2's, K3b's and K3c's other kernels (f32 and other shapes): off the main
# path
OTHER_VARIANTS = {"conv_in_glu_fwd_wgmma": "conv_in_glu_fwd",
                  "conv_dgrad_wgmma": "conv_dgrad",
                  "conv_wgrad_wgmma": "conv_wgrad"}
WMMA_TOL = {"float32": 1e-4}   # the WMMA kernels in f32 (bf16: FUSED_TOL)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def hbm_rate(name: str) -> float:
    for key in ("H100 PCIe", "H100 NVL"):
        if key in name:
            return HBM_RATE[key]
    return HBM_RATE["H100"]


def phase_build():
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    libs, seconds, log = ck.build(force=True)
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build",
          "libraries": {k: os.path.relpath(v, REPO) for k, v in libs.items()},
          "seconds": seconds, "ptxas": ptxas})


def phase_kernel(device_name: str):
    import torch

    from multimodal_rssm_torch.core.device import cuda_time_ms
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.ops.image import normalize_image_deterministic

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    x8 = torch.randint(0, 256, SHAPE, generator=g, device=dev,
                       dtype=torch.uint8)
    x = x8.float()
    seed = torch.tensor(123456789, dtype=torch.int64, device=dev)

    out = ck.normalize_image(x, BIT_DEPTH, seed)
    plain = ck.normalize_image_plain(x, BIT_DEPTH, seed)
    torch.cuda.synchronize()
    max_abs_err = float((out - plain).abs().max())
    if not torch.equal(out, plain):
        raise AssertionError(f"kernel != plain version, max |diff| {max_abs_err}")
    det = normalize_image_deterministic(x, BIT_DEPTH)
    noise_bits = ck.normalize_noise_plain(x.numel(), BIT_DEPTH, seed)
    if not torch.equal(out, det + noise_bits.reshape(SHAPE)):
        raise AssertionError("quantised part != normalize_image_deterministic")
    # out - det can round up to exactly 1/32 in float32; the drawn noise
    # itself lies in [0, 1/32)
    noise = (out - det).double()
    step = 1.0 / 2 ** BIT_DEPTH
    stats = {"min": float(noise.min()), "max": float(noise.max()),
             "mean": float(noise.mean()), "std": float(noise.std()),
             "drawn_max": float(noise_bits.max())}
    if not (stats["min"] >= 0.0 and stats["max"] <= step
            and 0.0 <= float(noise_bits.min()) and stats["drawn_max"] < step
            and abs(stats["mean"] - step / 2) < 1e-4
            and abs(stats["std"] - step / math.sqrt(12)) < 1e-4):
        raise AssertionError(f"noise statistics off: {stats}")
    if not torch.equal(out, ck.normalize_image(x, BIT_DEPTH, seed)):
        raise AssertionError("same seed gave a different output")
    other = ck.normalize_image(x, BIT_DEPTH, seed + 1)
    changed = float((other != out).float().mean())
    if changed < 0.99:
        raise AssertionError(f"another seed changed only {changed:.4f}")
    if not torch.equal(out, ck.normalize_image(x8, BIT_DEPTH, seed)):
        raise AssertionError("uint8 input disagrees with f32 input")
    ragged = x.reshape(-1)[1:100_003]   # misaligned view: the scalar path
    if not torch.equal(ck.normalize_image(ragged, BIT_DEPTH, seed),
                       ck.normalize_image_plain(ragged, BIT_DEPTH, seed)):
        raise AssertionError("ragged / misaligned input disagrees")

    kernel_ms = cuda_time_ms(lambda: ck.normalize_image(x, BIT_DEPTH, seed),
                             20)
    plain_ms = cuda_time_ms(
        lambda: ck.normalize_image_plain(x, BIT_DEPTH, seed), 5, warmup=1)
    n = x.numel()
    bytes_ms = n * (4 + 4) / hbm_rate(device_name) * 1e3
    # float work per element: scale, floor, scale, shift, the mantissa's
    # "- 1", scale, add (the Philox rounds are integer work)
    ops_ms = n * 7 / F32_RATE * 1e3
    result = {"name": "normalize_image", "route": "cuda",
              "source": "multimodal_rssm_torch/kernels/normalize_image.cu",
              "replaces": "ops/pallas_kernels.py:44 (_normalize_kernel, "
                          "JAX package)",
              "launches": None, "max_abs_err": max_abs_err, "ms": kernel_ms,
              "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "library_ms": None}
    emit({"phase": "kernel", "name": "normalize_image", "shape": list(SHAPE),
          "exact": True, "noise": stats, "seed_changed_fraction": changed,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": result["bound_ms"],
          "achieved_GBps": n * 8 / (kernel_ms * 1e-3) / 1e9})
    return result


def phase_train():
    import torch

    from multimodal_rssm_torch.cli.train import main as train_main
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    batch = SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_dataset(os.path.join(tmp, "train"), 4, 120, shapes)
        write_synthetic_dataset(os.path.join(tmp, "validation"), 2, 80,
                                shapes, seed=100)
        while True:
            overrides = [
                f"train.train_data_path=[{tmp}/train]",
                f"train.validation_data_path=[{tmp}/validation]",
                "train.pallas_normalize=true",
                f"train.batch_size={batch}", f"train.chunk_size={SHAPE[0]}",
                f"train.train_iteration={TRAIN_STEPS}",
                f"train.validation_interval={TRAIN_STEPS}",
                "train.experience_size=1000",
                "main.experiment_name=chip_smoke",
                "--device", "cuda", "--cwd", tmp]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ck.reset_launch_counts()
            try:
                t0 = time.perf_counter()
                result = train_main(overrides)
                wall = time.perf_counter() - t0
                launches = ck.launch_counts()
                break
            except torch.cuda.OutOfMemoryError as e:
                if batch == 1:
                    raise
                emit({"phase": "train", "note": f"batch {batch} x chunk "
                      f"{SHAPE[0]} does not fit the card ({e}); halving the "
                      "batch"})
                batch //= 2
    values = {**{f"{k}/train": v for k, v in result["metrics"].items()},
              **{f"{k}/validation": v
                 for k, v in result["validation_metrics"].items()}}
    bad = {k: v for k, v in values.items() if not math.isfinite(v)}
    if bad or not result["validation_metrics"]:
        raise AssertionError(f"non-finite or missing metrics: {bad}")
    steps = TRAIN_STEPS + 1  # train steps plus the validation step
    if launches["normalize_image"] < steps:
        raise AssertionError(f"normalize_image launched {launches} times in "
                             f"{steps} steps")
    steady = result["step_seconds"][2:]
    emit({"phase": "train", "batch": batch, "chunk": SHAPE[0],
          "steps": TRAIN_STEPS, "launches": launches,
          "step_seconds": result["step_seconds"],
          "median_steps_per_s_after_warmup": 1.0 / statistics.median(steady),
          "max_memory_allocated_GiB": torch.cuda.max_memory_allocated() / 2 ** 30,
          "wall_seconds": wall, "loss": result["metrics"]["loss"],
          "validation_loss": result["validation_metrics"]["loss"]})
    return launches


def phase_parity():
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops.image import normalize_image_deterministic
    from multimodal_rssm_torch.train import trainer as tr

    cfg = compose(overrides=["train.use_amp=False"])
    L, B = 4, 2
    rng = np.random.default_rng(0)
    raw = ({"image_horizon": rng.integers(0, 256, (L, B, 64, 64, 3), np.uint8),
            "sound": rng.normal(size=(L, B, 128, 20)).astype(np.float32)},
           rng.normal(size=(L, B, 3)).astype(np.float32),
           rng.normal(size=(L, B)).astype(np.float32),
           np.ones((L, B, 1), np.float32))
    cpu_model = WorldModel.from_config(cfg)
    init_parameters(cpu_model, torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")

    def run(model, dev):
        obs, act, rew, nt = raw
        obs = {"image_horizon": normalize_image_deterministic(
                   torch.from_numpy(obs["image_horizon"]).to(dev), BIT_DEPTH),
               "sound": torch.from_numpy(obs["sound"]).to(dev)}
        batch = (obs, torch.from_numpy(act).to(dev),
                 torch.from_numpy(rew).to(dev), torch.from_numpy(nt).to(dev))
        loss, metrics = tr.make_loss_fn(model, cfg)(batch, None, True)
        loss.backward()
        metrics.update(tr.grad_norms(model))
        return {k: float(v) for k, v in metrics.items()}

    cpu = run(cpu_model, torch.device("cpu"))
    gpu = run(gpu_model, torch.device("cuda"))
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    bad = {k: (cpu[k], gpu[k]) for k, r in rel.items()
           if r > PARITY_RTOL and abs(gpu[k] - cpu[k]) > 1e-6}
    emit({"phase": "parity", "batch": B, "chunk": L, "rtol": PARITY_RTOL,
          "max_rel_err": max(rel.values()), "cpu": cpu, "cuda": gpu})
    if bad:
        raise AssertionError(f"card and CPU disagree: {bad}")


def conv_flops(n, h, wd, cin, kh, kw, cout, ph, pw) -> int:
    """2 x the multiply-adds a stride-1 conv needs: for each tap, only the
    output positions whose input lies inside the unpadded input (the other
    products multiply the zero padding).  K2's z, K3b's dx and K3c's dw
    each need exactly these."""
    def in_range(size, k, p):
        out = size + 2 * p - k + 1
        return sum(max(0, min(out, size + p - d) - max(0, p - d))
                   for d in range(k))

    return 2 * n * cin * cout * in_range(h, kh, ph) * in_range(wd, kw, pw)


def _err(got, want):
    """(max |diff|, that over max |want|)."""
    d = float((got.float() - want.float()).abs().max())
    return d, d / (float(want.float().abs().max()) + 1e-6)


def _fused_stage(stage: str, device_name: str):
    """Each of K2-K3c against its plain version at one stage's shapes, its
    bit-equality across calls (K3a, K3c) and its times.  Returns
    {kernel: record}."""
    import torch
    import torch.nn.functional as F

    from multimodal_rssm_torch.cli import verify_fused_codec as vf
    from multimodal_rssm_torch.core.device import cuda_time_ms
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.ops import fused_codec as fc

    dev = torch.device("cuda")
    n = FUSED_N
    x, w, scale, bias, dy = vf.make_inputs(n, stage, torch.bfloat16, dev)
    h, wd, cin, kh, kw, cout, ph, pw = vf.STAGES[stage]
    pad = (ph, pw)
    ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
    flops = conv_flops(n, h, wd, cin, kh, kw, cout, ph, pw)
    b2, b4 = 2, 4                      # bytes of bf16, f32
    x_b, w_b = x.numel() * b2, w.numel() * b2
    z_b, y_b = n * ho * wo * cout * b2, n * ho * wo * cout // 2 * b2
    stats_b, sb_b = 2 * n * cout * b4, 2 * cout * b4
    hbm = hbm_rate(device_name)
    rec = {}

    def record(name, errors, kernel, plain, library, nbytes, ops, rate,
               **extra):
        torch.cuda.synchronize()
        bytes_ms = nbytes / hbm * 1e3
        ops_ms = ops / rate * 1e3
        rec[name] = {
            "errors": {k: {"max_abs": a, "rel": r} for k, (a, r) in errors.items()},
            "max_abs_err": max(a for a, _ in errors.values()),
            "max_rel_err": max(r for _, r in errors.values()),
            "ms": cuda_time_ms(kernel, 5),
            "plain_ms": cuda_time_ms(plain, 3, warmup=1),
            "library_ms": (None if library is None
                           else cuda_time_ms(library, 5)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            **extra}
        torch.cuda.empty_cache()

    def check_variant(name, calls):
        """Raise unless each of the last ``calls`` calls of a two-kernel
        step (counts reset just before them) took the wgmma kernel."""
        counts = ck.launch_counts()
        got = {"wgmma": counts[name], "wmma": counts[OTHER_VARIANTS[name]]}
        if got != {"wgmma": calls, "wmma": 0}:
            raise AssertionError(f"{stage}: {calls} calls of {name}'s "
                                 f"wrapper launched {got}")

    # K2
    ck.reset_launch_counts()
    out = fc.conv_in_glu_fwd(x, w, scale, bias, pad)
    check_variant("conv_in_glu_fwd_wgmma", 1)
    plain = fc.conv_in_glu_fwd_plain(x, w, scale, bias, pad)
    errors = {k: _err(a, b) for k, a, b in zip(("y", "z", "mean", "var"),
                                               out, plain)}
    del plain
    _, z, mean, var = out
    x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    record("conv_in_glu_fwd_wgmma", errors,
           lambda: fc.conv_in_glu_fwd(x, w, scale, bias, pad),
           lambda: fc.conv_in_glu_fwd_plain(x, w, scale, bias, pad), None,
           x_b + w_b + sb_b + y_b + z_b + stats_b, flops, BF16_RATE,
           conv2d_ms=cuda_time_ms(
               lambda: F.conv2d(x_nchw, w_oihw, padding=pad), 5),
           unfused_ms=cuda_time_ms(
               lambda: fc.reference_conv_in_glu(x, w, scale, bias, pad), 5))

    # K3a (dy: the verify CLI's cotangent r)
    dz, dscale, dbias = fc.in_glu_bwd_dz(dy, z, mean, var, scale, bias)
    plain = fc.in_glu_bwd_dz_plain(dy, z, mean, var, scale, bias)
    errors = {k: _err(a, b) for k, a, b in zip(("dz", "dscale", "dbias"),
                                               (dz, dscale, dbias), plain)}
    del plain
    again = fc.in_glu_bwd_dz(dy, z, mean, var, scale, bias)
    if not all(torch.equal(a, b) for a, b in zip((dz, dscale, dbias), again)):
        raise AssertionError(f"{stage}: in_glu_bwd_dz differs between calls")
    del again
    # about 20 float operations per element of z in the kernel's two passes
    record("in_glu_bwd_dz", errors,
           lambda: fc.in_glu_bwd_dz(dy, z, mean, var, scale, bias),
           lambda: fc.in_glu_bwd_dz_plain(dy, z, mean, var, scale, bias),
           None, y_b + z_b + stats_b + sb_b + z_b + sb_b, 20 * z.numel(),
           F32_RATE)

    # K3b
    dz_nchw = dz.permute(0, 3, 1, 2)
    ck.reset_launch_counts()
    errors = {"dx": _err(fc.conv_dgrad(dz, w, pad),
                         fc.conv_dgrad_plain(dz, w, pad))}
    check_variant("conv_dgrad_wgmma", 1)
    record("conv_dgrad_wgmma", errors, lambda: fc.conv_dgrad(dz, w, pad),
           lambda: fc.conv_dgrad_plain(dz, w, pad),
           lambda: torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, dz_nchw,
                                              padding=pad),
           z_b + w_b + x_b, flops, BF16_RATE)

    # K3c
    ck.reset_launch_counts()
    dw = fc.conv_wgrad(x, dz, (kh, kw), pad)
    errors = {"dw": _err(dw, fc.conv_wgrad_plain(x, dz, (kh, kw), pad))}
    if not torch.equal(dw, fc.conv_wgrad(x, dz, (kh, kw), pad)):
        raise AssertionError(f"{stage}: conv_wgrad differs between calls")
    check_variant("conv_wgrad_wgmma", 2)
    record("conv_wgrad_wgmma", errors,
           lambda: fc.conv_wgrad(x, dz, (kh, kw), pad),
           lambda: fc.conv_wgrad_plain(x, dz, (kh, kw), pad),
           lambda: torch.nn.grad.conv2d_weight(x_nchw, w_oihw.shape,
                                               dz_nchw, padding=pad),
           x_b + z_b + w.numel() * b4, flops, BF16_RATE)
    bad = {k: r["max_rel_err"] for k, r in rec.items()
           if r["max_rel_err"] > FUSED_TOL}
    if bad:
        raise AssertionError(f"{stage}: kernel != plain version: {bad}")
    return rec


def _wmma_check():
    """The WMMA K2, K3b and K3c, which the wrappers still take for f32
    and for bf16 with channel counts that are not multiples of 64: one
    call each against its plain version at down4's shape, N = FUSED_N, in
    f32 and in bf16 with 248 / 504 channels.  Off the main path; returns
    the errors by case."""
    import torch

    from multimodal_rssm_torch.cli import verify_fused_codec as vf
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.ops import fused_codec as fc

    dev = torch.device("cuda")
    h, wd, cin, kh, kw, cout, ph, pw = vf.STAGES["down4"]
    pad = (ph, pw)
    ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
    g = torch.Generator(dev).manual_seed(2)
    out = {}
    for dtype, ci, co in ((torch.float32, cin, cout),
                          (torch.bfloat16, cin - 8, cout - 8)):
        case = f"{str(dtype)[6:]} Cin {ci} Cout {co}"
        if fc.uses_wgmma(dtype, ci, co, kh) or fc.fwd_uses_wgmma(dtype, ci,
                                                                  co):
            raise AssertionError(f"{case} would take the wgmma kernels")
        x = (0.3 * torch.randn(FUSED_N, h, wd, ci, generator=g,
                               device=dev)).to(dtype)
        w = (0.05 * torch.randn(kh, kw, ci, co, generator=g,
                                device=dev)).to(dtype)
        dz = torch.randn(FUSED_N, ho, wo, co, generator=g, device=dev
                         ).to(dtype)
        scale = torch.rand(co, generator=g, device=dev) + 0.5
        bias = 0.1 * torch.randn(co, generator=g, device=dev)
        ck.reset_launch_counts()
        errors = {k: _err(a, b) for k, a, b in zip(
            ("y", "z", "mean", "var"),
            fc.conv_in_glu_fwd(x, w, scale, bias, pad),
            fc.conv_in_glu_fwd_plain(x, w, scale, bias, pad))}
        errors.update(dx=_err(fc.conv_dgrad(dz, w, pad),
                              fc.conv_dgrad_plain(dz, w, pad)),
                      dw=_err(fc.conv_wgrad(x, dz, (kh, kw), pad),
                              fc.conv_wgrad_plain(x, dz, (kh, kw), pad)))
        launched = {k: v for k, v in ck.launch_counts().items() if v}
        del x, w, dz
        torch.cuda.empty_cache()
        if launched != {"conv_in_glu_fwd": 1, "conv_dgrad": 1,
                        "conv_wgrad": 1}:
            raise AssertionError(f"{case}: the WMMA check launched {launched}")
        tol = WMMA_TOL.get(str(dtype)[6:], FUSED_TOL)
        bad = {k: r for k, (_, r) in errors.items() if r > tol}
        if bad:
            raise AssertionError(f"{case}: WMMA kernel != plain version: {bad}")
        out[case] = {"tolerance": tol, **{k: {"max_abs": a, "rel": r}
                                          for k, (a, r) in errors.items()}}
    return out


def phase_fused_codec(device_name: str, train_launches):
    """K2-K3c against their plain versions at both stages, then the verify
    CLI as the op's main path.  Returns the four kernels' lines."""
    from multimodal_rssm_torch.cli import verify_fused_codec as vf
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    in_train = {k: train_launches[k]
                for k in [*FUSED_KERNELS, *OTHER_VARIANTS.values()]
                if train_launches[k]}
    if in_train:
        raise AssertionError(f"the train phase launched {in_train}")
    stages = {stage: _fused_stage(stage, device_name) for stage in vf.STAGES}
    wmma = _wmma_check()

    ck.reset_launch_counts()
    verify = vf.main(["--n", str(FUSED_N), "--dtype", "bfloat16",
                      "--reps", "5"])
    launches = ck.launch_counts()
    missing = [k for k in FUSED_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the verify CLI launched none of {missing}")
    off_path = {k: launches[k] for k in OTHER_VARIANTS.values()
                if launches[k]}
    if off_path:
        raise AssertionError(f"the verify CLI launched the WMMA kernels "
                             f"{off_path} instead of the wgmma ones")

    lines = []
    for name, replaces in FUSED_KERNELS.items():
        per = {stage: rec[name] for stage, rec in stages.items()}

        def total(key):
            vals = [r[key] for r in per.values()]
            return None if None in vals else sum(vals)

        bound_by = {r["bound_by"] for r in per.values()}
        lines.append({
            "name": name, "route": "cuda",
            "source": "multimodal_rssm_torch/kernels/fused_codec.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per.values()),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"), "bound_by": bound_by.pop(),
            "library_ms": total("library_ms"),
            **({"conv2d_ms": total("conv2d_ms"),
                "unfused_ms": total("unfused_ms")}
               if name == "conv_in_glu_fwd_wgmma" else {}),
            **({"variants": {"wgmma": launches[name],
                             "wmma": launches[OTHER_VARIANTS[name]]}}
               if name in OTHER_VARIANTS else {}),
            "stages": {s: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms", "max_rel_err",
                                             "conv2d_ms", "unfused_ms")
                           if k in r}
                       for s, r in per.items()}})
    emit({"phase": "fused_codec", "n": FUSED_N, "dtype": "bfloat16",
          "tolerance": FUSED_TOL, "bit_equal_across_calls":
          ["in_glu_bwd_dz", "conv_wgrad_wgmma"], "kernels": stages,
          "wmma_check": wmma,
          "verify": {s: {k: r[k] for k in ("errors", "passed",
                                           "fused_grad_step_ms",
                                           "unfused_grad_step_ms")}
                     for s, r in verify.items()},
          "launches": launches, "wall_seconds": time.perf_counter() - t0})
    return lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from multimodal_rssm_torch.core.device import configure_float32

    configure_float32()  # TF32 off in matmuls and cuDNN convolutions
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32}})
    phase_build()
    kernel = phase_kernel(name)
    launches = phase_train()
    phase_parity()
    fused = phase_fused_codec(name, launches)
    kernel["launches"] = launches["normalize_image"]
    emit({"kernels": [kernel, *fused]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
