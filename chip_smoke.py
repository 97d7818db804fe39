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
               width: loss, every metric and the gradient norms agree.

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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def hbm_rate(name: str) -> float:
    for key in ("H100 PCIe", "H100 NVL"):
        if key in name:
            return HBM_RATE[key]
    return HBM_RATE["H100"]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, each timed
    with CUDA events after ``warmup`` untimed calls."""
    import torch

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


def phase_build():
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    path, seconds, log = ck.build(force=True)
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "library": os.path.relpath(path, REPO),
          "seconds": seconds, "ptxas": ptxas})


def phase_kernel(device_name: str):
    import torch

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

    kernel_ms = time_ms(lambda: ck.normalize_image(x, BIT_DEPTH, seed), 20)
    plain_ms = time_ms(lambda: ck.normalize_image_plain(x, BIT_DEPTH, seed), 5,
                       warmup=1)
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
    kernel["launches"] = launches["normalize_image"]
    emit({"kernels": [kernel]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
