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
               range and moments, seed determinism) and time both
               (device time: calls captured in a CUDA graph, replayed);
3. train    -- the port's train CLI, in process, on a synthetic COBOTTA-schema
               dataset at the default configuration's full width, batch 50 x
               chunk 50, with train.pallas_normalize=true, fed from the
               device-resident replay (train.device_replay=auto): finite
               losses and every kernel of the path launched (counts reset
               just before);
3b. feed    -- the same CLI on a dataset of a real set's size (360 x 120
               episodes, 43,200 rows, 0.97 GB; experience_size to match),
               24 steps a run, with train.device_replay=true (the whole
               replay on the card), =stream (train.replay_budget_gb=0.5: a
               working set of 119 of 216 segments, one replaced a step) and
               =false (host batches behind the prefetch thread), run in the
               order true, stream, false, false, stream, true; then at that
               size the load (serial against 4 threads), one batch's host
               gather (native into the host feed's pinned batch at 1-8
               threads and into fresh memory, NumPy), NumPy + pin + copy
               against the host feed's producer, and the device gather,
               each on fresh indices;
3c. checkpoint -- 4 steps with a checkpoint every 2, then --resume to 6; the
               restored model bit-equal on the card to the one saved; an
               async save's time on the loop's thread against a synchronous
               save's, and the file's size.
3e. eval    -- on 3c's run (models_6.pt) at full width, float32, episodes
               of 120 steps at batch 1, and on a twin of it whose config
               says train.pallas_normalize=false (the shipped default):
               the estimate_state CLI in process over both (one states
               entry per episode file, beliefs [119, 1, 1024], posterior
               means [119, 1, 128], the three experts, all finite, the
               two runs' states alike; K1 launched once per episode of
               each, counts reset just before; ms per episode), the
               check_model CLI on the twin (every artifact, finite MSE /
               PSNR / SSIM; K1 once per episode),
               the card's det estimate, reconstruction and 20-step
               imagination against the CPU's on the same weights and
               prepared episode, the streaming filter frame by frame
               against the card's own sequence estimate (both within
               PARITY_RTOL |want| + EVAL_ATOL; median ms per frame over
               the frames after 5), and K1's device time at an episode's
               shape (20 launches in a CUDA graph: the wrapper's host
               enqueue is longer than the kernel there).
               Every train run checks finite losses, K1 launched at least
               once per step, and prints its median steps/s over the steps
               after the first two, without the last (which also
               validates), and its peak memory;
3f. control -- on 3c's run (models_6.pt) at full width, bf16 autocast for
               the world model, the heads in f32: the train_behavior CLI
               (4 iterations, H 15, all 2,450 posterior states of a batch
               50 x chunk 50 as starts; finite losses, both heads moved,
               the world model bit-equal to its file, K1 once per
               iteration under the shipped train.pallas_normalize=false,
               steps/s after the first two, each step timed between
               events on the device's stream, peak memory); one
               behavior step on the card against the CPU (float32, batch
               2 x chunk 6, the same weights and noise: the losses, the
               mean return and both heads' gradient norms within
               PARITY_RTOL); the eval_policy CLI with the actor (2 episodes
               of 100 steps of the synthetic env, K1 once per frame, median
               ms per action: filter + actor + the copy to the host) and
               with CEM at the planner's defaults (1000 candidates, 100
               elites, H 12, 10 iterations; refused without
               rssm.predict_reward=true, then 1 episode of 50 steps, ms per
               planned action); the train_online CLI in both collection
               modes (2 seed episodes, 2 episodes of 2 updates, env length
               60, train.experience_size=2000 in place of 500,000, a cut of
               the ring's 11 GB address-space reservation that changes no
               work, as sampling stays within the 240 rows written; the
               shipped train.pallas_normalize=false: the checkpoints at the
               top and under behavior/, K1 once per world-model step,
               behavior step and collected frame, wall seconds); and
               K1 at [1, 1, 64, 64, 3], bit-equal, its graph device time
               against its bytes bound;
3g. bridges -- a user's files in and out, at full width, in 3c's temp dir:
               5 raw recordings of 120 frames of 480 x 640 (sound,
               pose_quat, servo_value) built by data/dataset_builder
               (binary channels; host s per episode); the train CLI on the
               built set, 16 steps (batch 50 x chunk 50, bf16, K1 on) with
               train.histogram_interval=2 and 16 with train.profile_dir
               (the trace of steps 10-15), under deterministic cuDNN:
               every tensor of the two models bit-equal, the histogram
               lines, the trace, K1 once per step, validation and
               histogram pass, a step's s with and without a histogram
               pass (and the pass's logging half), the profiled steps' s;
               collect_sim_data --env synthetic (2 episodes, loaded by the
               train CLI's loader); export_torch of 3c's models_6.pt to a
               reference .pth, then train.model_path on it for 1 step (the
               loaded weights bit-equal to the .pt's, K1 launched); the
               JAX package's .msgpack fixture (tests/torch_port_fixtures/)
               through the port's reader onto the card: its det estimate
               and one deterministic step from it (train.model_path)
               within PARITY_RTOL |want| + EVAL_ATOL of the JAX package's
               stored values, and the reader's MB/s;
3d. budget  -- in a fresh process, as the CLI starts, for the default
               configuration and for the 256 px GroupNorm one: a
               device-resident replay as large as hbm_budget_bytes allows
               at the configuration's reserve (step_reserve_bytes; rows
               tiled from a small dataset), 6 full-width steps with an
               async checkpoint after step 3: no out-of-memory, finite
               losses, and what the run needed beyond the replay (peak
               reserved, memory outside the allocator) against the
               reserve;
4. parity   -- the same weights on the card and on the CPU, float32,
               deterministic (generator=None), batch 2 x chunk 4 at full
               width: loss, every metric and the gradient norms agree;
4b. variants -- the RSSM's model variants at full width (VARIANT_RUNS:
               rssm=unimodal, PoE fusion, PoE with q(st|ot) experts,
               categorical latents 32 x 32, overshooting at D = 50 with
               beta 1, the log-prob ELBO with predict_reward), each 4 steps
               and one validation through the train CLI at batch 50 x
               chunk 50, bf16, K1 on: finite metrics, the step count, K1
               exactly once per train and validation step, steps/s (the
               median after the first two steps) and peak memory; an
               overshooting run that runs out of memory is recorded and
               retried at D = 25, then 12.  Then each of them and NN
               fusion on the card against the CPU as phase parity (chunk
               6), and estimate_state / check_model on the unimodal and
               categorical runs' models_4.pt (K1 once per episode, the
               states' widths, finite imagination MSE / PSNR, expert
               artifacts for the categorical run only);
4c. codecs -- the world model's remaining codecs and training options at
               full width (CODEC_RUNS: the COBOTTA 128 px camera + sound +
               pose_quat_v2 as an observation, MoPoE over 7 subsets; 256 px
               with GroupNorm; 64 px InstanceNorm with the draw_target
               label head; 84 px with no norm and the crop off; the
               default with train.grad_accum=2, rssm.remat=true and
               rssm.remat=conv), each 4 steps and one validation through
               the train CLI at batch 50 x chunk 50, bf16, K1 on, on a
               synthetic set holding every modality: finite metrics, the
               step count, K1 exactly once per train and validation step
               and non-bin image modality, steps/s (the steps after the
               first two, without the validating last) and peak memory
               against phase train's; a
               run out of memory at batch 50 is recorded and retried at
               grad_accum 2, then 5.  Then each on the card against the
               CPU as phase parity (chunk 6), estimate_state /
               check_model on the 128 px run's models_4.pt (K1 once per
               episode, grids and SSIM only for the image, MSE / PSNR for
               every modality), and K1 at [50, 50, 128, 128, 3] and
               [50, 50, 256, 256, 3]: equal to its plain version, device
               time from a CUDA graph against the bytes bound;
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
from typing import Optional

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
EVAL_ITR = 6           # the checkpoint phase's last checkpoint
EVAL_T = 120           # steps of a synthetic episode (write_dataset)
EVAL_T_START, EVAL_HORIZON = 20, 20
# eval: card against CPU and filter against sequence, elementwise
# |diff| <= PARITY_RTOL |want| + EVAL_ATOL (float32, TF32 off; beliefs,
# posterior means and decoded means are O(0.1-1))
EVAL_ATOL = 1e-4
# the variants phase: each run's overrides of the default configuration
# (full width; batch 50 x chunk 50, bf16, K1 on, as phase train)
VARIANT_STEPS = 4
VARIANT_RUNS = {
    "unimodal": ["rssm=unimodal"],
    "poe": ["rssm.multimodal_params.fusion_method=PoE"],
    "qot_poe": ["rssm.multimodal_params.fusion_method=PoE",
                "rssm.multimodal_params.expert_dist=q(st|ot)"],
    "categorical": ["rssm.latent_dist=categorical"],   # 32 x 32, unimix 0.01
    "overshoot": ["rssm.overshooting_kl_beta=1"],      # + the distance
    "log_prob": ["rssm.worldmodel_LogProbLoss=true",
                 "rssm.predict_reward=true"],
}
OVERSHOOT_D = (50, 25, 12)     # the whole chunk first; smaller only on OOM
VARIANT_EVAL = ("unimodal", "categorical")
# card against CPU: every variant above and NN fusion, batch 2 x chunk 6
VARIANT_PARITY = {**VARIANT_RUNS,
                  "overshoot": ["rssm.overshooting_kl_beta=1",
                                "rssm.overshooting_distance=50"],
                  "nn": ["rssm.multimodal_params.fusion_method=NN"]}


# the codecs phase: each run's overrides of the default configuration (full
# width; batch 50 x chunk 50, bf16, K1 on, as phase train), on a synthetic
# set that holds every modality they name
CODEC_STEPS = 4
CODEC_SHAPES = {"image_horizon": [3, 64, 64], "image_horizon_84": [3, 84, 84],
                "image_horizon_128": [3, 128, 128],
                "image_horizon_256": [3, 256, 256], "sound": [128, 20],
                "pose_quat_v2": [3], "draw_target": [2]}


def _modalities(enc, rec=None, extra=()):
    return [f"rssm.observation_names_enc=[{','.join(enc)}]",
            f"rssm.observation_names_rec=[{','.join(rec or enc)}]", *extra]


CODEC_RUNS = {
    # the COBOTTA set's 128 px camera, sound and the pose as an observation
    # (BatchNorm; MoPoE over 7 subsets)
    "cobotta128": _modalities(("image_horizon_128", "sound", "pose_quat_v2")),
    "img256_groupnorm": _modalities(("image_horizon_256", "sound"),
                                    extra=["rssm.normalization=GroupNorm"]),
    "img64_instancenorm_label": _modalities(
        ("image_horizon", "sound"), ("image_horizon", "sound", "draw_target"),
        ["rssm.normalization=InstanceNorm",
         "env.observation_shapes.draw_target=[2]"]),
    # 84 px is not in the COBOTTA schema, and the default crop (to 64 px at
    # load, by the name) does not fit its replay: the JAX package's train
    # CLI needs the crop off too
    "img84_nonorm": _modalities(
        ("image_horizon_84", "sound"),
        extra=["rssm.normalization=None",
               "env.observation_shapes.image_horizon_84=[3,84,84]",
               "train.augmentation.n_crop=null"]),
    "grad_accum2": ["train.grad_accum=2"],
    "remat_true": ["rssm.remat=true"],
    "remat_conv": ["rssm.remat=conv"],
}
CODEC_ACCUM = (2, 5)   # a run that does not fit one card at batch 50 takes
                       # these grad_accum values, in order
CODEC_EVAL = "cobotta128"
K1_SHAPES = ((50, 50, 128, 128, 3), (50, 50, 256, 256, 3))


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

    # device times from CUDA graphs; the per-call event time (which also
    # holds the wrapper's host enqueue) beside them, as PRs 1-7 read it
    kernel_ms = graph_time_ms(lambda: ck.normalize_image(x, BIT_DEPTH, seed),
                              20)
    plain_ms = graph_time_ms(
        lambda: ck.normalize_image_plain(x, BIT_DEPTH, seed), 2, reps=3)
    call_ms = cuda_time_ms(lambda: ck.normalize_image(x, BIT_DEPTH, seed), 20)
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
          "call_event_ms": call_ms, "bound_ms": result["bound_ms"],
          "achieved_GBps": n * 8 / (kernel_ms * 1e-3) / 1e9})
    return result


def write_dataset(root: str, train_episodes: int, shapes=None) -> None:
    """Synthetic COBOTTA-schema episodes of 120 steps under root/train and
    2 of 80 under root/validation, holding ``shapes`` (default: the default
    configuration's image_horizon and sound)."""
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

    shapes = shapes or {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(os.path.join(root, "train"), train_episodes, 120,
                            shapes)
    write_synthetic_dataset(os.path.join(root, "validation"), 2, 80, shapes,
                            seed=100)


def train_run(phase: str, root: str, args, steps: int, feed: str,
              batch: int = SHAPE[1], first_step: int = 1):
    """One in-process run of the train CLI on the card, K1 on (launch
    counts and peak memory reset just before).  Raises unless it took
    ``feed``, ran ``steps`` steps from ``first_step``, logged finite losses
    and launched K1 at least once per train and validation step.  Prints
    and returns (its record, the CLI's result, the launch counts)."""
    import gc

    import torch

    from multimodal_rssm_torch.cli.train import main as train_main
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    if not any(a.startswith("--resume") for a in args):
        args = [f"train.train_data_path=[{root}/train]",
                f"train.validation_data_path=[{root}/validation]",
                "train.pallas_normalize=true", f"train.batch_size={batch}",
                f"train.chunk_size={SHAPE[0]}", "train.experience_size=1000",
                *args]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_main([*args, "--device", "cuda", "--cwd", root])
    wall = time.perf_counter() - t0
    launches = ck.launch_counts()
    values = {**{f"{k}/train": v for k, v in result["metrics"].items()},
              **{f"{k}/validation": v
                 for k, v in result["validation_metrics"].items()}}
    bad = {k: v for k, v in values.items() if not math.isfinite(v)}
    if bad or not result["validation_metrics"]:
        raise AssertionError(f"{phase}: non-finite or missing metrics: {bad}")
    if (result["feed"], result["start_step"], len(result["step_seconds"])) != (
            feed, first_step - 1, steps):
        raise AssertionError(
            f"{phase}: expected {steps} steps from {first_step} on the "
            f"{feed} feed, got {len(result['step_seconds'])} from "
            f"{result['start_step'] + 1} on the {result['feed']} feed")
    runs = steps + 1     # the train steps plus one validation step
    if launches["normalize_image"] < runs:
        raise AssertionError(f"{phase}: normalize_image launched "
                             f"{launches['normalize_image']} times in {runs} "
                             "steps")
    timed = result["step_seconds"][2:-1]   # the last step also validates
    record = {"phase": phase, "feed": feed, "batch": batch,
              "chunk": SHAPE[0], "steps": steps, "first_step": first_step,
              "launches": launches, "step_seconds": result["step_seconds"],
              "median_steps_per_s_after_warmup":
                  1.0 / statistics.median(timed) if timed else None,
              "timed_steps": len(timed),
              "max_memory_allocated_GiB":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "wall_seconds": wall, "loss": result["metrics"]["loss"],
              "validation_loss": result["validation_metrics"]["loss"]}
    emit(record)
    return record, result, launches


def phase_train():
    import torch

    batch = SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(tmp, 4)
        while True:
            try:
                record, _, launches = train_run(
                    "train", tmp, [f"train.train_iteration={TRAIN_STEPS}",
                                   f"train.validation_interval={TRAIN_STEPS}",
                                   "main.experiment_name=chip_smoke"],
                    TRAIN_STEPS, "device_resident", batch=batch)
                return launches, record
            except torch.cuda.OutOfMemoryError as e:
                if batch == 1:
                    raise
                emit({"phase": "train", "note": f"batch {batch} x chunk "
                      f"{SHAPE[0]} does not fit the card ({e}); halving the "
                      "batch"})
                batch //= 2


def graph_time_ms(fn, calls: int, reps: int = 5) -> float:
    """Device milliseconds of one ``fn()``: ``calls`` calls captured in one
    CUDA graph (after one call outside it), the graph replayed ``reps``
    times between two CUDA events; the median replay over ``calls``.  The
    host's time to enqueue a call is not in it, as it is in
    ``cuda_time_ms`` of a call that is shorter than its enqueue."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def _host_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn(i)`` for i = 1..reps, after an
    untimed ``fn(0)``."""
    fn(0)
    times = []
    for i in range(1, reps + 1):
        t0 = time.perf_counter()
        fn(i)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


FEED_EPISODES = 360     # x 120 steps: 43,200 rows, 0.97 GB
FEED_STEPS = 24
FEED_STREAM_GB = 0.5
FEED_ORDER = (("true", "device_resident"), ("stream", "stream"),
              ("false", "host"), ("false", "host"), ("stream", "stream"),
              ("true", "device_resident"))   # train.device_replay, feed


def phase_feed(device_name: str):
    """The three feeds through the CLI on a dataset of a real set's size,
    FEED_STEPS steps each, twice each in mirrored order; then the load and
    one batch's gather at that size, on the host and on the card."""
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import cuda_time_ms
    from multimodal_rssm_torch.data import buffer
    from multimodal_rssm_torch.data import device_buffer as db
    from multimodal_rssm_torch.data.native import (gather_chunks,
                                                   gather_chunks_plain)

    rows = FEED_EPISODES * 120
    B, L = SHAPE[1], SHAPE[0]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_dataset(tmp, FEED_EPISODES)
        write_s = time.perf_counter() - t0
        common = [f"train.train_iteration={FEED_STEPS}",
                  f"train.validation_interval={FEED_STEPS}",
                  f"train.experience_size={rows}",
                  f"train.replay_budget_gb={FEED_STREAM_GB}"]
        runs = {}
        for mode, feed in FEED_ORDER:
            rec, _, _ = train_run(
                "feed", tmp, [*common, f"train.device_replay={mode}",
                              f"main.experiment_name=chip_smoke_{mode}"],
                FEED_STEPS, feed)
            runs.setdefault(feed, []).append(
                rec["median_steps_per_s_after_warmup"])

        cfg = compose(overrides=[f"train.experience_size={rows}"])
        load_s = {}
        for workers in (1, 4, 4, 1):
            D = buffer.build_buffer(cfg)
            t0 = time.perf_counter()
            D.load_dataset(os.path.join(tmp, "train"), workers=workers)
            load_s.setdefault(workers, []).append(time.perf_counter() - t0)
        if (D.steps, D.full) != (rows, True):
            raise AssertionError(f"loaded {D.steps} rows, not {rows}")
        stream = db.StreamingDeviceReplay(D, L, torch.device("cuda"),
                                          int(FEED_STREAM_GB * 2 ** 30))
        if not 2 <= stream.W < stream.n_host_segments:
            raise AssertionError(f"working set {stream.W} of "
                                 f"{stream.n_host_segments} segments")
        idxs = [D.sample_indices(B, L) for _ in range(21)]
        arrays = [*D.observations.values(), D.actions, D.rewards,
                  D.nonterminals]
        batch_bytes = sum(a.itemsize * a[0].size for a in arrays) * B * L
        image = D.observations["image_horizon"]
        staged = torch.empty((L, B, *image.shape[1:]), dtype=torch.uint8,
                             pin_memory=True).numpy()
        image_ms = {f"native_pinned_{t}_threads": _host_ms(
            lambda i, t=t: gather_chunks(image, idxs[i], t, out=staged), 20)
            for t in (1, 2, 4, 8)}
        image_ms["native_fresh_default_threads"] = _host_ms(
            lambda i: gather_chunks(image, idxs[i]), 20)
        image_ms["numpy"] = _host_ms(
            lambda i: gather_chunks_plain(image, idxs[i]), 20)

        def numpy_batch(i):
            return ({k: gather_chunks_plain(v, idxs[i])
                     for k, v in D.observations.items()},
                    *(gather_chunks_plain(a, idxs[i])
                      for a in (D.actions, D.rewards, D.nonterminals)))

        native_ms = _host_ms(lambda i: D.gather(idxs[i]), 20)
        numpy_ms = _host_ms(numpy_batch, 20)
        # a step's host work before the pinned feed (NumPy gather, pin,
        # copy) and the host feed's producer (its draw, the native gather
        # into a pinned batch, the copy)
        numpy_pin_copy_ms = _host_ms(lambda i: (
            buffer.to_device(numpy_batch(i), torch.device("cuda")),
            torch.cuda.synchronize()), 10)
        feed = buffer.HostBatchFeed(D, B, L, torch.device("cuda"))
        feed_ms = _host_ms(lambda i: (feed(), torch.cuda.synchronize()), 10)
        working_set = [stream.W, stream.n_host_segments]
        replay = db.DeviceReplay(D, torch.device("cuda"))
        didx = db.indices_to_device(idxs[0], torch.device("cuda"))
        device_ms = cuda_time_ms(lambda: db.gather_batch(
            replay.arrays, didx, D.observation_names, replay.row_shapes), 20)
        replay_gb = db.DeviceReplay.nbytes(D) / 1e9
        del replay, stream, D, feed
    emit({"phase": "feed_gather", "batch": B, "chunk": L, "rows": rows,
          "dataset_GB": replay_gb, "write_dataset_s": write_s,
          "stream_working_set": working_set,
          "steps_per_s_by_feed": runs,
          "load_s": {f"{w}_workers": v for w, v in load_s.items()},
          "batch_MB": batch_bytes / 1e6, "host_cores": os.cpu_count(),
          "host_gather_ms": {"native": native_ms, "numpy": numpy_ms},
          "image_gather_ms": image_ms,
          "host_numpy_pin_copy_ms": numpy_pin_copy_ms,
          "host_feed_producer_ms": feed_ms,
          "device_gather_ms": device_ms,
          "device_gather_bound_ms": 2 * batch_bytes / hbm_rate(device_name) * 1e3})


def phase_checkpoint(tmp: str) -> str:
    """Resume on the card, the restored state against the saved one, and
    an async save's cost to the loop against a synchronous save's (full
    width: the model, Adam's moments and the schedule), on a dataset
    written under ``tmp``.  Returns the run dir (checkpoints at 2, 4, 6)."""
    import torch

    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.models.world_model import WorldModel
    from multimodal_rssm_torch.train import trainer as tr

    write_dataset(tmp, 4)
    first, result, _ = train_run(
        "checkpoint", tmp, ["train.train_iteration=4",
                            "train.validation_interval=4",
                            "train.checkpoint_interval=2",
                            "main.experiment_name=chip_smoke_resume"],
        4, "device_resident")
    run_dir = result["results_dir"]
    saved = {k: v.clone() for k, v in result["model"].state_dict().items()}
    del result
    resumed, result, _ = train_run(
        "checkpoint", tmp, ["train.train_iteration=6",
                            "train.validation_interval=6",
                            "--resume", run_dir], 2, "device_resident",
        first_step=5)
    del result
    cfg = load_run_config(run_dir)
    model = WorldModel.from_config(cfg).to("cuda")
    optimizer, scheduler = tr.build_optimizer(cfg, model)
    path = os.path.join(run_dir, "models_4.pt")
    step, extra = ckpt.load_checkpoint(path, model, optimizer, scheduler)
    differ = [k for k, v in model.state_dict().items()
              if not (v.is_cuda and torch.equal(v, saved[k]))]
    if step != 4 or differ or "generator" not in extra:
        raise AssertionError(f"restored step {step}; tensors that differ "
                             f"from the saved model: {differ}")
    del saved

    save_dir = os.path.join(tmp, "timing")
    sync_ms = _host_ms(lambda i: ckpt.save_checkpoint(
        save_dir, 1, model, optimizer, scheduler, extra), 3)
    saver = ckpt.AsyncCheckpointer()
    blocked, total = [], []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(save_dir, 2, model, optimizer, scheduler, extra)
        t1 = time.perf_counter()
        saver.wait()
        t2 = time.perf_counter()
        if i:          # the first call allocates the pinned buffers
            blocked.append((t1 - t0) * 1e3)
            total.append((t2 - t0) * 1e3)
    size = os.path.getsize(os.path.join(save_dir, "models_2.pt"))
    emit({"phase": "checkpoint_save", "restored_bit_equal": True,
          "file_MB": size / 1e6, "sync_save_ms": sync_ms,
          "async_save_blocking_ms": statistics.median(blocked),
          "async_save_until_written_ms": statistics.median(total),
          "resume": {"first": first["step_seconds"],
                     "resumed": resumed["step_seconds"]}})
    return run_dir


def _all_finite(tree) -> bool:
    import numpy as np

    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    return bool(np.isfinite(np.asarray(tree)).all())


def _eval_err(got, want) -> dict:
    """Max |diff| and max |diff| / (|want| + EVAL_ATOL / PARITY_RTOL) of two
    tensors; ``ok`` when |diff| <= PARITY_RTOL |want| + EVAL_ATOL
    everywhere."""
    d = (got.detach().cpu().double() - want.detach().cpu().double()).abs()
    w = want.detach().cpu().double().abs()
    return {"max_abs": float(d.max()),
            "max_rel": float((d / (w + EVAL_ATOL / PARITY_RTOL)).max()),
            "ok": bool((d <= PARITY_RTOL * w + EVAL_ATOL).all())}


def phase_eval(tmp: str, run_dir: str, device_name: str) -> dict:
    """The offline evaluation at full width on the checkpoint phase's run:
    ``cli.estimate_state`` in process over that run and a twin of it whose
    config says ``train.pallas_normalize=false``, the shipped default (one
    entry per episode file, shapes, finite values, the two runs' states
    alike, K1 launched once per episode of each, ms per episode),
    ``cli.check_model`` (its artifacts and finite metrics), the card's det
    estimate, reconstruction and 20-step imagination against the CPU's on
    the same weights and prepared observations, and the streaming filter
    frame by frame against the card's own sequence estimate (ms per
    frame).  Returns K1's launches on the two entry points and K1's device
    time at an episode's shape."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.cli import check_model, estimate_state
    from multimodal_rssm_torch.core.config import (
        apply_overrides, load_run_config, save_config)
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.eval import imagination
    from multimodal_rssm_torch.eval import state_estimation as se
    from multimodal_rssm_torch.eval.streaming import OnlineFilter
    from multimodal_rssm_torch.io.checkpoint import find_model_checkpoint
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.train import trainer as tr

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = load_run_config(run_dir)
    D = build_buffer(cfg)
    load_dataset(tmp, D, cfg.train.train_data_path)
    n_epi = D.episodes
    # the same weights under the shipped default, K1 off in training
    twin = run_dir.rstrip(os.sep) + "_trained_without_k1"
    os.makedirs(twin)
    save_config(apply_overrides(load_run_config(run_dir),
                                ["train.pallas_normalize=false"]),
                os.path.join(twin, "hydra_config.yaml"))
    os.link(os.path.join(run_dir, f"models_{EVAL_ITR}.pt"),
            os.path.join(twin, f"models_{EVAL_ITR}.pt"))
    if load_run_config(twin).train.pallas_normalize is not False:
        raise AssertionError("the twin run's config does not turn K1 off")

    # cli.estimate_state, each episode's estimate timed to its end
    episode_ms = []
    estimate = se.estimate_episode

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = estimate(*args, **kwargs)
        torch.cuda.synchronize()
        episode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    ck.reset_launch_counts()
    se.estimate_episode = timed
    try:
        t0 = time.perf_counter()
        saved = estimate_state.main(["--targets", os.path.dirname(run_dir),
                                     "--itr", str(EVAL_ITR), "--cwd", tmp])
        estimate_s = time.perf_counter() - t0
    finally:
        se.estimate_episode = estimate
    est_launches = {k: v for k, v in ck.launch_counts().items() if v}
    want_saved = {os.path.join(d, f"states_models_{EVAL_ITR}.npy")
                  for d in (run_dir, twin)}
    if len(saved) != 2 or set(saved) != want_saved:
        raise AssertionError(f"estimate_state saved {saved}")
    states, twin_states = (
        np.load(os.path.join(d, f"states_models_{EVAL_ITR}.npy"),
                allow_pickle=True).item() for d in (run_dir, twin))
    experts = {"prior_expert", "image_horizon", "sound"}
    bad = [name for name, s in states.items()
           if s["beliefs"].shape != (EVAL_T - 1, 1, 1024)
           or s["posterior_means"].shape != (EVAL_T - 1, 1, 128)
           or set(s["expert_means"]) != experts or not _all_finite(s)]
    if list(states) != D.file_names or list(twin_states) != D.file_names or bad:
        raise AssertionError(f"states of {list(states)} / {list(twin_states)}"
                             f" (want {D.file_names}); wrong or not finite: "
                             f"{bad}")
    twin_err = {f"{name}/{k}": _eval_err(torch.from_numpy(twin_states[name][k]),
                                         torch.from_numpy(s[k]))
                for name, s in states.items()
                for k in ("beliefs", "posterior_means")}
    if not all(e["ok"] for e in twin_err.values()):
        raise AssertionError(f"the twin run's states differ: {twin_err}")
    if est_launches != {"normalize_image": 2 * n_epi}:
        raise AssertionError(f"estimate_state over 2 runs of {n_epi} "
                             f"episodes launched {est_launches}")

    # cli.check_model, on the run whose config turns K1 off
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    report = check_model.main(["--run", twin, "--itr", str(EVAL_ITR),
                               "--episode", "0", "--t-start",
                               str(EVAL_T_START), "--horizon",
                               str(EVAL_HORIZON), "--cwd", tmp])
    check_s = time.perf_counter() - t0
    check_launches = {k: v for k, v in ck.launch_counts().items() if v}
    files = set(report["files"])
    missing = [f for f in ("pca_beliefs.npy", "pca_posterior_means.npy",
                           "expert_distributions.npy", "imagination_mse.json")
               if f not in files]
    missing += [f"{tag}_image_horizon.png|.npy"
                for tag in ("reconstruction", "imagination")
                if not files & {f"{tag}_image_horizon.png",
                                f"{tag}_image_horizon.npy"}]
    quality = report["metrics"]
    if (missing or not _all_finite(report["mse"])
            or not _all_finite(quality) or "ssim" not in quality["image_horizon"]
            or (report["t_start"], report["horizon"])
            != (EVAL_T_START, EVAL_HORIZON)):
        raise AssertionError(f"check_model: missing {missing}; {report}")
    if check_launches != {"normalize_image": n_epi}:
        raise AssertionError(f"check_model launched {check_launches}")

    # the card against the CPU: same weights, same prepared episode
    path = find_model_checkpoint(run_dir, EVAL_ITR)
    card = se.load_eval_model(cfg, path, dev)
    cpu = se.load_eval_model(cfg, path, torch.device("cpu"))
    spec = tr.build_aug_spec(D)
    obs, act, _, nt = se.get_episode_data(
        D, 0, spec, se.fixed_draws(D, spec), int(cfg.env.bit_depth),
        torch.Generator(dev).manual_seed(0), dev)
    obs = {k: v[1:] for k, v in obs.items()}
    act, nt = act[:-1], nt[:-1]

    def evaluate(model, to):
        with torch.no_grad():
            s = model.estimate_state({k: v.to(to) for k, v in obs.items()},
                                     act.to(to), nt.to(to))
        _, preds = imagination.imagine(model, s, act.to(to), EVAL_T_START,
                                       EVAL_HORIZON)
        return s, imagination.reconstruct(model, s), preds

    t0 = time.perf_counter()
    c_states, c_recon, c_preds = evaluate(cpu, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    g_states, g_recon, g_preds = evaluate(card, dev)
    parity = {k: _eval_err(g_states[k], c_states[k])
              for k in ("beliefs", "posterior_means")}
    for tag, g, c in (("reconstruct", g_recon, c_recon),
                      ("imagine", g_preds, c_preds)):
        for name in g:
            parity[f"{tag}/{name}"] = _eval_err(g[name]["loc"], c[name]["loc"])
    del cpu, c_states, c_recon, c_preds

    # the streaming filter, frame by frame on the card
    filt = OnlineFilter(card)
    filt.reset(1)
    frame_ms, steps = [], []
    for t in range(act.shape[0]):
        frame = {k: v[t] for k, v in obs.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps.append(filt.step(act[t], frame, nt[t]))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    timed_frames = frame_ms[5:]
    filt_err = {k: _eval_err(torch.stack([s[k] for s in steps]), g_states[k])
                for k in ("beliefs", "posterior_means", "posterior_states")}
    # of a frame: the encoders on one frame (the rest is the core step)
    frame0 = {k: v[:1] for k, v in obs.items()}
    with torch.no_grad():
        encode_frame_ms = _host_ms(
            lambda i: (card.encode(frame0), torch.cuda.synchronize()), 20)

    # K1 at an episode's shape (one launch of cli.estimate_state); device
    # times from CUDA graphs: at this size the wrapper's host enqueue
    # (host_enqueue_ms) is longer than the kernel
    x = torch.randint(0, 256, (EVAL_T, 1, 64, 64, 3), device=dev,
                      generator=torch.Generator(dev).manual_seed(1),
                      dtype=torch.uint8).float()
    seed = torch.tensor(7, dtype=torch.int64, device=dev)
    if not torch.equal(ck.normalize_image(x, BIT_DEPTH, seed),
                       ck.normalize_image_plain(x, BIT_DEPTH, seed)):
        raise AssertionError("K1 != its plain version at an episode's shape")
    k1_ms = graph_time_ms(lambda: ck.normalize_image(x, BIT_DEPTH, seed), 20)
    k1_plain_ms = graph_time_ms(
        lambda: ck.normalize_image_plain(x, BIT_DEPTH, seed), 5)
    # the wrapper's host time to enqueue one launch (checks, allocation,
    # the ctypes call), no synchronisation
    k1_host_ms = _host_ms(lambda i: ck.normalize_image(x, BIT_DEPTH, seed), 50)
    torch.cuda.synchronize()
    k1_bound_ms = x.numel() * 8 / hbm_rate(device_name) * 1e3
    record = {
        "phase": "eval", "itr": EVAL_ITR, "episodes": n_epi,
        "episode_steps": EVAL_T, "dtype": "float32",
        "estimate_state": {"runs": 2, "states_entries": len(states),
                           "twin_run_max_rel": max(
                               e["max_rel"] for e in twin_err.values()),
                           "episode_ms": episode_ms,
                           "median_episode_ms": statistics.median(episode_ms),
                           "seconds": estimate_s, "launches": est_launches},
        "check_model": {"seconds": check_s, "files": sorted(files),
                        "mse": report["mse"], "metrics": quality,
                        "launches": check_launches},
        "card_vs_cpu": {"rtol": PARITY_RTOL, "atol": EVAL_ATOL,
                        "cpu_seconds": cpu_s, "errors": parity},
        "filter": {"frames": len(frame_ms), "timed_frames": len(timed_frames),
                   "median_frame_ms": statistics.median(timed_frames),
                   "encode_frame_ms": encode_frame_ms,
                   "rtol": PARITY_RTOL, "atol": EVAL_ATOL,
                   "errors": filt_err},
        "k1_episode_shape": {"shape": list(x.shape), "ms": k1_ms,
                             "plain_ms": k1_plain_ms,
                             "host_enqueue_ms": k1_host_ms,
                             "bound_ms": k1_bound_ms},
        "wall_seconds": time.perf_counter() - t_phase}
    emit(record)
    failed = {k: e for k, e in {**parity, **{f"filter/{k}": e for k, e in
                                            filt_err.items()}}.items()
              if not e["ok"]}
    if failed or len(timed_frames) < 100:
        raise AssertionError(f"eval: outside rtol {PARITY_RTOL} + atol "
                             f"{EVAL_ATOL}: {failed}; {len(timed_frames)} "
                             "timed frames")
    return {"estimate_state": est_launches["normalize_image"],
            "check_model": check_launches["normalize_image"],
            "episode_shape_ms": k1_ms}


ONLINE_ENV_LENGTH = 60
ONLINE_EXPERIENCE = 2000   # rows, in place of the default 500,000: the
# ring is np.empty, so its unwritten pages are never resident, and sampling
# stays within the 240 rows written; the cut changes none of the work and
# only keeps the buffer's 11 GB address-space reservation out of the run
CONTROL_ITERS = 4


def _finite(values) -> bool:
    return all(math.isfinite(float(v)) for v in values)


def behavior_card_against_cpu(seed: int = 0) -> dict:
    """One behavior step (``BehaviorStep.update``) of the default
    configuration at full width, batch 2 x chunk 6, float32, TF32 off, on
    the same weights, prepared batch and noise (drawn on the CPU) on the
    card and on the CPU: the losses, the mean return and both heads'
    gradient norms.  Returns (cpu, card, max relative error, those outside
    PARITY_RTOL)."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops.image import normalize_image_deterministic
    from multimodal_rssm_torch.train import behavior as bh

    L, B = 6, 2
    cfg = bh.behavior_cfg(compose(overrides=[
        "train.use_amp=False", f"train.chunk_size={L}",
        f"train.batch_size={B}", "rssm.predict_reward=true"]))
    H, N = int(cfg.behavior.horizon), (L - 1) * B
    S, A = int(cfg.rssm.state_size), int(cfg.env.action_size)
    rng = np.random.default_rng(seed)
    batch = ({"image_horizon": normalize_image_deterministic(torch.from_numpy(
                  rng.integers(0, 256, (L, B, 64, 64, 3), np.uint8)),
                  BIT_DEPTH),
              "sound": torch.from_numpy(rng.normal(size=(L, B, 128, 20)
                                                   ).astype(np.float32))},
             torch.from_numpy(rng.uniform(-1, 1, (L, B, A)).astype(
                 np.float32)),
             torch.from_numpy(rng.normal(size=(L, B)).astype(np.float32)),
             torch.ones(L, B, 1))
    g = torch.Generator().manual_seed(seed)
    noise = bh.BehaviorNoise(
        posterior=(torch.randn(L - 1, B, S, generator=g),
                   torch.randn(L - 1, B, S, generator=g)),
        starts=None, actions=torch.randn(H, N, A, generator=g),
        states=torch.randn(H, N, S, generator=g))
    keys = ("actor_loss", "value_loss", "imag_return", "actor_grad_norm",
            "value_grad_norm")
    out = []
    for dev in (torch.device("cpu"), torch.device("cuda")):
        model = WorldModel.from_config(cfg)
        init_parameters(model, torch.Generator().manual_seed(seed))
        model.to(dev)
        bstate = bh.init_behavior_state(cfg, dev, seed)
        step = bh.BehaviorStep(model, cfg, None, dev)
        moved = ({k: v.to(dev) for k, v in batch[0].items()},
                 *(x.to(dev) for x in batch[1:]))
        metrics = step.update(bstate, moved, None, noise)
        out.append({k: float(metrics[k]) for k in keys})
    cpu, card = out
    rel = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in keys}
    bad = {k: (cpu[k], card[k]) for k, r in rel.items()
           if r > PARITY_RTOL and abs(card[k] - cpu[k]) > 1e-6}
    return cpu, card, max(rel.values()), bad


def _timed_agent_calls(times):
    """Patch ``LatentAgent.__call__`` (``CEMAgent``'s too) to record each
    call's ms (filter, actor or planner, and the action's copy to the host,
    which synchronises); returns the function that undoes it."""
    from multimodal_rssm_torch.train import agent as agent_mod

    call = agent_mod.LatentAgent.__call__

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = call(self, *args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    agent_mod.LatentAgent.__call__ = timed
    return lambda: setattr(agent_mod.LatentAgent, "__call__", call)


def phase_control(tmp: str, run_dir: str, device_name: str) -> dict:
    """Control at full width on the checkpoint phase's run (models_6.pt,
    the default configuration): the train_behavior CLI (4 iterations, H 15,
    every posterior state a start: 2,450 at batch 50 x chunk 50; the world
    model bit-equal to its file after, both heads moved, K1 once per
    iteration with train.pallas_normalize=false, steps/s after the first
    two, peak memory), one behavior
    step on the card against the CPU, the eval_policy CLI with the actor (2
    episodes of 100 steps of the synthetic env, K1 once per frame, ms per
    action) and with CEM at the planner's defaults (refused without
    rssm.predict_reward=true; 1 episode of 50 steps, ms per planned
    action), the train_online CLI in both collection modes (2 seed
    episodes, 2 episodes of 2 updates, env length 60, experience size
    2,000: checkpoints, K1 once per world-model step, behavior step and
    collected frame), and K1 at the agent's frame shape.  Returns K1's
    launches by path and its frame-shape record."""
    import torch

    from multimodal_rssm_torch.cli import eval_policy, train_behavior
    from multimodal_rssm_torch.cli import train_online
    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.train import behavior as bh

    t_phase = time.perf_counter()
    record = {"phase": "control", "run": os.path.basename(run_dir)}

    # 1. behavior learning through the CLI
    saved = torch.load(os.path.join(run_dir, f"models_{EVAL_ITR}.pt"),
                       map_location="cpu", weights_only=True)["model"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_behavior.main([
        "--run-dir", run_dir, "--cwd", tmp,
        f"behavior.train_iteration={CONTROL_ITERS}",
        f"behavior.checkpoint_interval={CONTROL_ITERS}",
        # the shipped default, over the run's own true: K1 runs all the same
        "train.pallas_normalize=false"])
    behavior_s = time.perf_counter() - t0
    bh_launches = {k: v for k, v in ck.launch_counts().items() if v}
    cfg = bh.behavior_cfg(load_run_config(run_dir))
    fresh = bh.init_behavior_state(cfg, torch.device("cuda"),
                                   int(cfg.main.seed or 0))
    moved = [name for name, got, init in (
        ("actor", result["state"].actor, fresh.actor),
        ("value", result["state"].value, fresh.value))
        if any(not torch.equal(v, init.state_dict()[k])
               for k, v in got.state_dict().items())]
    changed = [k for k, v in result["model"].state_dict().items()
               if not torch.equal(v.cpu(), saved[k])]
    timed = result["step_seconds"][2:]
    record["train_behavior"] = {
        "iterations": CONTROL_ITERS, "horizon": int(cfg.behavior.horizon),
        "starts": (int(cfg.train.chunk_size) - 1) * int(cfg.train.batch_size),
        "feed": result["feed"], "metrics": result["metrics"],
        "step_seconds": result["step_seconds"],
        "median_steps_per_s_after_warmup": 1.0 / statistics.median(timed),
        "max_memory_allocated_GiB":
            torch.cuda.max_memory_allocated() / 2 ** 30,
        "seconds": behavior_s, "launches": bh_launches,
        "heads_moved": moved, "world_model_tensors_changed": changed}
    if (not _finite(result["metrics"].values()) or moved != ["actor", "value"]
            or changed or bh_launches != {"normalize_image": CONTROL_ITERS}):
        emit(record)
        raise AssertionError(f"train_behavior: {record['train_behavior']}")
    del result, fresh, saved

    # 2. one behavior step, the card against the CPU
    cpu, card, max_rel, bad = behavior_card_against_cpu()
    record["behavior_card_vs_cpu"] = {"batch": 2, "chunk": 6,
                                      "rtol": PARITY_RTOL,
                                      "max_rel_err": max_rel, "cpu": cpu,
                                      "cuda": card}
    if bad:
        emit(record)
        raise AssertionError(f"behavior step, card and CPU disagree: {bad}")

    # 3-4. policy evaluation, the actor and CEM
    def evaluate(args, expect_launches):
        times = []
        undo = _timed_agent_calls(times)
        ck.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            stats = eval_policy.main(["--run-dir", run_dir, "--env",
                                      "synthetic", *args])
            seconds = time.perf_counter() - t0
        finally:
            undo()
        launches = {k: v for k, v in ck.launch_counts().items() if v}
        out = {"args": args, "stats": stats, "seconds": seconds,
               "frames": len(times), "launches": launches,
               "median_ms_per_action": statistics.median(times[1:]),
               "first_action_ms": times[0]}
        if (launches != {"normalize_image": expect_launches}
                or len(times) != expect_launches
                or not _finite(stats["returns"])):
            emit({**record, "failed": out})
            raise AssertionError(f"eval_policy {args}: {out}")
        return out

    record["eval_policy_actor"] = evaluate(
        ["--policy", "actor", "--episodes", "2", "--env-length", "100"], 200)
    try:
        eval_policy.main(["--run-dir", run_dir, "--policy", "cem",
                          "--episodes", "1", "--env-length", "50"])
    except ValueError as e:
        if "predict_reward" not in str(e):
            raise
    else:
        raise AssertionError("eval_policy --policy cem ran on a run without "
                             "a trained reward head")
    record["eval_policy_cem"] = evaluate(
        ["--policy", "cem", "--episodes", "1", "--env-length", "50",
         "rssm.predict_reward=true"], 50)

    # 5. online training in both collection modes
    record["train_online"] = {}
    online_launches = {}
    for mode in ("actor", "cem"):
        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = train_online.main([
            "online.seed_episodes=2", "online.episodes=2",
            "online.collect_interval=2", f"online.collect_policy={mode}",
            f"train.experience_size={ONLINE_EXPERIENCE}",
            f"main.experiment_name=chip_smoke_online_{mode}", "--env",
            "synthetic", "--env-length", str(ONLINE_ENV_LENGTH), "--cwd",
            tmp])
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ck.launch_counts().items() if v}
        updates, frames = 2 * 2, 2 * ONLINE_ENV_LENGTH
        want = updates * (2 if mode == "actor" else 1) + frames
        files = sorted(os.listdir(out["results_dir"]))
        behavior = sorted(os.listdir(os.path.join(out["results_dir"],
                                                  "behavior"))
                          if mode == "actor" else [])
        rows = [json.loads(line) for line in open(os.path.join(
            out["results_dir"], "metrics.jsonl"))]
        online_rows = [r for r in rows if "episode_reward/online" in r]
        rec = {"wall_seconds": wall, "launches": launches,
               "checkpoints": [f for f in files if f.endswith(".pt")],
               "behavior_checkpoints": behavior,
               "max_memory_allocated_GiB":
                   torch.cuda.max_memory_allocated() / 2 ** 30,
               "episodes": [{k: r.get(f"{k}/online") for k in (
                   "episode_reward", "wm_loss", "actor_loss")}
                   for r in online_rows]}
        record["train_online"][mode] = rec
        online_launches[mode] = launches.get("normalize_image", 0)
        if (launches != {"normalize_image": want}
                or "models_2.pt" not in files
                or (mode == "actor") != ("models_2.pt" in behavior)
                or len(online_rows) != 2
                or not all(_finite(r.values()) for r in online_rows)):
            emit(record)
            raise AssertionError(f"train_online {mode}: {rec}")
        del out

    # K1 at the agents' frame shape, device time from a CUDA graph
    x = torch.randint(0, 256, (1, 1, 64, 64, 3), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(4),
                      dtype=torch.uint8).float()
    seed = torch.tensor(5, dtype=torch.int64, device="cuda")
    if not torch.equal(ck.normalize_image(x, BIT_DEPTH, seed),
                       ck.normalize_image_plain(x, BIT_DEPTH, seed)):
        raise AssertionError("K1 != its plain version at [1, 1, 64, 64, 3]")
    frame = {"shape": list(x.shape), "bit_equal": True,
             "ms": graph_time_ms(lambda: ck.normalize_image(x, BIT_DEPTH,
                                                            seed), 20),
             "plain_ms": graph_time_ms(
                 lambda: ck.normalize_image_plain(x, BIT_DEPTH, seed), 5),
             "host_enqueue_ms": _host_ms(
                 lambda i: ck.normalize_image(x, BIT_DEPTH, seed), 50),
             "bound_ms": x.numel() * 8 / hbm_rate(device_name) * 1e3}
    torch.cuda.synchronize()
    record["k1_frame_shape"] = frame
    record["wall_seconds"] = time.perf_counter() - t_phase
    emit(record)
    return {"launches": {
        "train_behavior": bh_launches["normalize_image"],
        "eval_policy_actor": record["eval_policy_actor"]["launches"][
            "normalize_image"],
        "eval_policy_cem": record["eval_policy_cem"]["launches"][
            "normalize_image"],
        "train_online": online_launches}, "frame_shape": frame}


BRIDGE_EPISODES = 5          # raw recordings: 4 train + 1 validation
BRIDGE_T = 120               # frames a recording
BRIDGE_FRAME = (480, 640)    # a VGA camera, resized to 256 / 128 / 64
BRIDGE_STEPS = 16            # the profiler's window is steps 10-15
BRIDGE_HIST = 2              # train.histogram_interval
FIXTURE = os.path.join(REPO, "tests", "torch_port_fixtures",
                       "jax_unimodal_pose")


def raw_recordings(n: int, T: int, seed: int = 0):
    """Raw COBOTTA-style recordings for the dataset builder: a bright square
    moving over a gradient in ``BRIDGE_FRAME`` uint8 RGB frames, sound
    spectrograms [T, 128, 20], ``pose_quat`` [T, 3] (the COBOTTA set's
    width: its ``d_pose_quat_v2`` is the 3-d action) and ``servo_value``
    [T, 6] (the names ``data/dataset_builder.build_episode`` reads)."""
    import numpy as np

    H, W = BRIDGE_FRAME
    rng = np.random.default_rng(seed)
    base = (np.linspace(40, 160, H, dtype=np.float32)[:, None, None]
            + np.linspace(0, 60, W, dtype=np.float32)[None, :, None]
            + np.asarray([0, 20, 40], np.float32))
    out = []
    for _ in range(n):
        frames = np.empty((T, H, W, 3), np.uint8)
        path = np.cumsum(rng.normal(0, 6, (T, 2)), 0) + (H / 2, W / 2)
        for t, (cy, cx) in enumerate(path):
            img = base.copy()
            y0, x0 = int(cy) % (H - 40), int(cx) % (W - 40)
            img[y0:y0 + 40, x0:x0 + 40] = (230, 60, 40)
            frames[t] = img
        pose = np.cumsum(rng.normal(0, 1e-3, (T, 3)), 0)
        out.append({"image": frames,
                    "sound": rng.gamma(2.0, 1.0, (T, 128, 20)),
                    "pose_quat": pose, "servo_value": rng.normal(size=(T, 6)),
                    "reward": -np.linalg.norm(pose, axis=1)})
    return out


def _bridge_msgpack(record: dict) -> None:
    """The JAX package's ``.msgpack`` fixture on the card: its det estimate
    and one deterministic step from it (``train.model_path``) against the
    JAX package's stored values, float32, TF32 off; the decoder's read
    time."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.io import flax_msgpack
    from multimodal_rssm_torch.models.world_model import WorldModel
    from multimodal_rssm_torch.train import loop
    from multimodal_rssm_torch.train import trainer as tr

    dev = torch.device("cuda")
    with np.load(FIXTURE + ".npz") as z:
        npz = dict(z)
    cfg = compose(overrides=[str(o) for o in npz["config/overrides"]])

    def t(key):
        return torch.from_numpy(np.array(npz[key])).to(dev)

    model = WorldModel.from_config(cfg)
    ckpt.load_model_weights(FIXTURE + ".msgpack", model)
    model.to(dev).eval()
    with torch.no_grad():
        est = model.estimate_state({"pose_quat_v2": t("episode/pose_quat_v2")},
                                   t("episode/actions"),
                                   t("episode/nonterminals"))
    errors = {k: _eval_err(est[k], torch.from_numpy(npz[f"estimate/{k}"]))
              for k in ("beliefs", "posterior_means")}

    cfg.train.model_path = FIXTURE + ".msgpack"
    model = WorldModel.from_config(cfg).to(dev)
    opt, sched = tr.build_optimizer(cfg, model)
    loop.load_model_path(cfg, REPO, model, opt, sched)
    loss, _ = tr.make_loss_fn(model, cfg)(
        ({"pose_quat_v2": t("batch/pose_quat_v2")}, t("batch/actions"),
         t("batch/rewards"), t("batch/nonterminals")), None, True)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    tr.apply_gradients(model, opt, sched, float(cfg.rssm.grad_clip_norm))
    state = opt.state_dict()["state"]
    for i, (name, p) in enumerate(model.named_parameters()):
        errors[f"params/{name}"] = _eval_err(
            p, torch.from_numpy(npz[f"step/params/{name}"]))
        if p.grad is not None:   # torch's Adam skips an unused parameter
            errors[f"exp_avg/{name}"] = _eval_err(
                state[i]["exp_avg"],
                torch.from_numpy(npz[f"step/exp_avg/{name}"]))
            if float(state[i]["step"]) != float(npz["step/count"]):
                raise AssertionError(f"{name}: Adam step {state[i]['step']}")
    bad = {k: v for k, v in errors.items() if not v["ok"]}
    if bad:
        raise AssertionError(f"bridges: the .msgpack fixture on the card "
                             f"differs from the JAX package's values: {bad}")
    size = os.path.getsize(FIXTURE + ".msgpack")
    read_s = _host_ms(lambda i: flax_msgpack.load(FIXTURE + ".msgpack"),
                      5) / 1e3
    record["msgpack"] = {
        "file_MB": size / 1e6, "read_s": read_s,
        "read_MB_per_s": size / 1e6 / read_s,
        "estimate_max_rel": {k: errors[k]["max_rel"]
                             for k in ("beliefs", "posterior_means")},
        "step_params_max_rel": max(v["max_rel"] for k, v in errors.items()
                                   if k.startswith("params/")),
        "step_exp_avg_max_rel": max(v["max_rel"] for k, v in errors.items()
                                    if k.startswith("exp_avg/")),
        "tolerance": f"|diff| <= {PARITY_RTOL} |want| + {EVAL_ATOL}"}


def phase_bridges(tmp: str, run_dir: str, device_name: str) -> dict:
    """A user's files in and out at full width.  1. raw recordings
    (``raw_recordings``) built by ``data/dataset_builder.build_dataset``
    (binary channels on; host seconds per episode), then the train CLI on
    that set (batch 50 x chunk 50, bf16, K1 on) for BRIDGE_STEPS steps with
    ``train.histogram_interval`` and again with ``train.profile_dir``
    instead, under deterministic cuDNN: finite metrics, every parameter and
    running stat bit-equal between the two (both options only observe),
    the histogram lines, the trace file, K1 once per train and validation
    step and histogram pass, a step's seconds with and without a histogram
    pass and the pass's logging half alone, the profiled steps' seconds
    against the unprofiled ones; 2. ``collect_sim_data --env synthetic`` for 2
    episodes, loaded by the train CLI's loader; 3. ``export_torch`` of the
    checkpoint phase's ``models_6.pt`` to a reference ``.pth``, then
    ``train.model_path`` on it for 1 step, the loaded weights bit-equal to
    the ``.pt``'s; 4. the JAX package's ``.msgpack`` fixture
    (``_bridge_msgpack``).  Returns K1's launches by path."""
    import json

    import torch

    from multimodal_rssm_torch.cli import collect_sim_data, export_torch
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.data.dataset_builder import build_dataset
    from multimodal_rssm_torch.io.metrics import MetricLogger
    from multimodal_rssm_torch.train import loop

    t_phase = time.perf_counter()
    record = {"phase": "bridges", "device": device_name}

    # 1. raw recordings -> the built set -> the train CLI
    built = os.path.join(tmp, "built")
    raw = raw_recordings(BRIDGE_EPISODES, BRIDGE_T)
    t0 = time.perf_counter()
    build_dataset(raw, built, binary=True)
    build_s = time.perf_counter() - t0
    del raw
    record["build"] = {"episodes": BRIDGE_EPISODES, "frames": BRIDGE_T,
                       "frame": list(BRIDGE_FRAME), "seconds": build_s,
                       "seconds_per_episode": build_s / BRIDGE_EPISODES}
    common = [f"train.train_iteration={BRIDGE_STEPS}",
              f"train.validation_interval={BRIDGE_STEPS}"]
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (
                ("histograms", [f"train.histogram_interval={BRIDGE_HIST}",
                                "main.experiment_name=bridges_hist"]),
                ("profiled", [f"train.profile_dir={tmp}/profile",
                              "main.experiment_name=bridges_profiled"])):
            rec, result, launches = train_run(
                f"bridges/{name}", built, common + extra, BRIDGE_STEPS,
                "device_resident")
            runs[name] = (rec, result, launches)
    finally:
        torch.backends.cudnn.deterministic = False
    (hrec, hres, hl), (prec, pres, pl) = runs["histograms"], runs["profiled"]
    n_hist = BRIDGE_STEPS // BRIDGE_HIST
    if (hl["normalize_image"], pl["normalize_image"]) != (
            BRIDGE_STEPS + 1 + n_hist, BRIDGE_STEPS + 1):
        raise AssertionError(f"bridges: K1 launched {hl['normalize_image']} "
                             f"/ {pl['normalize_image']} times")
    differ = [k for k, v in hres["model"].state_dict().items()
              if not torch.equal(v, pres["model"].state_dict()[k])]
    if differ:
        raise AssertionError(f"bridges: the histogram pass or the profiler "
                             f"changed training: {differ[:8]}")
    with open(os.path.join(hres["results_dir"], "metrics.jsonl")) as f:
        hist_steps = [r["step"] for r in map(json.loads, f)
                      if any(k.endswith("/hist") for k in r)]
    if hist_steps != sorted(2 * list(range(BRIDGE_HIST, BRIDGE_STEPS + 1,
                                           BRIDGE_HIST))):
        raise AssertionError(f"bridges: histogram lines at {hist_steps}")
    trace = pres["profile_trace"]
    if not trace or not os.path.getsize(trace):
        raise AssertionError(f"bridges: no profile trace ({trace})")
    # the logging half of a histogram pass alone, on the trained weights
    model = hres["model"]
    grads = {n: p.detach() for n, p in model.named_parameters()}
    with MetricLogger(os.path.join(tmp, "built")) as logger:
        hist_log_s = _host_ms(
            lambda i: loop.log_histograms(logger, model, grads, 0), 3) / 1e3
    del model, grads
    hs, ps = hres["step_seconds"], pres["step_seconds"]
    # 1-based steps after the first two; 15 also stops the profiler and
    # writes the trace; 16 validates
    without = [i for i in range(3, BRIDGE_STEPS) if i % BRIDGE_HIST]
    with_pass = [i for i in range(3, BRIDGE_STEPS) if not i % BRIDGE_HIST]
    window, outside = range(10, 15), range(3, 10)
    record["train"] = {
        "launches": {"histograms": hl["normalize_image"],
                     "profiled": pl["normalize_image"]},
        "bit_equal_between_the_runs": True,
        "cudnn_deterministic": True,
        "histogram_lines": len(hist_steps),
        "trace_file": os.path.basename(trace),
        "trace_MB": os.path.getsize(trace) / 1e6,
        "step_seconds": {"histograms": hs, "profiled": ps},
        "median_s": {
            "step_without_pass": statistics.median(hs[i - 1]
                                                   for i in without),
            "step_with_pass": statistics.median(hs[i - 1]
                                                for i in with_pass),
            "histogram_logging": hist_log_s,
            "unprofiled_steps_3_9": statistics.median(ps[i - 1]
                                                      for i in outside),
            "profiled_steps_10_14": statistics.median(ps[i - 1]
                                                      for i in window),
            "step_15_with_trace_export": ps[14]},
        "steps_per_s": {"histograms": hrec["median_steps_per_s_after_warmup"],
                        "profiled": prec["median_steps_per_s_after_warmup"]},
        "loss": hrec["loss"], "max_memory_allocated_GiB":
            hrec["max_memory_allocated_GiB"]}
    del runs, hres, pres
    launches = {"bridges_train": hl["normalize_image"]}

    # 2. the simulator collector
    sim = os.path.join(tmp, "sim")
    t0 = time.perf_counter()
    collect_sim_data.main(["--out", sim, "--env", "synthetic", "--episodes",
                           "2", "--length", "60"])
    D = build_buffer(compose(overrides=["train.experience_size=1000"]))
    load_dataset(tmp, D, [os.path.join(sim, "train")])
    if D.episodes != 2 or D.idx != 120:
        raise AssertionError(f"bridges: the collected set loaded "
                             f"{D.episodes} episodes, {D.idx} rows")
    record["collect_sim_data"] = {"episodes": D.episodes, "rows": int(D.idx),
                                  "seconds": time.perf_counter() - t0}

    # 3. .pt -> reference .pth -> train.model_path
    pth = os.path.join(tmp, "export", f"models_{EVAL_ITR}.pth")
    os.makedirs(os.path.dirname(pth))
    export_torch.main(["--run-dir", run_dir, "--itr", str(EVAL_ITR), "--out",
                       pth])
    saved = torch.load(os.path.join(run_dir, f"models_{EVAL_ITR}.pt"),
                       map_location="cpu", weights_only=True)["model"]
    loaded = {}
    load = loop.load_model_path

    def capture(cfg, cwd, model, *rest):
        load(cfg, cwd, model, *rest)
        loaded.update({k: v.clone() for k, v in model.state_dict().items()})

    loop.load_model_path = capture
    try:
        rec, _, ml = train_run("bridges/model_path", tmp, [
            f"train.model_path={pth}", "train.train_iteration=1",
            "train.validation_interval=1",
            "main.experiment_name=bridges_pth"], 1, "device_resident")
    finally:
        loop.load_model_path = load
    differ = [k for k, v in saved.items()
              if not torch.equal(loaded[k].cpu(), v)]
    if set(loaded) != set(saved) or differ:
        raise AssertionError(f"bridges: the .pth loaded other weights than "
                             f"models_{EVAL_ITR}.pt's: {differ[:8]}")
    record["export"] = {"pth_MB": os.path.getsize(pth) / 1e6,
                        "loaded_bit_equal": True, "tensors": len(saved),
                        "launches": ml["normalize_image"],
                        "loss": rec["loss"]}
    launches["bridges_model_path"] = ml["normalize_image"]

    # 4. the JAX package's .msgpack (no image: K1 does not run)
    _bridge_msgpack(record)
    record["wall_seconds"] = time.perf_counter() - t_phase
    emit(record)
    return launches


def budget_run(reserve_bytes: Optional[int], overrides=()) -> dict:
    """In a fresh process, as the train CLI starts: the model of the
    default configuration with ``overrides`` on the card, then a
    device-resident replay as large as ``hbm_budget_bytes`` allows at
    ``reserve_bytes`` (None: the port's ``step_reserve_bytes`` of the
    configuration; rows tiled from a small synthetic set), then six
    full-width steps from it with an async checkpoint after step 3 (its
    clones on the card inside the window).  Returns the memory readings;
    ``oom`` if a step ran out."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.data import buffer
    from multimodal_rssm_torch.data import device_buffer as db
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.train import trainer as tr

    configure_float32()
    dev = torch.device("cuda")
    L, B = SHAPE[0], SHAPE[1]
    gib = 2 ** 30
    cfg = compose(overrides=["train.pallas_normalize=true",
                             "train.experience_size=1000", *overrides])
    reserve = (db.step_reserve_bytes(cfg) if reserve_bytes is None
               else reserve_bytes)
    record = {"overrides": list(overrides), "reserve_GiB": reserve / gib,
              "oom": None}
    names = (set(cfg.rssm.observation_names_enc)
             | set(cfg.rssm.observation_names_rec))
    with tempfile.TemporaryDirectory() as tmp:
        write_dataset(tmp, 4, {n: cfg.env.observation_shapes[n]
                               for n in names})
        D = buffer.build_buffer(cfg)
        buffer.load_dataset(tmp, D, "train")
        model = WorldModel.from_config(cfg)
        init_parameters(model, torch.Generator().manual_seed(0))
        model.to(dev)
        optimizer, scheduler = tr.build_optimizer(cfg, model)
        free0, total = torch.cuda.mem_get_info(dev)
        budget = db.hbm_budget_bytes(dev, reserve)
        reserved0 = torch.cuda.memory_reserved(dev)
        small = db.DeviceReplay(D, dev)
        row_bytes = sum(v.element_size() * v.shape[1]
                        for v in small.arrays.values())
        rows = budget // row_bytes
        tile = torch.arange(rows, device=dev) % small.used
        arrays = {k: v.index_select(0, tile) for k, v in small.arrays.items()}
        del tile, small
        replay = sum(v.numel() * v.element_size() for v in arrays.values())
        spec = tr.build_aug_spec(D)
        draws = tr.HostAugmentDraws(D, spec)
        train_step, _ = tr.make_device_resident_steps(
            model, cfg, optimizer, scheduler, spec, dev, D.observation_names,
            db._row_shapes(D))
        gen = torch.Generator(dev).manual_seed(0)
        rng = np.random.default_rng(0)
        saver = ckpt.AsyncCheckpointer()
        losses, seconds, pending = [], [], None
        try:
            for step in range(1, 7):
                t0 = time.perf_counter()
                starts = rng.integers(0, rows - L + 1, size=B)
                idxs = db.indices_to_device(starts[:, None] + np.arange(L),
                                            dev)
                metrics = train_step(arrays, idxs, draws.draw(), gen)
                if step == 3:
                    saver.save(tmp, step, model, optimizer, scheduler, {})
                if pending is not None:    # read back a step late, as the loop
                    losses.append(float(pending))
                pending = metrics["loss"]
                seconds.append(time.perf_counter() - t0)
            losses.append(float(pending))
            saver.wait()
        except torch.cuda.OutOfMemoryError as e:
            record["oom"] = f"step {step}: {e}"[:400]
        free1, _ = torch.cuda.mem_get_info(dev)
        peak = torch.cuda.max_memory_reserved(dev)
        # memory outside PyTorch's allocator (context, library handles and
        # workspaces) before the budget was taken and after the steps
        outside0 = total - free0 - reserved0
        outside1 = total - free1 - torch.cuda.memory_reserved(dev)
        need = peak - reserved0 - replay + max(0, outside1 - outside0)
        record.update({
            "budget_GiB": budget / gib, "replay_GiB": replay / gib,
            "rows": int(rows), "total_GiB": total / gib,
            "reserved_before_GiB": reserved0 / gib,
            "max_allocated_GiB": torch.cuda.max_memory_allocated(dev) / gib,
            "max_reserved_GiB": peak / gib,
            "outside_allocator_before_GiB": outside0 / gib,
            "outside_allocator_after_GiB": outside1 / gib,
            # what the reserve has to hold: the step's and the snapshot's
            # peak beyond the replay and what was held when the budget was
            # taken, plus the memory outside the allocator that appeared
            # after it
            "need_GiB": need / gib, "margin_GiB": (reserve - need) / gib,
            "step_seconds": seconds, "losses": losses})
    return record


def phase_budget(runs=((None, ()),)):
    """``budget_run`` in a fresh process for each (reserve, overrides)
    (reserve None: the port's ``step_reserve_bytes``).  Raises on an
    out-of-memory or a non-finite loss."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()   # this process's cached blocks back to the card
    for reserve, overrides in runs:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--budget-run",
             "" if reserve is None else str(reserve), *overrides],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"budget run failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        record = {"phase": "budget",
                  **json.loads(proc.stdout.strip().splitlines()[-1])}
        emit(record)
        if record["oom"] or not all(math.isfinite(x)
                                    for x in record["losses"]):
            raise AssertionError(f"budget: {record['oom']} losses "
                                 f"{record['losses']}")


def card_against_cpu(overrides, L: int, B: int = 2, seed: int = 0):
    """The same weights on the card and on the CPU, float32, TF32 off,
    deterministic (generator=None), batch B x chunk L at full width: loss,
    every metric and the gradient norms of one step (over
    ``train.grad_accum`` micro-batches), on random inputs of every
    modality the configuration names.  Returns (cpu, card, max relative
    error, the metrics outside PARITY_RTOL)."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops.image import normalize_image_deterministic
    from multimodal_rssm_torch.train import trainer as tr

    cfg = compose(overrides=["train.use_amp=False", f"train.chunk_size={L}",
                             *overrides])
    rng = np.random.default_rng(seed)
    shapes = cfg.env.observation_shapes
    obs = {}
    for name in sorted(set(cfg.rssm.observation_names_enc)
                       | set(cfg.rssm.observation_names_rec)):
        c, *hw = shapes[name]
        obs[name] = (rng.integers(0, 256, (L, B, *hw, c), np.uint8)
                     if "image" in name else
                     rng.normal(size=(L, B, *shapes[name])).astype(np.float32))
    raw = (obs, rng.normal(size=(L, B, 3)).astype(np.float32),
           rng.normal(size=(L, B)).astype(np.float32),
           np.ones((L, B, 1), np.float32))
    cpu_model = WorldModel.from_config(cfg)
    init_parameters(cpu_model, torch.Generator().manual_seed(seed))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    accum = tr.resolve_grad_accum(cfg)

    def run(model, dev):
        obs, act, rew, nt = raw
        obs = {k: (normalize_image_deterministic(
                       torch.from_numpy(v).to(dev), BIT_DEPTH)
                   if "image" in k else torch.from_numpy(v).to(dev))
               for k, v in obs.items()}
        batch = (obs, torch.from_numpy(act).to(dev),
                 torch.from_numpy(rew).to(dev), torch.from_numpy(nt).to(dev))
        metrics = tr.accumulated_backward(tr.make_loss_fn(model, cfg), model,
                                          batch, None, accum)
        metrics.update(tr.grad_norms(model))
        return {k: float(v) for k, v in metrics.items()}

    cpu = run(cpu_model, torch.device("cpu"))
    gpu = run(gpu_model, torch.device("cuda"))
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    bad = {k: (cpu[k], gpu[k]) for k, r in rel.items()
           if r > PARITY_RTOL and abs(gpu[k] - cpu[k]) > 1e-6}
    return cpu, gpu, max(rel.values()), bad


def phase_parity():
    L, B = 4, 2
    cpu, gpu, max_rel, bad = card_against_cpu([], L, B)
    emit({"phase": "parity", "batch": B, "chunk": L, "rtol": PARITY_RTOL,
          "max_rel_err": max_rel, "cpu": cpu, "cuda": gpu})
    if bad:
        raise AssertionError(f"card and CPU disagree: {bad}")


def phase_variants(tmp: str, device_name: str) -> dict:
    """The RSSM's model variants on the card (``VARIANT_RUNS``): each
    trains VARIANT_STEPS steps and one validation at full width through the
    train CLI (finite metrics, the step count, K1 once per train and
    validation step; steps/s, the median of the steps after the first two;
    peak memory), overshooting at the whole chunk (D = 50) unless that runs
    out of memory, then smaller; every variant and NN fusion on the card
    against the CPU (``card_against_cpu``, chunk 6); ``estimate_state`` and
    ``check_model`` on the unimodal and the categorical runs' last
    checkpoint (K1 once per episode, finite imagination MSE / PSNR, the
    experts each has).  Returns K1's launches by path."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.cli import check_model, estimate_state
    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.models.world_model import effective_state_size
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    write_dataset(tmp, 4)
    n_epi = 4
    common = [f"train.train_iteration={VARIANT_STEPS}",
              f"train.validation_interval={VARIANT_STEPS}"]
    runs, launches, run_dirs = {}, {}, {}
    for name, overrides in VARIANT_RUNS.items():
        extra = [*overrides, f"main.experiment_name=variant_{name}"]
        if name in VARIANT_EVAL:
            extra.append(f"train.checkpoint_interval={VARIANT_STEPS}")
        distances = OVERSHOOT_D if name == "overshoot" else (None,)
        oom = []
        for d in distances:
            args = [*common, *extra] + (
                [] if d is None else [f"rssm.overshooting_distance={d}"])
            try:
                rec, result, counts = train_run(
                    f"variants/{name}", tmp, args, VARIANT_STEPS,
                    "device_resident")
            except torch.cuda.OutOfMemoryError as e:
                oom.append({"distance": d, "max_memory_allocated_GiB":
                            torch.cuda.max_memory_allocated() / 2 ** 30,
                            "error": str(e)[:300]})
                emit({"phase": f"variants/{name}", "note": "out of memory",
                      **oom[-1]})
                continue
            break
        else:
            raise AssertionError(f"variants/{name}: no distance fits: {oom}")
        want = VARIANT_STEPS + 1   # one image modality: one K1 per step
        if counts["normalize_image"] != want:
            raise AssertionError(f"variants/{name}: K1 launched "
                                 f"{counts['normalize_image']} times, not "
                                 f"{want}")
        after = result["step_seconds"][2:]
        runs[name] = {
            "overrides": args[len(common):],
            "steps_per_s_median_after_2": 1.0 / statistics.median(after),
            "max_memory_allocated_GiB": rec["max_memory_allocated_GiB"],
            "step_seconds": rec["step_seconds"],
            "loss": rec["loss"], "validation_loss": rec["validation_loss"],
            "out_of_memory_at": oom}
        launches[name] = counts["normalize_image"]
        run_dirs[name] = result["results_dir"]
        del result

    parity = {}
    for name, overrides in VARIANT_PARITY.items():
        _, _, max_rel, bad = card_against_cpu(overrides, 6)
        parity[name] = max_rel
        if bad:
            raise AssertionError(f"variants/{name}: card and CPU disagree: "
                                 f"{bad}")

    evals = {}
    for name in VARIANT_EVAL:
        run_dir = run_dirs[name]
        ck.reset_launch_counts()
        saved = estimate_state.main(["--targets", os.path.dirname(run_dir),
                                     "--itr", str(VARIANT_STEPS), "--cwd",
                                     tmp])
        est = ck.launch_counts()["normalize_image"]
        states = np.load(saved[0], allow_pickle=True).item()
        width = effective_state_size(load_run_config(run_dir))  # 1024, 128
        bad = [k for k, s in states.items()
               if s["posterior_means"].shape != (EVAL_T - 1, 1, width)
               or ("expert_logits" in s) != (name == "categorical")
               or not _all_finite(s)]
        ck.reset_launch_counts()
        report = check_model.main(["--run", run_dir, "--itr",
                                   str(VARIANT_STEPS), "--t-start",
                                   str(EVAL_T_START), "--horizon",
                                   str(EVAL_HORIZON), "--cwd", tmp])
        chk = ck.launch_counts()["normalize_image"]
        has_experts = "expert_distributions.npy" in report["files"]
        if (len(saved) != 1 or len(states) != n_epi or bad
                or est != n_epi or chk != n_epi
                or has_experts != (name == "categorical")
                or not _all_finite(report["mse"])
                or not _all_finite(report["metrics"])):
            raise AssertionError(f"variants/{name} eval: {saved}, states "
                                 f"wrong or not finite for {bad}; K1 "
                                 f"{est} / {chk}; {report}")
        evals[name] = {"mse": report["mse"], "metrics": report["metrics"],
                       "launches": {"estimate_state": est,
                                    "check_model": chk}}
    record = {"phase": "variants", "device": device_name,
              "batch": SHAPE[1], "chunk": SHAPE[0], "steps": VARIANT_STEPS,
              "runs": runs, "card_vs_cpu_max_rel": parity,
              "card_vs_cpu_rtol": PARITY_RTOL, "eval": evals,
              "wall_seconds": time.perf_counter() - t_phase}
    emit(record)
    by_path = {f"variants/{k}": v for k, v in launches.items()}
    for name, e in evals.items():
        for cli, n in e["launches"].items():
            by_path[f"variants/{name}/{cli}"] = n
    return by_path


def k1_at_codec_shapes(device_name: str) -> dict:
    """K1 at the larger image codecs' train shapes (``K1_SHAPES``): equal to
    its plain version, and its device time from a CUDA graph (10 calls at
    128 px, 4 at 256 px: each graph call holds its own output) against its
    bytes bound; the plain version's time by CUDA events."""
    import torch

    from multimodal_rssm_torch.core.device import cuda_time_ms
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    dev = torch.device("cuda")
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    out = {}
    for shape in K1_SHAPES:
        g = torch.Generator(dev).manual_seed(1)
        x = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8).float()
        got = ck.normalize_image(x, BIT_DEPTH, seed)
        want = ck.normalize_image_plain(x, BIT_DEPTH, seed)
        equal = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        del got, want
        if not equal:
            raise AssertionError(f"K1 at {shape}: kernel != plain version, "
                                 f"max |diff| {err}")
        ms = graph_time_ms(lambda: ck.normalize_image(x, BIT_DEPTH, seed),
                           10 if shape[2] == 128 else 4)
        plain_ms = cuda_time_ms(
            lambda: ck.normalize_image_plain(x, BIT_DEPTH, seed), 2,
            warmup=1)
        n = x.numel()
        bound = n * 8 / hbm_rate(device_name) * 1e3
        out[str(shape[2])] = {"shape": list(shape), "exact": equal,
                              "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound,
                              "bound_by": "bytes"}
        del x
        torch.cuda.empty_cache()
    emit({"phase": "codecs_k1", "device": device_name, **out})
    return out


def phase_codecs(tmp: str, device_name: str, default: dict) -> dict:
    """The world model's remaining codecs and training options on the card
    (``CODEC_RUNS``): each trains CODEC_STEPS steps and one validation at
    full width through the train CLI (finite metrics, the step count, K1
    exactly once per train and validation step and non-bin image modality;
    steps/s, the median of the steps after the first two without the
    validating last; peak memory), a
    run that runs out of memory at batch 50 retried at ``CODEC_ACCUM``; each
    on the card against the CPU (``card_against_cpu``, chunk 6);
    ``estimate_state`` and ``check_model`` on the 128 px + pose run's last
    checkpoint (K1 once per episode, image grids and SSIM only for the
    image); K1 at the 128 px and 256 px shapes.  ``default``: phase train's
    record in this call, the reference for steps/s and peak memory.
    Returns (K1's launches by path, K1's codec-shape record)."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.cli import check_model, estimate_state
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    write_dataset(tmp, 4, CODEC_SHAPES)
    common = [f"train.train_iteration={CODEC_STEPS}",
              f"train.validation_interval={CODEC_STEPS}"]
    runs, launches, run_dirs = {}, {}, {}
    for name, overrides in CODEC_RUNS.items():
        extra = [*overrides, f"main.experiment_name=codec_{name}"]
        if name == CODEC_EVAL:
            extra.append(f"train.checkpoint_interval={CODEC_STEPS}")
        oom = []
        for accum in (None, *CODEC_ACCUM):
            args = [*common, *extra] + (
                [] if accum is None else [f"train.grad_accum={accum}"])
            try:
                rec, result, counts = train_run(
                    f"codecs/{name}", tmp, args, CODEC_STEPS,
                    "device_resident")
            except torch.cuda.OutOfMemoryError as e:
                oom.append({"grad_accum": accum, "max_memory_allocated_GiB":
                            torch.cuda.max_memory_allocated() / 2 ** 30,
                            "error": str(e)[:300]})
                emit({"phase": f"codecs/{name}", "note": "out of memory",
                      **oom[-1]})
                continue
            break
        else:
            raise AssertionError(f"codecs/{name}: no grad_accum fits: {oom}")
        model = result["model"]
        n_images = sum(1 for n in set(model.observation_names_enc)
                       | set(model.observation_names_rec)
                       if "image" in n and "bin" not in n)
        want = (CODEC_STEPS + 1) * n_images   # one K1 per step and image
        del model
        if counts["normalize_image"] != want:
            raise AssertionError(f"codecs/{name}: K1 launched "
                                 f"{counts['normalize_image']} times, not "
                                 f"{want}")
        runs[name] = {
            "overrides": args[len(common):],
            # the steps after the first two, without the validating last
            "steps_per_s": rec["median_steps_per_s_after_warmup"],
            "max_memory_allocated_GiB": rec["max_memory_allocated_GiB"],
            "x_default_steps_per_s": rec["median_steps_per_s_after_warmup"]
            / default["median_steps_per_s_after_warmup"],
            "x_default_peak": rec["max_memory_allocated_GiB"]
            / default["max_memory_allocated_GiB"],
            "step_seconds": rec["step_seconds"],
            "loss": rec["loss"], "validation_loss": rec["validation_loss"],
            "out_of_memory_at": oom}
        launches[name] = counts["normalize_image"]
        run_dirs[name] = result["results_dir"]
        del result
    torch.cuda.empty_cache()

    parity = {}
    for name, overrides in CODEC_RUNS.items():
        cpu, gpu, max_rel, bad = card_against_cpu(overrides, 6)
        worst = max(cpu, key=lambda k: abs(gpu[k] - cpu[k])
                    / max(abs(cpu[k]), 1e-12))
        parity[name] = {"max_rel": max_rel, "metric": worst,
                        "cpu": cpu[worst], "cuda": gpu[worst]}
        if bad:
            raise AssertionError(f"codecs/{name}: card and CPU disagree: "
                                 f"{bad}")

    run_dir, n_epi = run_dirs[CODEC_EVAL], 4
    ck.reset_launch_counts()
    saved = estimate_state.main(["--targets", os.path.dirname(run_dir),
                                 "--itr", str(CODEC_STEPS), "--cwd", tmp])
    est = ck.launch_counts()["normalize_image"]
    states = np.load(saved[0], allow_pickle=True).item()
    names = {"image_horizon_128", "sound", "pose_quat_v2"}
    bad = [k for k, st in states.items()
           if st["posterior_means"].shape != (EVAL_T - 1, 1, 128)
           or set(st["expert_means"]) != {"prior_expert", *names}
           or not _all_finite(st)]
    ck.reset_launch_counts()
    report = check_model.main(["--run", run_dir, "--itr", str(CODEC_STEPS),
                               "--t-start", str(EVAL_T_START), "--horizon",
                               str(EVAL_HORIZON), "--cwd", tmp])
    chk = ck.launch_counts()["normalize_image"]
    grids = sorted(os.path.splitext(f)[0] for f in report["files"]
                   if f.startswith(("reconstruction_", "imagination_"))
                   and not f.endswith(".json"))
    if (len(saved) != 1 or len(states) != n_epi or bad or est != n_epi
            or chk != n_epi or set(report["metrics"]) != names
            or grids != ["imagination_image_horizon_128",
                         "reconstruction_image_horizon_128"]
            or "ssim" not in report["metrics"]["image_horizon_128"]
            or any("ssim" in report["metrics"][n]
                   for n in ("sound", "pose_quat_v2"))
            or not _all_finite(report["metrics"])):
        raise AssertionError(f"codecs/{CODEC_EVAL} eval: {saved}, states "
                             f"wrong or not finite for {bad}; K1 {est} / "
                             f"{chk}; grids {grids}; {report}")
    k1 = k1_at_codec_shapes(device_name)
    record = {"phase": "codecs", "device": device_name,
              "batch": SHAPE[1], "chunk": SHAPE[0], "steps": CODEC_STEPS,
              "default": {k: default[k] for k in (
                  "median_steps_per_s_after_warmup",
                  "max_memory_allocated_GiB")},
              "runs": runs, "card_vs_cpu_max_rel": parity,
              "card_vs_cpu_rtol": PARITY_RTOL,
              "eval": {"run": CODEC_EVAL, "mse": report["mse"],
                       "metrics": report["metrics"],
                       "launches": {"estimate_state": est,
                                    "check_model": chk}},
              "wall_seconds": time.perf_counter() - t_phase}
    emit(record)
    by_path = {f"codecs/{k}": v for k, v in launches.items()}
    by_path[f"codecs/{CODEC_EVAL}/estimate_state"] = est
    by_path[f"codecs/{CODEC_EVAL}/check_model"] = chk
    return by_path, k1


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
    launches, default = phase_train()
    phase_feed(name)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = phase_checkpoint(tmp)
        eval_k1 = phase_eval(tmp, run_dir, name)
        control_k1 = phase_control(tmp, run_dir, name)
        bridges_k1 = phase_bridges(tmp, run_dir, name)
    phase_budget(((None, ()), (None, tuple(CODEC_RUNS["img256_groupnorm"]))))
    phase_parity()
    with tempfile.TemporaryDirectory() as tmp:
        variants_k1 = phase_variants(tmp, name)
    with tempfile.TemporaryDirectory() as tmp:
        codecs_k1, k1_shapes = phase_codecs(tmp, name, default)
    fused = phase_fused_codec(name, launches)
    kernel["launches"] = launches["normalize_image"]
    kernel["launches_by_path"] = {
        "train": launches["normalize_image"],
        "estimate_state": eval_k1["estimate_state"],
        "check_model": eval_k1["check_model"], **control_k1["launches"],
        **bridges_k1, **variants_k1, **codecs_k1}
    kernel["eval_episode_shape_ms"] = eval_k1["episode_shape_ms"]
    kernel["agent_frame_shape"] = control_k1["frame_shape"]
    kernel["codec_shapes"] = k1_shapes
    emit({"kernels": [kernel, *fused]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--budget-run"]:   # phase_budget's fresh process
        sys.path.insert(0, REPO)
        arg = sys.argv[2] if len(sys.argv) > 2 else ""
        emit(budget_run(int(arg) if arg else None, sys.argv[3:]))
        sys.exit(0)
    sys.exit(main())
