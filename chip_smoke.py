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
3-. precision -- the mixed precision a run ships (train.use_amp=true):
               for the default configuration, categorical latents and the
               64 px GroupNorm codec at full width, one loss step at batch
               2 x chunk 4 with K1 normalising the images; every layer's
               output dtype and every forward output's dtype equal to the
               JAX package's, name for name (the committed
               tests/torch_port_fixtures/dtype_map.json), every gradient
               float32, K1 once each; any difference fails the run; then
               the sound encoder's conv-weight gradient norms, bf16 over
               float32, of one deterministic loss step of the default at
               full width (batch 4 x chunk 6, the same weights and batch),
               each inside SCALE_BAND (python3 chip_smoke.py --precision:
               the build and this phase alone);
3a. parallel -- data parallelism (train.mesh): the train CLI at
               train.mesh.data=1 (a one-rank NCCL world in process) after
               the mesh-less CLI, 12 steps each (steps/s over
               steps 3-9, peak memory, K1 once per step; the second run
               traces steps 10-12: NCCL's kernels and the device work
               inside the all-reduce spans a step); K1 on rank 1's shard
               of the main-path batch (row map; grad_accum 1 and 5)
               bit-equal to its plain version and to the global draw's
               rows, timed against the unmapped call; two ranks (NCCL on
               two cards where there are two, else sharing this card over
               gloo) launched through parallel.launch.spawn: each rank's
               float32 step on its rows held against a one-rank step on the
               same global batch of 10 rows (the JAX package's DP
               tolerance, the ranks bit-equal), then 4 bf16 steps and a
               validation through
               train.loop.run (steps/s, each rank's peak memory, K1 5
               times a rank, one run dir); the model axis
               (train.mesh.model, phase_model_axis): (c) data=1 x model=2,
               two ranks the same way, the float32 step on the whole
               global batch (10 of the 50 rows: two ranks each holding
               every row fit no more) held against one rank at the JAX
               package's model-axis tolerance (the ranks' whole weights
               bit-equal, each rank's blocks its columns of the whole),
               then 3 bf16 steps and a validation at batch 50 x chunk 10
               through train.loop.run (steps/s, peak memory, K1 4 times a
               rank; under --model-axis also one traced step: model-group
               collectives and the model_parallel spans' ms a step);
               (d) data=2 x model=2
               through the train CLI, four ranks joined as torchrun joins
               them (over gloo on one card: more ranks than cards), batch
               8 x chunk 10, in two worlds of four fresh processes: the
               5-step run in one; in the other 3 steps, then --resume to 5
               as a second CLI call of the same processes (everything
               built anew from the checkpoint file), bit-equal to the
               5-step run; each rank's staged digests at steps 1-3
               (parallel/digests.py: the weights as placed, the step's
               inputs and forward, its kernels, every gradient after the
               backward, the data group's average and the broadcast, and
               the GRU's input-to-hidden product's operands at every RSSM
               step; where the two worlds part: rank, stage, step and
               tensor or kernel, F6); the checkpoint whole and read
               mesh-less by the check_model CLI (`python3 chip_smoke.py
               --model-axis` runs the build and (c), (d) alone;
               `--recompute-step [arm ...]` is F6's harness: fresh
               data=2 x model=2 worlds of (d)'s CLI for one step ("cli",
               "cli+flag", "cli+fill"), of the step without the CLI
               ("fresh") or of the weights' placement alone
               ("place+fresh"; "place": repeated in one world), compared
               world against world with the staged digests;
               `--init-draws` reads the first parameter draw of fresh
               processes, F6's cause);
3b. feed    -- the same CLI on a dataset of a real set's size (360 x 120
               episodes, 43,200 rows, 0.97 GB; experience_size to match),
               5 steps a run, with train.device_replay=true (the whole
               replay on the card), =stream (train.replay_budget_gb=0.5: a
               working set of 119 of 216 segments, one replaced a step) and
               =false (host batches behind the prefetch thread), one run
               each in that order; then at that
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
3f. control -- on 3c's run (models_6.pt) at full width, the world model
               in bf16 (train.use_amp), the heads in f32: the
               train_behavior CLI
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
               30, train.experience_size=2000 in place of 500,000, a cut of
               the ring's 11 GB address-space reservation that changes no
               work, as sampling stays within the 120 rows written; the
               shipped train.pallas_normalize=false: the checkpoints at the
               top and under behavior/, K1 once per world-model step,
               behavior step and collected frame, wall seconds); and
               K1 at [1, 1, 64, 64, 3], bit-equal, its graph device time
               against its bytes bound;
3g. bridges -- a user's files in and out, at full width, in 3c's temp dir:
               3 raw recordings of 60 frames of 480 x 640 (sound,
               pose_quat, servo_value) built by data/dataset_builder
               (binary channels; host s per episode); the train CLI on the
               built set, 16 steps (batch 50 x chunk 50, bf16, K1 on) with
               train.histogram_interval=4 and main.wandb=true (a stub
               wandb module) and 16 with train.profile_dir (the trace of
               steps 10-15, K1 in it as often as its wrapper counted it
               in the window), composed from a copy of the config tree
               whose root is bridges.yaml ($MRSSM_CONFIG_DIR,
               --config-name bridges), under deterministic cuDNN:
               every tensor of the two models bit-equal, the histogram
               lines, every record mirrored to the stub (one init with
               the run's name, project, config, tags and dir; one
               finish), both runs' metrics.jsonl lines in the JAX loop's
               order with frame = step x 50 x 50, the trace, K1 once per
               step, validation and histogram pass, a step's s with and
               without a histogram pass (and the pass's logging half),
               the profiled steps' s;
               collect_sim_data --env synthetic (2 episodes, loaded by the
               train CLI's loader); export_torch of 3c's models_6.pt to a
               reference .pth, then train.model_path on it for 1 step (the
               loaded weights bit-equal to the .pt's, K1 launched); the
               JAX package's .msgpack fixture (tests/torch_port_fixtures/)
               through the port's reader onto the card: its det estimate
               and one deterministic step from it (train.model_path)
               within PARITY_RTOL |want| + EVAL_ATOL of the JAX package's
               stored values, and the reader's MB/s;
3h. serve   -- serving on 3c's run (models_6.pt, full width, trained in
               bf16) with 3f's behavior/ checkpoint: the export_model CLI
               (all four artifacts at batch 1, --plan with
               rssm.predict_reward=true and 2 CEM iterations of 10: the
               export traces each; seconds per artifact, .pt2 bytes;
               the world model in float32, as the JAX package exports
               it), each artifact loaded (seconds) and held against the
               eager float32 port on the same raw frame and key
               (filter_step and decode within 1e-5 of max |eager|; the
               agent's and CEM's actions from the key's noise), served
               over HTTP (a 3-frame streaming carry equal to the direct
               calls; 400 for a missing input and an unknown artifact, 404
               for an unknown path), ms per call at batch 1 direct and over
               HTTP (median of 10 after 3, timed once the learning gate of
               6, which runs beside the export and the checks, has ended),
               and no kernel launched;
3d. budget  -- in a fresh process, as the CLI starts, for the default
               configuration and for the 256 px GroupNorm one: a
               device-resident replay as large as hbm_budget_bytes allows
               at the configuration's reserve (step_reserve_bytes; rows
               tiled from a small dataset), 4 full-width steps with an
               async checkpoint after step 2: no out-of-memory, finite
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
               time from a CUDA graph against the bytes bound; and, for
               the 256 px GroupNorm and the default configuration, where
               the card and the CPU part (codecs/f3: every module's output
               and every gradient, card against CPU, in call order);
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

5b. tools  -- the measurement CLIs in process at full width (batch 50 x
               chunk 50, bf16, K1 on through train.pallas_normalize=auto),
               the launch counts reset before each: op_profile (2 traced
               steps after 3 warm-up: the kernels' self time by category,
               K1 under hand-written once a traced step and as often as
               its wrapper counted it in the window, the device's idle
               share), profile_step (2 timed and 2 traced steps after 1
               warm-up: K1 in its trace as often as its wrapper counted it
               in the window), micro_bench (the six codec cases' fwd and
               fwd+bwd ms), profile_host_feed (each host-feed component, 2
               calls each), sweep_perf (poe, 2 steps, no row
               FAILED) and bench_scaling (1x1, 2 steps); K1 once per step
               of each tool that steps; in a process of its own
               (`python3 chip_smoke.py --tools`, which builds the
               libraries that are missing or stale and runs this phase
               alone; `--profiler-edges` times the profiler's window
               edges against the kernels launched at them);

6. quality -- the learning gate (cli/quality_gate.py), in processes of
               its own beside 3h's export and checks (the card nearly idle
               there): the default configuration, seed 0, 300 iterations
               at batch 8 x chunk 20 through the port's CLIs, every metric
               inside the committed cuda window, the JAX package's tpu
               window read beside it; its line comes before 3h's.

Every phase's line carries its wall_seconds.  Then a "total" line (the
script's seconds and each phase's), the {"kernels": [...]} line, the card's
name and power limit, and as the last line {"ok": true, "device": {...}}.
Without a GPU it exits non-zero and prints no result.  A failing phase
raises.
"""

from __future__ import annotations

import collections
import contextlib
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
# the JAX package's dtype maps (tests/test_torch_port_precision.py writes
# them) and the batch phase precision records the port's at
PRECISION_FIXTURE = os.path.join(REPO, "tests", "torch_port_fixtures",
                                 "dtype_map.json")
PRECISION_L, PRECISION_B = 4, 2
# phase precision's sound-encoder reading: the chunk and batch of the CPU
# bf16 step (tests/test_torch_port_precision.py), and the band every conv
# weight's bf16 / float32 gradient norm must lie in.  On the CPU (SMALL
# widths, default seeds 0-17) the ratio of either package strays from 1 by
# at most 0.06; full width was not read there, hence the margin.
SCALE_L, SCALE_B = 6, 4
SCALE_BAND = (0.90, 1.10)
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


def phase_build(force: bool = True):
    """Compile every kernel library (``force``: even those up to date)."""
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    libs, seconds, log = ck.build(force=force)
    ptxas = [line.strip() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build",
          "libraries": {k: os.path.relpath(v, REPO) for k, v in libs.items()},
          "seconds": seconds, "ptxas": ptxas,
          "wall_seconds": time.perf_counter() - t0})


def phase_kernel(device_name: str):
    import torch

    from multimodal_rssm_torch.core.device import cuda_time_ms
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.ops.image import normalize_image_deterministic

    t_phase = time.perf_counter()
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
          "achieved_GBps": n * 8 / (kernel_ms * 1e-3) / 1e9,
          "wall_seconds": time.perf_counter() - t_phase})
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


def precision_map(overrides, device: str = "cuda", seed: int = 0):
    """The port's dtype map of one train-mode loss step on the card under
    ``train.use_amp=true`` (``models/dtype_map.py``), at full width with
    ``overrides``, batch PRECISION_B x chunk PRECISION_L (a dtype does not
    depend on the batch), the images normalised through K1 as the train
    step's ``prepare_observations`` does with ``train.pallas_normalize``:
    (the map, the gradients' dtypes, K1's launches, the loss)."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models import dtype_map as dm
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.train import trainer as tr

    dev = torch.device(device)
    L, B = PRECISION_L, PRECISION_B
    cfg = compose(overrides=[*overrides, "train.use_amp=true",
                             "train.pallas_normalize=true"])
    model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    rng = np.random.default_rng(seed)
    raw = {"image_horizon": torch.from_numpy(rng.integers(
               0, 256, (L, B, *SHAPE[2:]), np.uint8)).to(dev),
           "sound": torch.from_numpy(rng.normal(size=(L, B, 128, 20)).astype(
               np.float32)).to(dev)}
    spec = tr.AugSpec(modalities=(("image_horizon", tr.ModalityAugSpec(
        SHAPE[2:4], False, False, False, True)),))
    g = torch.Generator(dev).manual_seed(seed)
    ck.reset_launch_counts()
    obs = tr.prepare_observations(raw, spec, {}, BIT_DEPTH, g,
                                  kernel_normalize=True)
    batch = (obs, torch.from_numpy(rng.uniform(-1, 1, (L, B, 3)).astype(
                 np.float32)).to(dev),
             torch.from_numpy(rng.normal(size=(L, B)).astype(
                 np.float32)).to(dev), torch.ones(L, B, 1, device=dev))
    got, grads, loss = dm.loss_step_map(model, cfg, batch, g)
    return got, grads, ck.launch_counts()["normalize_image"], loss


def sound_encoder_scale(device: str = "cuda", seed: int = 0) -> dict:
    """({sound encoder conv weight: |bf16 gradient| / |float32 gradient|}
    (L2 norms) of one deterministic loss step of the default configuration
    at full width, batch SCALE_B x chunk SCALE_L, in each precision from
    the same weights and batch (the port against itself), K1's launches
    normalising the images)."""
    import numpy as np
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.train import trainer as tr

    dev = torch.device(device)
    L, B = SCALE_L, SCALE_B
    rng = np.random.default_rng(seed)
    raw = {"image_horizon": torch.from_numpy(rng.integers(
               0, 256, (L, B, *SHAPE[2:]), np.uint8)).to(dev),
           "sound": torch.from_numpy(rng.normal(size=(L, B, 128, 20)).astype(
               np.float32)).to(dev)}
    spec = tr.AugSpec(modalities=(("image_horizon", tr.ModalityAugSpec(
        SHAPE[2:4], False, False, False, True)),))
    ck.reset_launch_counts()
    obs = tr.prepare_observations(raw, spec, {}, BIT_DEPTH,
                                  torch.Generator(dev).manual_seed(seed),
                                  kernel_normalize=True)
    k1 = ck.launch_counts()["normalize_image"]
    batch = (obs, torch.from_numpy(rng.uniform(-1, 1, (L, B, 3)).astype(
                 np.float32)).to(dev),
             torch.from_numpy(rng.normal(size=(L, B)).astype(
                 np.float32)).to(dev), torch.ones(L, B, 1, device=dev))
    norms, weights = {}, None
    for amp in (False, True):
        cfg = compose(overrides=[f"train.use_amp={str(amp).lower()}"])
        model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
        if weights is None:
            init_parameters(model, torch.Generator().manual_seed(seed))
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        model.to(dev)
        loss, _ = tr.make_loss_fn(model, cfg)(batch, None, True)
        loss.backward()
        norms[amp] = {n: float(p.grad.double().norm())
                      for n, p in model.named_parameters()
                      if n.startswith("encoder.sound.")
                      and n.endswith(".0.weight")}
        del model, loss
    return {n: norms[True][n] / norms[False][n] for n in norms[False]}, k1


def phase_precision() -> dict:
    """Mixed precision on the card: for each configuration of the committed
    JAX dtype map (PRECISION_FIXTURE: the default, categorical latents,
    the 64 px GroupNorm codec), the port's layer dtype map under
    ``train.use_amp=true`` at full width (``precision_map``) equal to the
    JAX package's name for name, every gradient float32, K1 launched once,
    a finite loss; then ``sound_encoder_scale`` inside SCALE_BAND, K1
    launched once.  Any difference fails the run.  Returns K1's launches
    by configuration and reading."""
    from multimodal_rssm_torch.models import dtype_map as dm

    t0 = time.perf_counter()
    with open(PRECISION_FIXTURE) as f:
        fixture = json.load(f)
    record = {"phase": "precision", "batch": [PRECISION_L, PRECISION_B],
              "configs": {}}
    launches, bad = {}, []
    for name, want in fixture["configs"].items():
        got, grads, k1, loss = precision_map(want["overrides"])
        diff = dm.mismatches(got, want)
        record["configs"][name] = {
            "layers": len(got["layers"]), "outputs": len(got["outputs"]),
            "layer_dtypes": sorted({d for v in got["layers"].values()
                                    for d in v}),
            "gradient_dtypes": grads, "k1_launches": k1, "loss": loss,
            "mismatches": diff}
        launches[f"precision/{name}"] = k1
        if diff or grads != ["float32"] or k1 != 1 or not math.isfinite(loss):
            bad.append(name)
    record["seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    scale, k1 = sound_encoder_scale()
    record["sound_encoder_scale"] = {
        "ratios": scale, "band": list(SCALE_BAND), "batch": [SCALE_L, SCALE_B],
        "k1_launches": k1, "seconds": time.perf_counter() - t1}
    launches["precision/sound_encoder_scale"] = k1
    outside = {n: r for n, r in scale.items()
               if not SCALE_BAND[0] <= r <= SCALE_BAND[1]}
    record["wall_seconds"] = time.perf_counter() - t0
    emit(record)
    if bad:
        raise AssertionError(f"precision: the card's dtype map, gradients "
                             f"or K1 launches differ for {bad}")
    if outside or not scale or k1 != 1:
        raise AssertionError(f"precision: the sound encoder's bf16 / float32 "
                             f"gradient norms {outside or scale} outside "
                             f"{SCALE_BAND}, or K1 launched {k1} times")
    return launches


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
FEED_STEPS = 5   # short runs: the whole script must stay inside its limit
FEED_STREAM_GB = 0.5
# train.device_replay, feed: one run each (earlier versions ran each twice,
# in mirrored order; no feed was faster than the spread between two runs of
# one, and the script needed the time)
FEED_ORDER = (("true", "device_resident"), ("stream", "stream"),
              ("false", "host"))


def phase_feed(device_name: str):
    """The three feeds through the CLI on a dataset of a real set's size,
    FEED_STEPS steps each, one run a feed; then the load and
    one batch's gather at that size, on the host and on the card."""
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import cuda_time_ms
    from multimodal_rssm_torch.data import buffer
    from multimodal_rssm_torch.data import device_buffer as db
    from multimodal_rssm_torch.data.native import (gather_chunks,
                                                   gather_chunks_plain)

    t_phase = time.perf_counter()
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
    emit({"phase": "feed_gather",
          "wall_seconds": time.perf_counter() - t_phase, "batch": B,
          "chunk": L, "rows": rows,
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

    t_phase = time.perf_counter()
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
    emit({"phase": "checkpoint_save",
          "wall_seconds": time.perf_counter() - t_phase,
          "restored_bit_equal": True,
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


ONLINE_ENV_LENGTH = 30
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


BRIDGE_EPISODES = 3          # raw recordings: 2 train + 1 validation
BRIDGE_T = 60                # frames a recording
BRIDGE_FRAME = (480, 640)    # a VGA camera, resized to 256 / 128 / 64
BRIDGE_STEPS = 16            # the profiler's window is steps 10-15
BRIDGE_HIST = 4              # train.histogram_interval
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


class StubWandb:
    """A ``wandb`` module for ``sys.modules`` (the card's machine has no
    wandb and no network): records ``init`` / ``log`` / ``Histogram`` /
    ``finish`` and the seconds spent in them."""

    class Histogram:
        def __init__(self, np_histogram=None):
            self.np_histogram = np_histogram

    def __init__(self):
        import types

        self.calls = {"init": [], "log": [], "finish": 0}
        self.seconds = 0.0
        self.module = types.ModuleType("wandb")
        self.module.init = self._timed(
            lambda **kw: self.calls["init"].append(kw))
        self.module.log = self._timed(
            lambda metrics, step=None: self.calls["log"].append(
                (dict(metrics), step)))
        self.module.Histogram = self._timed(StubWandb.Histogram)
        self.module.finish = self._timed(self._finish)

    def _finish(self):
        self.calls["finish"] += 1

    def _timed(self, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
        return call


def _line_kind(r: dict) -> tuple:
    """(kind, step) of a metrics.jsonl line: train / validation / perf,
    frame, or params / grads for a histogram line."""
    if "frame" in r:
        return "frame", r["step"]
    hist = [k for k in r if k.endswith("/hist")]
    if hist:
        return hist[0].split("_", 1)[0], r["step"]
    return next(k.split("/")[1] for k in r if "/" in k), r["step"]


def jax_line_order(steps: int, val_every: int, hist_every: int) -> list:
    """The (kind, step) sequence the JAX package's loop writes for a run
    from step 1 (its train/loop.py:245-283 and :296-298): each step's
    metrics after the next step (with a frame line, but the last's), the
    validation line, the params and grads histograms, then the last train
    line and the perf line."""
    out = []
    for itr in range(1, steps + 1):
        if itr > 1:
            out += [("train", itr - 1), ("frame", itr - 1)]
        if itr % val_every == 0:
            out.append(("validation", itr))
        if hist_every and itr % hist_every == 0:
            out += [("params", itr), ("grads", itr)]
    return out + [("train", steps), ("perf", steps)]


def check_line_order(phase: str, run_dir: str, steps: int, val_every: int,
                     hist_every: int, batch: int, chunk: int) -> list:
    """Raise unless the run's metrics.jsonl holds the JAX loop's lines in
    its order, each frame step x batch x chunk; returns the lines."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    got = [_line_kind(r) for r in lines]
    want = jax_line_order(steps, val_every, hist_every)
    if got != want:
        raise AssertionError(f"{phase}: metrics.jsonl lines {got} are not "
                             f"the JAX loop's {want}")
    bad = [r for r in lines
           if "frame" in r and r["frame"] != r["step"] * batch * chunk]
    if bad:
        raise AssertionError(f"{phase}: frame lines {bad}")
    return lines


def check_wandb_mirror(phase: str, stub: StubWandb, run_dir: str,
                       cwd: str, lines: list) -> dict:
    """Raise unless ``stub`` saw one ``init`` with the JAX package's
    kwargs for this run (its path under ``{cwd}/results``, the
    environment's name, the saved config, the tags, the run dir), every
    scalar line at its step without step / time, every histogram line's
    modules as ``Histogram``s of their counts and edges, no frame line,
    and one ``finish``."""
    import numpy as np
    import yaml

    with open(os.path.join(run_dir, "hydra_config.yaml")) as f:
        saved = yaml.safe_load(f)
    want_init = [{"name": os.path.relpath(run_dir,
                                          os.path.join(cwd, "results")),
                  "project": saved["env"]["env_config"]["env_name"],
                  "config": saved, "tags": saved["main"]["tags"],
                  "dir": run_dir}]
    if stub.calls["init"] != want_init or stub.calls["finish"] != 1:
        raise AssertionError(f"{phase}: wandb init {stub.calls['init']} "
                             f"(want {want_init}), finish "
                             f"{stub.calls['finish']}")
    want_log = []
    for r in lines:
        if "frame" in r:
            continue
        hists = {k: v for k, v in r.items() if k.endswith("/hist")}
        want_log.append(({k: (v["bin_counts"], v["bin_edges"])
                          for k, v in hists.items() if "bin_counts" in v}
                         if hists else
                         {k: v for k, v in r.items()
                          if k not in ("step", "time")}, r["step"]))
    got_log = []
    for metrics, step in stub.calls["log"]:
        got = {}
        for k, v in metrics.items():
            if isinstance(v, StubWandb.Histogram):
                counts, edges = v.np_histogram
                if (counts.dtype, edges.dtype) != (np.int64, np.float32):
                    raise AssertionError(f"{phase}: {k} histogram dtypes "
                                         f"{counts.dtype}, {edges.dtype}")
                v = (counts.tolist(), edges.tolist())
            got[k] = v
        got_log.append((got, step))
    if got_log != want_log:
        n = next((i for i, (g, w) in enumerate(zip(got_log, want_log))
                  if g != w), min(len(got_log), len(want_log)))
        raise AssertionError(f"{phase}: {len(got_log)} wandb log calls for "
                             f"{len(want_log)} records; call {n}: "
                             f"{got_log[n:n + 1]}, the JSONL's "
                             f"{want_log[n:n + 1]}")
    return {"init": 1, "log_calls": len(got_log),
            "histogram_calls": sum(any(k.endswith("/hist") for k in m)
                                   for m, _ in got_log),
            "finish": 1, "stub_seconds": stub.seconds}


@contextlib.contextmanager
def _entry_set(table, key: str, value):
    """``table[key] = value`` within the block (``sys.modules``,
    ``os.environ``), the entry as it was after it."""
    old = table.get(key)
    table[key] = value
    try:
        yield
    finally:
        if old is None:
            table.pop(key, None)
        else:
            table[key] = old


def renamed_config_tree(root: str, name: str) -> str:
    """A copy of the port's packaged config tree under ``root`` with its
    root file renamed ``{name}.yaml``."""
    import shutil

    from multimodal_rssm_torch.core.config import default_config_dir

    tree = os.path.join(root, "config_tree")
    shutil.copytree(default_config_dir(), tree,
                    ignore=shutil.ignore_patterns("*.json"))
    os.rename(os.path.join(tree, "config.yaml"),
              os.path.join(tree, f"{name}.yaml"))
    return tree


def phase_bridges(tmp: str, run_dir: str, device_name: str) -> dict:
    """A user's files in and out at full width.  1. raw recordings
    (``raw_recordings``) built by ``data/dataset_builder.build_dataset``
    (binary channels on; host seconds per episode), then the train CLI on
    that set (batch 50 x chunk 50, bf16, K1 on) for BRIDGE_STEPS steps with
    ``train.histogram_interval`` and ``main.wandb=true`` (a stub ``wandb``
    module in ``sys.modules``), and again with ``train.profile_dir``
    instead, composed from a copy of the config tree whose root is
    ``bridges.yaml``, named by ``$MRSSM_CONFIG_DIR`` and ``--config-name``,
    under deterministic cuDNN: finite metrics, every parameter and running
    stat bit-equal between the two (both options only observe; the renamed
    tree builds the same model), the histogram lines, every record
    mirrored to the stub (``check_wandb_mirror``), each run's
    metrics.jsonl lines in the JAX loop's order with their ``frame``
    counts (``check_line_order``), the trace file, K1 once per train and
    validation step and histogram pass, a step's seconds with and without
    a histogram pass and the pass's logging half alone, the profiled
    steps' seconds against the unprofiled ones; 2. ``collect_sim_data --env synthetic`` for 2
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
    t0 = time.perf_counter()
    tree = renamed_config_tree(tmp, "bridges")
    tree_s = time.perf_counter() - t0
    stub = StubWandb()
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        # the profiled run composes only from the renamed tree: the
        # packaged tree has no bridges.yaml, the copy no config.yaml
        for name, extra, entry in (
                ("histograms", [f"train.histogram_interval={BRIDGE_HIST}",
                                "main.wandb=true",
                                "main.tags=[chip_smoke,bridges]",
                                "main.experiment_name=bridges_hist"],
                 (sys.modules, "wandb", stub.module)),
                ("profiled", [f"train.profile_dir={tmp}/profile",
                              "main.experiment_name=bridges_profiled",
                              "--config-name", "bridges"],
                 (os.environ, "MRSSM_CONFIG_DIR", tree))):
            with _entry_set(*entry):
                runs[name] = train_run(f"bridges/{name}", built,
                                       common + extra, BRIDGE_STEPS,
                                       "device_resident")
    finally:
        torch.backends.cudnn.deterministic = False
    (hrec, hres, hl), (prec, pres, pl) = runs["histograms"], runs["profiled"]
    hlines = check_line_order("bridges/histograms", hres["results_dir"],
                              BRIDGE_STEPS, BRIDGE_STEPS, BRIDGE_HIST,
                              SHAPE[1], SHAPE[0])
    check_line_order("bridges/profiled", pres["results_dir"], BRIDGE_STEPS,
                     BRIDGE_STEPS, 0, SHAPE[1], SHAPE[0])
    mirror = check_wandb_mirror("bridges/histograms", stub,
                                hres["results_dir"], built, hlines)
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
    k1_window = pres["profile"]["launches"].get("normalize_image", 0)
    k1_trace = pres["profile"]["hand_written_in_trace"].get(
        "normalize_image", 0)
    if not k1_window or k1_trace != k1_window:
        raise AssertionError(f"bridges: K1 {k1_trace} times in the profile "
                             f"trace, its wrapper counted {k1_window}; "
                             f"{_lost_kernels(trace)}")
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
        "trace_window": pres["profile"],
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
            hrec["max_memory_allocated_GiB"],
        "lines_in_jax_order": True, "frame_lines": sum(
            "frame" in r for r in hlines),
        "wandb_mirror": mirror,
        "config_tree": {"config_name": "bridges",
                        "via": "MRSSM_CONFIG_DIR and --config-name",
                        "model_bit_equal": True},
        # what this slice adds to the phase's wall time: the tree's copy
        # and the stub's calls
        "slice_extra_seconds": tree_s + mirror["stub_seconds"]}
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


SERVE_CALLS = 10       # timed calls a path, after SERVE_WARMUP
SERVE_WARMUP = 3
SERVE_RTOL = 1e-5      # artifact against the eager port, relative to max |eager|
# the control phase's CEM, at 2 of its 10 iterations: torch.export traces
# every iteration on the host (125-198 s for plan_step's export and 18-30 s
# for its load at 10 on an H100's host, the script's longest step)
SERVE_OVERRIDES = ["rssm.predict_reward=true",
                   "planner.optimisation_iters=2"]


def _post_npz(url: str, arrays: dict) -> dict:
    import io
    import urllib.request

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue(), headers={
        "Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=300) as r:
        body = r.read()
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def _http_error(url: str, arrays: Optional[dict] = None) -> int:
    """The status of a request that must fail (GET without ``arrays``)."""
    import urllib.error
    import urllib.request

    try:
        if arrays is None:
            urllib.request.urlopen(url, timeout=60)
        else:
            _post_npz(url, arrays)
    except urllib.error.HTTPError as e:
        return e.code
    raise AssertionError(f"{url} answered 200")


def phase_serve(tmp: str, run_dir: str, device_name: str):
    """Serving on the checkpoint phase's run (models_6.pt, the default
    configuration at full width, trained in bf16, with the control phase's
    behavior/ checkpoint): the export CLI (all four artifacts at batch 1,
    ``--plan`` with ``SERVE_OVERRIDES``; seconds per artifact, .pt2
    bytes; every artifact's world model in float32, as the JAX package's
    export builds it, whatever ``train.use_amp`` says), each artifact
    loaded (seconds) and held against the eager float32 port on the same
    raw frame and key (filter_step and decode within SERVE_RTOL of max
    |eager|; the agent's and the planner's actions from the key's noise),
    the artifacts
    served over HTTP (a 3-frame streaming carry equal to the direct calls;
    400 for a missing input and an unknown artifact, 404 for an unknown
    path), ms per call at batch 1 direct and over HTTP (median of
    SERVE_CALLS after SERVE_WARMUP, synchronised), and no kernel launched
    (serving normalises without K1, as the JAX package's artifacts do).
    A generator: its first ``next`` runs the export and the checks and
    stops before the timed calls, the second ends the phase (``main``
    waits there for the learning gate, which runs beside the export and
    the checks and not beside the timed calls)."""
    import threading

    import numpy as np
    import torch

    from multimodal_rssm_torch.cli import export_model
    from multimodal_rssm_torch.core.config import (
        apply_overrides, load_run_config)
    from multimodal_rssm_torch.eval.state_estimation import load_eval_model
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.io import export as ex
    from multimodal_rssm_torch.io import serve as sv
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.train import behavior as bh
    from multimodal_rssm_torch.train.planner import make_cem_planner

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    record = {"phase": "serve", "run": os.path.basename(run_dir),
              "device": device_name}
    ck.reset_launch_counts()

    # 1. the export CLI, as a user runs it
    out_dir = os.path.join(tmp, "exported")
    t0 = time.perf_counter()
    written = export_model.main(["--run-dir", run_dir, "--out", out_dir,
                                 "--plan", *SERVE_OVERRIDES])
    record["export_cli_seconds"] = time.perf_counter() - t0
    if set(written) != {"filter_step", "decode", "agent_step", "plan_step"}:
        raise AssertionError(f"export_model wrote {sorted(written)}")
    arts = {}
    for name, entry in written.items():
        t0 = time.perf_counter()
        fn, meta = ex.load_exported(entry["path"])
        arts[name] = (fn, meta)
        record.setdefault("artifacts", {})[name] = {
            "bytes": entry["bytes"], "export_seconds": meta["export_seconds"],
            "load_seconds": time.perf_counter() - t0,
            "compute_dtype": meta["compute_dtype"], "device": meta["device"]}
        if meta["device"] != "cuda" or meta["compute_dtype"] != "float32":
            raise AssertionError(f"{name}: {meta['device']} "
                                 f"{meta['compute_dtype']}")

    # 2. each artifact against the eager port on the same frame and key
    cfg = apply_overrides(load_run_config(run_dir), SERVE_OVERRIDES)
    bh.behavior_cfg(cfg)
    model = load_eval_model(cfg, os.path.join(run_dir,
                                              f"models_{EVAL_ITR}.pt"), dev)
    bstate = bh.init_behavior_state(cfg, dev)
    ckpt.load_behavior_checkpoint(
        ckpt.latest_checkpoint(os.path.join(run_dir, "behavior")), bstate)
    actor = bstate.actor.eval()

    def inputs(seed, key=(0, 7)):
        r = np.random.default_rng(seed)
        frame = {}
        for name in model.observation_names_enc:
            shape = tuple(cfg.env.observation_shapes[name])
            if "image" in name:
                c, h, w = shape
                frame[name] = r.integers(0, 256, (1, h, w, c), np.uint8)
            else:
                frame[name] = r.normal(size=(1, *shape)).astype(np.float32)
        return {"h": r.uniform(-1, 1, (1, model.belief_size)).astype(
                    np.float32),
                "s": r.normal(size=(1, model.state_size)).astype(np.float32),
                "action": r.uniform(-1, 1, (1, 3)).astype(np.float32),
                "obs": frame, "nonterminal": np.ones((1, 1), np.float32),
                "key": np.asarray(key, np.uint32)}

    def as_args(arrays, names):
        def t(v):
            v = v.astype(np.int64) if v.dtype == np.uint32 else v
            return torch.from_numpy(np.array(v, copy=True)).to(dev)
        return tuple({k: t(v) for k, v in arrays[n].items()}
                     if isinstance(arrays[n], dict) else t(arrays[n])
                     for n in names)

    def eager(name, args):
        with torch.no_grad():
            if name == "decode":
                h, s = args
                out = model.decode(h[None], s[None])
                return {k: {"loc": v["loc"]} for k, v in out.items()}
            h, s, action, obs, nt, key = args
            states = model.filter_step(
                h, s, action, ex.normalize_obs(obs, BIT_DEPTH), nt)
            if name == "filter_step":
                return states
            h2, s2 = states["beliefs"], states["posterior_means"]
            if name == "agent_step":
                return h2, s2, actor(h2, s2, None, True,
                                     ex.agent_noise(key, 1, 3))
            plan = make_cem_planner(model, cfg)
            return h2, s2, plan(h2, s2, noise=ex.cem_noise(model, cfg, key,
                                                           1))

    def compare(fn, name, arrays):
        names = ex.DECODE_ARGS if name == "decode" else ex.STEP_ARGS
        args = as_args(arrays, names)
        with torch.no_grad():
            got = sv.flatten_tree(fn(*args))
        want = sv.flatten_tree(eager(name, args))
        if set(got) != set(want):
            raise AssertionError(f"{name}: outputs {sorted(got)} != "
                                 f"{sorted(want)}")
        return max(float(np.abs(got[k] - w).max())
                   / max(float(np.abs(w).max()), 1e-30)
                   for k, w in want.items())

    parity = {}
    arrays = inputs(1, key=(3, 2 ** 31 + 5))
    for name, (fn, _) in arts.items():
        parity[f"{name}/float32"] = compare(fn, name, arrays)
    record["vs_eager_max_rel"] = parity
    record["rtol"] = SERVE_RTOL
    if any(v > SERVE_RTOL for v in parity.values()):
        emit(record)
        raise AssertionError(f"serving artifacts differ from the eager "
                             f"port: {parity}")

    # 3. served over HTTP: the streaming carry, the errors
    httpd = sv.make_server(out_dir, port=0, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def request(arrays, name):
            if name == "decode":
                return {"h": arrays["h"], "s": arrays["s"]}
            flat = {k: v for k, v in arrays.items() if k != "obs"}
            flat.update({f"obs.{k}": v for k, v in arrays["obs"].items()})
            return flat

        fn = arts["filter_step"][0]
        carry = inputs(2)
        carry["h"] = np.zeros_like(carry["h"])
        carry["s"] = np.zeros_like(carry["s"])
        direct = dict(carry)
        for t in range(3):
            carry["obs"] = direct["obs"] = inputs(10 + t)["obs"]
            got = _post_npz(url + "/v1/call/filter_step",
                            request(carry, "filter_step"))
            with torch.no_grad():
                ref = sv.flatten_tree(fn(*as_args(direct, ex.STEP_ARGS)))
            if any(not np.array_equal(got[k], ref[k]) for k in ref):
                raise AssertionError(f"HTTP frame {t} != the direct call")
            carry["h"], carry["s"] = got["beliefs"], got["posterior_states"]
            direct["h"], direct["s"] = ref["beliefs"], ref["posterior_states"]
        errors = {
            "missing_input": _http_error(url + "/v1/call/filter_step",
                                         {"h": carry["h"]}),
            "unknown_artifact": _http_error(url + "/v1/call/nope",
                                            {"h": carry["h"]}),
            "unknown_path": _http_error(url + "/v1/what")}
        record["http_errors"] = errors
        if errors != {"missing_input": 400, "unknown_artifact": 400,
                      "unknown_path": 404}:
            raise AssertionError(f"serve errors: {errors}")

        # 4. ms per call at batch 1, direct and over HTTP
        yield
        timing = {}
        for name in ("filter_step", "decode", "agent_step", "plan_step"):
            fn = arts[name][0]
            names = ex.DECODE_ARGS if name == "decode" else ex.STEP_ARGS
            arrays = inputs(20)
            args = as_args(arrays, names)
            body = request(arrays, name)

            def direct_call():
                with torch.no_grad():
                    fn(*args)
                torch.cuda.synchronize()

            def http_call():
                _post_npz(f"{url}/v1/call/{name}", body)

            timing[name] = {}
            for how, call in (("direct", direct_call), ("http", http_call)):
                for _ in range(SERVE_WARMUP):
                    call()
                times = []
                for _ in range(SERVE_CALLS):
                    t0 = time.perf_counter()
                    call()
                    times.append((time.perf_counter() - t0) * 1e3)
                timing[name][f"{how}_ms"] = statistics.median(times)
                timing[name][f"{how}_ms_min"] = min(times)
        record["ms_per_call_batch1"] = timing
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = {k: v for k, v in ck.launch_counts().items() if v}
    record["launches"] = launches
    record["wall_seconds"] = time.perf_counter() - t_phase
    emit(record)
    if launches:
        raise AssertionError(f"the serving path launched kernels: {launches}")
    return record


def start_quality(tmp: str) -> dict:
    """The learning gate (``python -m multimodal_rssm_torch.cli.quality_gate
    --config default --seed 0``) on the card, started as a process of its
    own with its output in ``tmp`` (the whole script runs it beside phase
    serve's export and checks, which leave the card nearly idle): the
    default configuration, seed 0, 300 iterations at batch 8 x chunk 20
    through the port's own CLIs.  ``finish_quality`` waits for it."""
    log = os.path.join(tmp, "quality_gate.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "multimodal_rssm_torch.cli.quality_gate",
             "--config", "default", "--seed", "0", "--workdir",
             os.path.join(tmp, "work")], cwd=REPO, stdout=f,
            stderr=subprocess.STDOUT, start_new_session=True)
    return {"proc": proc, "log": log, "started": time.time()}


def finish_quality(gate: dict) -> dict:
    """Wait for ``start_quality``'s gate and hold every metric inside the
    committed ``cuda`` window (the reading against the JAX package's
    ``tpu`` window beside it); its seconds from its start to its last line
    of output."""
    rc = gate["proc"].wait()
    with open(gate["log"]) as f:
        lines = f.read().splitlines()
    if rc not in (0, 1) or not lines or not lines[-1].startswith("{"):
        print("\n".join(lines[-40:]), file=sys.stderr)
        raise RuntimeError(f"quality_gate exited {rc} without its summary")
    return _quality_record(json.loads(lines[-1]),
                           os.stat(gate["log"]).st_mtime - gate["started"])


def stop_quality(gate: dict) -> None:
    """End ``start_quality``'s gate and the processes it started, if it
    still runs."""
    import signal

    if gate["proc"].poll() is None:
        os.killpg(gate["proc"].pid, signal.SIGKILL)
    gate["proc"].wait()


def _quality_record(summary: dict, seconds: float) -> dict:
    record = {"phase": "quality", **summary, "wall_seconds": seconds}
    emit(record)
    if summary["rc"] != 0 or not _finite(summary["metrics"].values()):
        raise AssertionError(f"quality gate: rc {summary['rc']}, failures "
                             f"{summary['failures']}")
    return record


BUDGET_STEPS = 4     # a budget run's full-width steps
BUDGET_SAVE_AT = 2   # its async checkpoint: the clones held for two steps


def budget_run(reserve_bytes: Optional[int], overrides=()) -> dict:
    """In a fresh process, as the train CLI starts: the model of the
    default configuration with ``overrides`` on the card, then a
    device-resident replay as large as ``hbm_budget_bytes`` allows at
    ``reserve_bytes`` (None: the port's ``step_reserve_bytes`` of the
    configuration; rows tiled from a small synthetic set), then
    ``BUDGET_STEPS`` full-width steps from it with an async checkpoint
    after step ``BUDGET_SAVE_AT`` (its clones on the card inside the
    window).  Returns the memory readings;
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
        model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
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
            for step in range(1, BUDGET_STEPS + 1):
                t0 = time.perf_counter()
                starts = rng.integers(0, rows - L + 1, size=B)
                idxs = db.indices_to_device(starts[:, None] + np.arange(L),
                                            dev)
                metrics = train_step(arrays, idxs, draws.draw(), gen)
                if step == BUDGET_SAVE_AT:
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
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--budget-run",
             "" if reserve is None else str(reserve), *overrides],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"budget run failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        record = {"phase": "budget", "wall_seconds": time.perf_counter() - t0,
                  **json.loads(proc.stdout.strip().splitlines()[-1])}
        emit(record)
        if record["oom"] or not all(math.isfinite(x)
                                    for x in record["losses"]):
            raise AssertionError(f"budget: {record['oom']} losses "
                                 f"{record['losses']}")


def _parity_setup(overrides, L: int, B: int, seed: int):
    """(cfg, raw inputs, CPU model, card model, run(model, device)) of the
    card-against-CPU checks: the same weights on both, float32,
    deterministic (generator=None), batch B x chunk L at full width, random
    inputs of every modality the configuration names; ``run`` returns one
    step's loss, metrics and gradient norms (over ``train.grad_accum``
    micro-batches)."""
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

    return cfg, raw, cpu_model, gpu_model, run


def card_against_cpu(overrides, L: int, B: int = 2, seed: int = 0):
    """The same weights on the card and on the CPU, float32, TF32 off,
    deterministic (generator=None), batch B x chunk L at full width: loss,
    every metric and the gradient norms of one step (over
    ``train.grad_accum`` micro-batches), on random inputs of every
    modality the configuration names.  Returns (cpu, card, max relative
    error, the metrics outside PARITY_RTOL)."""
    import torch

    _, _, cpu_model, gpu_model, run = _parity_setup(overrides, L, B, seed)
    cpu = run(cpu_model, torch.device("cpu"))
    gpu = run(gpu_model, torch.device("cuda"))
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    bad = {k: (cpu[k], gpu[k]) for k, r in rel.items()
           if r > PARITY_RTOL and abs(gpu[k] - cpu[k]) > 1e-6}
    return cpu, gpu, max(rel.values()), bad


F3_LEVEL = 2.2e-5   # the card-vs-CPU gap of every run but the 256 px one


def card_against_cpu_by_module(overrides, L: int = 6, B: int = 2,
                               seed: int = 0) -> dict:
    """Where the card and the CPU part: ``card_against_cpu``'s step with a
    forward hook on every module, each call's output (the first tensor, or
    every tensor of a dict / tuple) compared as max |card - CPU| / max
    |CPU|, in the CPU's call order; then each parameter's gradient the same
    way.  Returns the first call above F3_LEVEL, the ten largest forward
    and gradient gaps, the metrics' gaps and, per module kind, the largest
    gap and the reduction length of a norm's statistics."""
    import torch

    cfg, _, cpu_model, gpu_model, run = _parity_setup(overrides, L, B, seed)

    def tensors(out):
        if isinstance(out, torch.Tensor):
            return [out]
        if isinstance(out, dict):
            return [t for v in out.values() for t in tensors(v)]
        if isinstance(out, (list, tuple)):
            return [t for v in out for t in tensors(v)]
        return []

    def hooked(model, store):
        handles = []
        for name, mod in model.named_modules():
            def hook(m, args, out, name=name):
                outs = [t.detach().float().cpu() for t in tensors(out)
                        if t.is_floating_point()]
                store.append((name or "<model>", type(m).__name__, outs,
                              [tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)]))
            handles.append(mod.register_forward_hook(hook))
        return handles

    records = {}
    metrics = {}
    for tag, model, dev in (("cpu", cpu_model, torch.device("cpu")),
                            ("cuda", gpu_model, torch.device("cuda"))):
        records[tag] = []
        handles = hooked(model, records[tag])
        try:
            metrics[tag] = run(model, dev)
        finally:
            for h in handles:
                h.remove()
    if [r[0] for r in records["cpu"]] != [r[0] for r in records["cuda"]]:
        raise AssertionError("the card and the CPU called other modules")
    calls, seen = [], {}
    for (name, kind, want, shapes), (_, _, got, _) in zip(records["cpu"],
                                                          records["cuda"]):
        k = seen[name] = seen.get(name, -1) + 1
        gap = max((float((g - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                   for g, w in zip(got, want) if w.numel()), default=0.0)
        calls.append({"module": f"{name}#{k}", "kind": kind, "gap": gap,
                      "in_shapes": shapes[:1]})
    grads = []
    gpu_params = dict(gpu_model.named_parameters())
    for name, p in cpu_model.named_parameters():
        if p.grad is None:
            continue
        g = gpu_params[name].grad.float().cpu()
        grads.append({"param": name, "gap": float((g - p.grad).abs().max())
                      / max(float(p.grad.abs().max()), 1e-30),
                      "numel": p.numel()})
    by_kind = {}
    for c in calls:
        by_kind[c["kind"]] = max(by_kind.get(c["kind"], 0.0), c["gap"])
    norms = {}
    for name, mod in cpu_model.named_modules():
        kind = type(mod).__name__
        if kind in ("GroupNorm", "BatchNorm2d", "InstanceNorm2d") \
                and kind not in norms:
            shape = next(c["in_shapes"][0] for c in calls
                         if c["module"].startswith(name + "#"))
            groups = getattr(mod, "num_groups", None)
            per = (shape[1] // groups if groups else 1) * math.prod(shape[2:])
            norms[kind] = {"module": name, "input": list(shape),
                           "reduction_length": per * (
                               shape[0] if kind == "BatchNorm2d" else 1)}
    first = next((c for c in calls if c["gap"] > F3_LEVEL), None)
    mgap = {k: abs(metrics["cuda"][k] - v) / max(abs(v), 1e-12)
            for k, v in metrics["cpu"].items()}
    return {"overrides": list(overrides), "batch": B, "chunk": L,
            "level": F3_LEVEL, "calls": len(calls), "first_above": first,
            "top_forward": sorted(calls, key=lambda c: -c["gap"])[:10],
            "top_gradients": sorted(grads, key=lambda c: -c["gap"])[:10],
            "metrics_gap": dict(sorted(mgap.items(), key=lambda kv: -kv[1])
                                [:8]),
            "max_gap_by_kind": by_kind, "norms": norms}


def phase_parity():
    L, B = 4, 2
    t0 = time.perf_counter()
    cpu, gpu, max_rel, bad = card_against_cpu([], L, B)
    emit({"phase": "parity", "batch": B, "chunk": L, "rtol": PARITY_RTOL,
          "max_rel_err": max_rel, "cpu": cpu, "cuda": gpu,
          "wall_seconds": time.perf_counter() - t0})
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
    # F3: where the 256 px GroupNorm run's gap starts, beside the default's
    f3 = {name: card_against_cpu_by_module(over) for name, over in (
        ("img256_groupnorm", CODEC_RUNS["img256_groupnorm"]), ("default", []))}
    emit({"phase": "codecs/f3", **f3})

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


# the tools phase: the measurement CLIs (cli/op_profile, micro_bench,
# profile_host_feed, sweep_perf, bench_scaling) in process at full width
TOOLS_STEPS = 2          # op_profile's traced steps (after 3 warm-up and
                         # one the profiler drops)
TOOLS_REPS = 2           # profile_host_feed's timed calls a component
TOOLS_SWEEP = ("remat", "poe")
TOOLS_SWEEP_STEPS = 2    # sweep_perf's and bench_scaling's timed steps


def phase_tools(tmp: str, device_name: str) -> dict:
    """The repo's measurement tools on the card, each through its
    ``main(argv)`` at the default configuration's full width (batch 50 x
    chunk 50, bf16), the launch counts reset just before each: op_profile
    (``TOOLS_STEPS`` traced steps; K1 must show under ``hand-written``,
    once a traced step, as often as its wrapper counted it in the window),
    profile_step (``TOOLS_STEPS`` timed and as many traced steps; K1 in its
    trace as often as its wrapper counted it in the window), micro_bench
    (all six codec cases, finite times), profile_host_feed (every
    component, ``TOOLS_REPS`` calls each; K1 once a step), sweep_perf
    (``TOOLS_SWEEP``, ``TOOLS_SWEEP_STEPS`` steps each; no row ``FAILED``)
    and bench_scaling (1x1, as many steps); K1 once per step of each.  One
    JSON line per tool.  Returns K1's launches by path."""
    from multimodal_rssm_torch.cli import (
        bench_scaling, micro_bench, op_profile, profile_host_feed,
        profile_step, sweep_perf)
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    t_phase = time.perf_counter()
    bad, by_path = [], {}

    def run(name, fn, argv, want_k1):
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        result = fn(argv)
        k1 = ck.launch_counts()["normalize_image"]
        rec = {"phase": f"tools/{name}", "device": device_name,
               "argv": argv, "wall_seconds": time.perf_counter() - t0,
               "k1_launches": k1}
        if want_k1 is not None:
            by_path[f"tools/{name}"] = k1
            if k1 != want_k1:
                bad.append(f"{name}: K1 launched {k1} times, not {want_k1}")
        return result, rec

    prof, rec = run("op_profile", op_profile.main,
                    ["--steps", str(TOOLS_STEPS), "--top", "15",
                     "--trace-dir", os.path.join(tmp, "op_profile")],
                    3 + 1 + TOOLS_STEPS)
    k1 = {k: v for k, v in prof["hand_written"].items()
          if "normalize_image" in k}
    rec.update({k: prof[k] for k in ("total_ms_per_step", "window_ms",
                                     "device_idle_share",
                                     "categories_ms_per_step",
                                     "hand_written")},
               top=prof["top"],
               other=[k for k in prof["kernels"]
                      if k["category"] == "other"][:12])
    emit(rec)
    k1_window = prof["launches"].get("normalize_image", 0)
    if sum(v["count"] for v in k1.values()) != TOOLS_STEPS or (
            k1_window != TOOLS_STEPS):
        bad.append(f"op_profile: K1 under hand-written {k1}, its wrapper "
                   f"{k1_window} times, not once in each of {TOOLS_STEPS} "
                   "steps")

    trace = os.path.join(tmp, "profile_step.json")
    steps, rec = run("profile_step", profile_step.main,
                     ["--steps", str(TOOLS_STEPS), "--warmup", "1",
                      "--trace", trace], 1 + 2 * TOOLS_STEPS)
    k1_window = steps["profile"]["launches"].get("normalize_image", 0)
    k1_trace = steps["profile"]["hand_written_in_trace"].get(
        "normalize_image", 0)
    rec.update(steps)
    emit(rec)
    if k1_trace != k1_window or k1_window != TOOLS_STEPS:
        bad.append(f"profile_step: K1 {k1_trace} times in its trace, its "
                   f"wrapper {k1_window} times in the window, not once in "
                   f"each of {TOOLS_STEPS} steps; {_lost_kernels(trace)}")

    codecs, rec = run("micro_bench", micro_bench.main, [], None)
    rec["cases"] = codecs
    emit(rec)
    if (sorted(codecs) != sorted(micro_bench.CASES)
            or not _finite([v for c in codecs.values() for v in c.values()])):
        bad.append(f"micro_bench: {codecs}")

    feed, rec = run("profile_host_feed", profile_host_feed.main,
                    ["--reps", str(TOOLS_REPS)], 1 + 3 * (2 + TOOLS_REPS))
    rec["components"] = feed
    emit(rec)
    if not _finite([v for v in feed.values()]):
        bad.append(f"profile_host_feed: {feed}")

    rows, rec = run("sweep_perf", sweep_perf.main,
                    ["--variants", ",".join(TOOLS_SWEEP), "--steps",
                     str(TOOLS_SWEEP_STEPS)],
                    len(TOOLS_SWEEP) * (3 + TOOLS_SWEEP_STEPS))
    rec["rows"] = rows
    emit(rec)
    bad += [f"sweep_perf: {r}" for r in rows if "failed" in r]

    rows, rec = run("bench_scaling", bench_scaling.main,
                    ["--meshes", "1x1", "--steps", str(TOOLS_SWEEP_STEPS),
                     "--json"], 3 + TOOLS_SWEEP_STEPS)
    rec["rows"] = rows
    emit(rec)
    if len(rows) != 1:
        bad.append(f"bench_scaling: {rows}")

    wall = time.perf_counter() - t_phase
    emit({"phase": "tools", "device": device_name, "wall_seconds": wall,
          "k1_launches": by_path})
    if bad:
        raise AssertionError(f"tools: {bad}")
    return by_path


def _lost_kernels(path: str) -> dict:
    """Of a Chrome trace with host activity: the kernel launches (runtime
    records) whose kernel has no record, with their times from the first
    launch (ms) and the span of all launches."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["args"].get("correlation") for e in events
               if e.get("cat") == "kernel"}
    launches = [e for e in events if "LaunchKernel" in e.get("name", "")
                and e.get("cat") in ("cuda_runtime", "cuda_driver")]
    if not launches:
        return {"launches": 0}
    t0 = min(e["ts"] for e in launches)
    lost = [e for e in launches if e["args"].get("correlation") not in kernels]
    return {"launches": len(launches), "kernel_records": len(kernels),
            "lost": len(lost),
            "lost_at_ms": [round((e["ts"] - t0) / 1e3, 3) for e in lost[:20]],
            "span_ms": (max(e["ts"] for e in launches) - t0) / 1e3}


def phase_tools_process() -> dict:
    """``phase_tools`` in a fresh process (``chip_smoke.py --tools``), as a
    user runs each tool: in this process earlier phases have traced with
    ``torch.profiler``, and a later trace here lost the records of a few
    dozen kernels, one K1 among them (two whole-script runs on an H100).
    Returns K1's launches by path."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()   # this process's cached blocks back to the card
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--tools"], capture_output=True, text=True,
                          timeout=600)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise AssertionError(f"tools failed ({proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])["tools_k1"]


# the parallel phase (data parallelism: train.mesh.data as torch.distributed
# ranks, parallel/)
PARALLEL_STEPS = 12       # a CLI run of (a); the last traces steps 10-12
PARALLEL_TIMED = slice(2, 9)   # steps 3-9: after the warm-up, before the trace
PARALLEL_BF16_STEPS = 4
PARALLEL_F32_BATCH = 10   # (b)'s float32 step: 5 rows a rank (cut from 50)
# (c)'s bf16 run: step 2 is timed (the first warms up, the last
# validates), at batch 50 x chunk 10 (cut from 50: 8-25 s a step at chunk
# 50, two ranks on a card, every RSSM step's collectives waiting on the
# other rank's work)
MODEL_AXIS_BF16_STEPS = 3
MODEL_AXIS_BF16_CHUNK = 10
PARALLEL_WORLD_S = 900    # a spawned world's limit
PARALLEL_COLLECTIVE_S = 300   # a collective waiting longer fails the world
# two ranks against one on the same global batch, float32: the JAX
# package's own data-parallel tolerance (tests/sharded_cases.py): the loss
# within rtol 1e-5, all but 5e-4 of the parameters within rtol 2e-4 / atol
# 2e-5 and every one within 2 lr; the running stats within rtol 1e-4, atol
# 1e-6 x the largest; the two ranks bit-equal to each other
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_RTOL, PARALLEL_ATOL, PARALLEL_LOOSE = 2e-4, 2e-5, 5e-4
PARALLEL_STATS_RTOL, PARALLEL_STATS_ATOL = 1e-4, 1e-6


def _two_tier(got: dict, want: dict, lr: float, rtol: float = PARALLEL_RTOL,
              atol: float = PARALLEL_ATOL) -> dict:
    """The JAX package's two-tier bound of ``got`` against ``want`` (name
    -> tensor): its data-parallel tolerance by default."""
    total = loose = 0
    worst = 0.0
    for name, w in want.items():
        d = (got[name].double() - w.double()).abs()
        loose += int((d > atol + rtol * w.double().abs()).sum())
        total += d.numel()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return {"worst_abs": worst, "loose": loose, "elements": total,
            "ok": worst <= 2 * lr and loose <= PARALLEL_LOOSE * total}


def _stats_err(got: dict, want: dict) -> float:
    """The largest |got - want| / (rtol |want| + atol max |want|) over the
    running stats (<= 1 within the tolerance)."""
    worst = 0.0
    for name, w in want.items():
        w = w.double()
        bound = (PARALLEL_STATS_RTOL * w.abs()
                 + PARALLEL_STATS_ATOL * float(w.abs().max()))
        worst = max(worst, float(((got[name].double() - w).abs() / bound)
                                 .max()))
    return worst


def parallel_f32_step(spec: dict, dev, dp) -> dict:
    """One float32 train step (K1 on, the spec's generator seed) on the
    spec's global raw batch, or under ``dp`` on this rank's rows of it
    (under ``dp.model`` with the weights column-sharded first): metrics,
    the whole parameters, this rank's blocks of the sharded ones, running
    stats, K1's launches, peak memory."""
    import torch

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models.world_model import WorldModel
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.parallel.mesh import shard_batch
    from multimodal_rssm_torch.train import trainer as tr

    cfg = compose(overrides=spec["f32_overrides"])
    model = WorldModel.from_config(cfg)
    model.load_state_dict(spec["state_dict"])
    model.to(dev)
    opt, sched = tr.build_optimizer(cfg, model)
    if dp is not None and dp.model is not None:
        tensor_lib.shard_model_(model, dp.model,
                                tensor_lib.MIN_SHARD_WIDTH, opt)
    train_step, _ = tr.make_train_step(model, cfg, opt, sched,
                                       spec["aug_spec"], dev,
                                       kernel_normalize=True, dp=dp)
    raw = spec["raw"] if dp is None else shard_batch(spec["raw"], dp.train)
    obs, *rest = raw
    raw = ({k: v.to(dev) for k, v in obs.items()}, *(x.to(dev) for x in rest))
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    metrics = train_step(raw, spec["draws"],
                         torch.Generator(dev).manual_seed(spec["seed"]))
    torch.cuda.synchronize(dev)
    params = tensor_lib.full_named(
        {n: p.detach() for n, p in model.named_parameters()}, model)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": {n: p.cpu() for n, p in params.items()},
           "blocks": {n: p.detach().cpu() for n, (p, _, _)
                      in tensor_lib.sharded(model).items()},
           "stats": {k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))},
           "k1_launches": ck.launch_counts()["normalize_image"],
           "max_memory_allocated_GiB":
               torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    del model, opt, train_step
    return out


def parallel_rank(rank: int, nprocs: int, init_method: str, backend: str,
                  spec_path: str, out_dir: str) -> None:
    """One rank of phase parallel's two-rank world (spawned by
    ``parallel.launch.spawn``): the float32 step on its rows of the global
    batch, then the shipped bf16 settings through ``train.loop.run`` for a
    few steps; writes ``rank{rank}.pt``."""
    import gc

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.train import trainer as tr
    from multimodal_rssm_torch.train.loop import ranks_per_device, run

    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    configure_float32()
    spec = torch.load(spec_path, weights_only=False)
    dev = mesh_lib.init_distributed(
        "cuda:0" if backend == "gloo" else f"cuda:{rank}", backend,
        init_method, rank, nprocs, PARALLEL_COLLECTIVE_S)
    try:
        cfg = compose(overrides=spec["f32_overrides"] + ["train.mesh.data=2"])
        dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, "cuda"),
                                    int(cfg.train.batch_size),
                                    tr.resolve_grad_accum(cfg))
        torch.backends.cudnn.deterministic = True
        try:
            out = {"rank": rank, "device": str(dev),
                   "rows": dp.train.rows.tolist(),
                   "f32": parallel_f32_step(spec, dev, dp)}
        finally:
            torch.backends.cudnn.deterministic = False
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ck.reset_launch_counts()
        result = run(compose(overrides=spec["bf16_overrides"]),
                     cwd=spec["root"], device=str(dev))
        out["bf16"] = {
            "launches": ck.launch_counts(), "feed": result["feed"],
            "step_seconds": result["step_seconds"],
            "loss": result["metrics"]["loss"],
            "validation_loss": result["validation_metrics"]["loss"],
            "results_dir": result["results_dir"],
            "max_memory_allocated_GiB":
                torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "max_memory_reserved_GiB":
                torch.cuda.max_memory_reserved(dev) / 2 ** 30,
            "ranks_per_device": ranks_per_device(dev, dp)}
        # the card's memory in use with both ranks alive, beside what this
        # rank's allocator reserves at that moment
        mesh_lib.barrier(dev, dp.group)
        free, total = torch.cuda.mem_get_info(dev)
        out["bf16"]["card_used_GiB"] = (total - free) / 2 ** 30
        out["bf16"]["reserved_GiB"] = torch.cuda.memory_reserved(dev) / 2 ** 30
        mesh_lib.barrier(dev, dp.group)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the model axis (train.mesh.model: column-sharded weights, parallel/tensor.py)
MODEL_AXIS_MESH = ["train.mesh.data=1", "train.mesh.model=2"]
# (c)'s float32 step: the largest global batch of these that two ranks, each
# holding every row, fit beside each other, by the one-process float32
# step's 75.28 GiB at batch 50 (PR 13) and the 5.91 GiB the card held
# beyond two ranks' allocators there
MODEL_AXIS_F32_BATCHES = (50, 25, 10)
F32_STEP_GIB_AT_50, TWO_RANK_OVERHEAD_GIB = 75.28, 5.91
# the JAX package's model-axis tolerance (tests/sharded_cases.py
# case_model_axis): the loss within rtol 1e-5, all but 5e-4 of the
# parameters within rtol 2e-2 / atol 5e-4 and every one within 2 lr
MODEL_AXIS_RTOL, MODEL_AXIS_ATOL = 2e-2, 5e-4
# (d): the global batch of data=2 x model=2 ranks, and its chunk (cut from
# 50: every RSSM step adds 18 model-group collectives, each of which waits
# for the other ranks' work on the shared card)
MODEL_AXIS_CLI_BATCH, MODEL_AXIS_CLI_CHUNK = 8, 10
MODEL_AXIS_CLI_STEPS = (3, 5)   # (d): the run resumed, and the whole run


def model_axis_rank(rank: int, nprocs: int, init_method: str, backend: str,
                    spec_path: str, out_dir: str) -> None:
    """One rank of (c)'s ``train.mesh.model=2`` world (spawned by
    ``parallel.launch.spawn``): the float32 step on the whole global batch
    with the weights column-sharded, then the shipped bf16 settings through
    ``train.loop.run``, then where ``spec["traced"]``
    ``_traced_model_axis_step``; writes ``rank{rank}.pt``.  The allocator grows its segments in place
    (``expandable_segments``): two full-width ranks at batch 50 fill the
    card but for ~0.1 GiB with fixed segments."""
    import gc

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.train import trainer as tr
    from multimodal_rssm_torch.train.loop import ranks_per_device, run

    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    configure_float32()
    spec = torch.load(spec_path, weights_only=False)
    dev = mesh_lib.init_distributed(
        "cuda:0" if backend == "gloo" else f"cuda:{rank}", backend,
        init_method, rank, nprocs, PARALLEL_COLLECTIVE_S)
    try:
        cfg = compose(overrides=spec["f32_overrides"] + MODEL_AXIS_MESH)
        dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, "cuda"),
                                    int(cfg.train.batch_size))
        torch.backends.cudnn.deterministic = True
        try:
            out = {"rank": rank, "model_rank": dp.model.rank,
                   "rows": dp.train.rows.tolist(),
                   "f32": parallel_f32_step(spec, dev, dp)}
        finally:
            torch.backends.cudnn.deterministic = False
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        ck.reset_launch_counts()
        bf16_cfg = compose(overrides=spec["bf16_overrides"])
        result = run(bf16_cfg, cwd=spec["root"], device=str(dev))
        out["bf16"] = {
            "launches": ck.launch_counts(), "feed": result["feed"],
            "step_seconds": result["step_seconds"],
            "loss": result["metrics"]["loss"],
            "grad_norm": result["metrics"]["grad_norm"],
            "validation_loss": result["validation_metrics"]["loss"],
            "results_dir": result["results_dir"],
            "sharded": len(tensor_lib.sharded(result["model"])),
            "max_memory_allocated_GiB":
                torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "max_memory_reserved_GiB":
                torch.cuda.max_memory_reserved(dev) / 2 ** 30,
            "ranks_per_device": ranks_per_device(dev, dp)}
        model = result["model"]
        del result
        if spec["traced"]:
            out.update(_traced_model_axis_step(spec, model, bf16_cfg, dev,
                                               out_dir, rank))
        del model
        mesh_lib.barrier(dev)
        free, total = torch.cuda.mem_get_info(dev)
        out["bf16"]["card_used_GiB"] = (total - free) / 2 ** 30
        mesh_lib.barrier(dev)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _traced_model_axis_step(spec: dict, model, bf16_cfg, dev, out_dir: str,
                            rank: int) -> dict:
    """(c) under ``--model-axis``: one more bf16 step on the run's sharded
    model, traced by ``torch.profiler`` (the ``model_parallel`` spans' device
    and host ms), then model-group all-reduces with no other work queued (an
    RSSM layer's [50, 1024] output, up_conversion's [2450, 32768])."""
    import torch
    import torch.distributed as dist

    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.train import trainer as tr

    out = {}
    opt, sched = tr.build_optimizer(bf16_cfg, model)
    dp50 = mesh_lib.data_parallel(
        mesh_lib.mesh_from_config(bf16_cfg, "cuda"),
        int(bf16_cfg.train.batch_size))
    train_step, _ = tr.make_train_step(model, bf16_cfg, opt, sched,
                                       spec["aug_spec"], dev,
                                       kernel_normalize=True, dp=dp50)
    obs, *rest = spec["raw_bf16"]
    raw = ({k: v.to(dev) for k, v in obs.items()},
           *(x.to(dev) for x in rest))
    g = torch.Generator(dev).manual_seed(spec["seed"])
    torch.cuda.synchronize(dev)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        train_step(raw, spec["draws"], g)
        torch.cuda.synchronize(dev)
        out["traced_step_s"] = time.perf_counter() - t0
    trace = os.path.join(out_dir, f"trace_rank{rank}.json")
    prof.export_chrome_trace(trace)
    out["trace"] = _collective_device_ms(trace, tensor_lib.SPAN)
    # one model-group all-reduce with no other work queued: an RSSM
    # layer's [50, 1024] output, and up_conversion's [2450, 32768]
    out["idle_all_reduce_ms"] = {}
    for shape, reps in (((50, 1024), 20), ((2450, 32768), 5)):
        x = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        dist.all_reduce(x, group=dp50.model.group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(x, group=dp50.model.group)
        torch.cuda.synchronize(dev)
        out["idle_all_reduce_ms"][str(list(shape))] = (
            (time.perf_counter() - t0) / reps * 1e3)
        del x
    return out


def model_axis_cli_rank(rank: int, nprocs: int, cards: int, runs: list,
                        out_dir: str, strict: Optional[str] = None) -> None:
    """One rank of (d)'s world: for each (name, argv, port) of ``runs`` in
    turn, the train CLI joined as ``torchrun`` joins it (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``; every rank sees the
    one card), with deterministic cuDNN, so that a resumed run can equal
    the whole one bit for bit (``strict`` as ``_strict``), the first
    ``F6_STEPS`` steps' staged digests recorded (``parallel/digests.py``);
    writes the rank's backend, K1 launches, peak memory, digests, seconds
    and result to ``cli{rank}_{name}.pt``.  A later run of ``runs`` (a
    ``--resume``) starts in the same process from what the earlier one
    wrote."""
    import torch

    _join_as_torchrun(rank, nprocs, runs[0][2], cards)
    from multimodal_rssm_torch.cli.train import main as train_main
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.parallel.digests import StagedDigests
    from multimodal_rssm_torch.parallel.mesh import default_backend

    _strict(strict)
    for name, argv, port in runs:
        os.environ["MASTER_PORT"] = str(port)
        ck.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with StagedDigests(F6_STEPS) as digests:
            result = train_main(argv)
        torch.save({"backend": default_backend(torch.device("cuda")),
                    "launches": ck.launch_counts(),
                    "max_memory_allocated_GiB":
                        torch.cuda.max_memory_allocated() / 2 ** 30,
                    "digests": digests.records,
                    "seconds": time.perf_counter() - t0,
                    "result": {k: v for k, v in result.items()
                               if k != "model"}},
                   os.path.join(out_dir, f"cli{rank}_{name}.pt"))
        del result


def _join_as_torchrun(rank: int, nprocs: int, port: int, cards: int
                      ) -> None:
    """The environment ``torchrun`` gives rank ``rank`` of ``nprocs`` on a
    host of ``cards`` cards (every rank sees them all), and (d)'s cuBLAS
    workspace setting; the repo on the path."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank % cards),
                      LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      CUBLAS_WORKSPACE_CONFIG=":4096:8")
    sys.path.insert(0, REPO)


F6_STEPS = 3   # (d): the steps whose staged digests each rank records


def _partings(a: list, b: list) -> list:
    """Each rank's ``parallel/digests.first_parting`` of two worlds' staged
    digests (one list of records a rank)."""
    from multimodal_rssm_torch.parallel.digests import first_parting

    return [first_parting(x, y) for x, y in zip(a, b)]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _metric_lines(run_dir: str) -> list:
    """The metric and histogram lines without ``time``: not the perf lines
    (one a process) or the frame lines (none after a process's last train
    line), so that a resumed run's lines equal an uninterrupted run's."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in r.items() if k != "time"}
                for r in map(json.loads, f)
                if "frame" not in r
                and not any(k.endswith("/perf") for k in r)]


def _same_state(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_state(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y)
                                        for x, y in zip(a, b))
    return a == b


def _model_axis_cli_tail(tmp: str) -> list:
    return ["--device", "cuda", "--cwd", tmp,
            "--dist-timeout", str(PARALLEL_COLLECTIVE_S)]


def _model_axis_cli_argv(tmp: str, steps: int, experiment: str) -> list:
    """(d)'s train CLI arguments: ``data=2 x model=2`` at
    ``MODEL_AXIS_CLI_BATCH`` x ``MODEL_AXIS_CLI_CHUNK``, ``steps`` steps
    with a checkpoint at the last, a validation every 3."""
    return [*_model_axis_overrides(tmp, steps, experiment),
            *_model_axis_cli_tail(tmp)]


def _model_axis_overrides(tmp: str, steps: int, experiment: str) -> list:
    return [f"train.train_data_path=[{tmp}/train]",
            f"train.validation_data_path=[{tmp}/validation]",
            f"train.batch_size={MODEL_AXIS_CLI_BATCH}",
            f"train.chunk_size={MODEL_AXIS_CLI_CHUNK}",
            "train.experience_size=1000",
            "train.pallas_normalize=true", "train.mesh.data=2",
            "train.mesh.model=2", "train.validation_interval=3",
            f"train.train_iteration={steps}",
            f"train.checkpoint_interval={steps}",
            f"main.experiment_name={experiment}"]


def phase_model_axis(tmp: str, device_name: str, traced: bool = False
                     ) -> dict:
    """The model axis (``train.mesh.model``) on the card, in phase
    parallel.  (c) ``data=1 x model=2``: two ranks (NCCL on two cards where
    there are two, else both on this card over gloo) through
    ``parallel.launch.spawn``: the float32 step (deterministic cuDNN, K1
    on) of each rank on the whole global batch (the largest of
    ``MODEL_AXIS_F32_BATCHES`` two ranks fit) held against a one-rank
    replicated step here on the same batch and weights at the JAX
    package's model-axis tolerance, the ranks' whole parameters bit-equal,
    each rank's blocks its columns of the whole; then the shipped bf16
    settings for 6 steps and a validation at batch 50 x chunk 50 through
    ``train.loop.run`` (``rssm.remat=true`` where two ranks do not fit
    without it): steps/s a rank, each rank's peak memory, K1's launches;
    with ``traced`` (``--model-axis``; the whole script leaves it out to
    keep within its time) one more traced step and idle all-reduces: the
    model group's collectives and the ``model_parallel`` spans' ms a step.
    (d) ``data=2 x model=2`` through
    the train CLI (NCCL on four cards, else gloo: the CLI's choice where
    the ranks outnumber the cards, every rank on the one card), four ranks
    joined as ``torchrun`` joins them, batch 8 x chunk 10, deterministic cuDNN: 3
    steps with a checkpoint at 3, ``--resume`` to 5 against an
    uninterrupted 5-step run (equal metrics and ``models_5.pt``), then
    ``models_3.pt`` mesh-less through the check_model CLI.  Returns K1's
    launches by path."""
    import gc

    import torch
    import torch.multiprocessing  # noqa: F401 (ProcessRaisedException)

    from multimodal_rssm_torch.cli import check_model
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.parallel import launch
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.train import trainer as tr

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    record = {"phase": "parallel/model_axis", "device": device_name,
              "backend": backend, "cards": cards}
    bad = []

    # (c) data=1 x model=2
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    f32_batch = max(b for b in MODEL_AXIS_F32_BATCHES
                    if 2 * F32_STEP_GIB_AT_50 * b / 50
                    + TWO_RANK_OVERHEAD_GIB <= total_gib
                    or b == MODEL_AXIS_F32_BATCHES[-1])
    base = [f"train.train_data_path=[{tmp}/train]",
            f"train.validation_data_path=[{tmp}/validation]",
            f"train.chunk_size={SHAPE[0]}", "train.experience_size=1000"]
    cfg = compose(overrides=base + [f"train.batch_size={SHAPE[1]}"])
    D = build_buffer(cfg, seed=0)
    load_dataset(tmp, D, cfg.train.train_data_path)
    aug_spec = tr.build_aug_spec(D)
    raw = D.sample(SHAPE[1], SHAPE[0])
    raw = ({k: torch.from_numpy(v) for k, v in raw[0].items()},
           *(torch.from_numpy(x) for x in raw[1:]))
    cut = ({k: v[:, :f32_batch] for k, v in raw[0].items()},
           *(x[:, :f32_batch] for x in raw[1:]))
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    lr = float(cfg.rssm.model_learning_rate)
    spec_c = {"f32_overrides": base + [f"train.batch_size={f32_batch}",
                                       "train.use_amp=false"],
              "state_dict": model.state_dict(), "aug_spec": aug_spec,
              "raw": cut, "raw_bf16": raw,
              "draws": tr.HostAugmentDraws(D, aug_spec, seed=1).draw(),
              "seed": 5, "root": tmp, "traced": traced}
    torch.backends.cudnn.deterministic = True
    try:
        one = parallel_f32_step(spec_c, torch.device("cuda"), None)
    finally:
        torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    for remat in ("false", "true"):
        spec_c["bf16_overrides"] = base + MODEL_AXIS_MESH + [
            f"train.batch_size={SHAPE[1]}",
            f"train.chunk_size={MODEL_AXIS_BF16_CHUNK}",
            f"train.train_iteration={MODEL_AXIS_BF16_STEPS}",
            f"train.validation_interval={MODEL_AXIS_BF16_STEPS}",
            "train.pallas_normalize=true", f"rssm.remat={remat}",
            f"main.experiment_name=model_axis_{remat}"]
        spec_path = os.path.join(tmp, "model_axis_spec.pt")
        torch.save(spec_c, spec_path)
        out_dir = os.path.join(tmp, f"model_axis_ranks_{remat}")
        os.makedirs(out_dir, exist_ok=True)
        try:
            t0 = time.perf_counter()
            with launch.file_rendezvous() as init_method:
                launch.spawn(model_axis_rank, 2, (2, init_method, backend,
                                                  spec_path, out_dir),
                             timeout=PARALLEL_WORLD_S)
            world_s = time.perf_counter() - t0
        except torch.multiprocessing.ProcessRaisedException as e:
            if remat == "true" or "out of memory" not in str(e).lower():
                raise
            emit({"phase": "parallel/model_axis", "note": "two full-width "
                  "model-axis ranks do not fit the card at batch 50: "
                  "rssm.remat=true", "error": str(e)[-400:]})
            gc.collect()
            continue
        break
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    check = {"f32_batch": f32_batch, "f32_batch_cut_from": SHAPE[1],
             "remat": remat == "true", "world_seconds": world_s,
             "one_rank": {"loss": one["metrics"]["loss"],
                          "grad_norm": one["metrics"]["grad_norm"],
                          "k1_launches": one["k1_launches"],
                          "max_memory_allocated_GiB":
                              one["max_memory_allocated_GiB"]},
             "tolerance": {"loss_rtol": PARALLEL_LOSS_RTOL,
                           "param_rtol": MODEL_AXIS_RTOL,
                           "param_atol": MODEL_AXIS_ATOL,
                           "param_max_loose": PARALLEL_LOOSE,
                           "param_hard_abs": 2 * lr,
                           "stats_rtol": PARALLEL_STATS_RTOL,
                           "stats_atol_x_max": PARALLEL_STATS_ATOL}}
    want_blocks = tensor_lib.param_spec(model, 2)
    for r, got in enumerate(ranks):
        f = got["f32"]
        loss_rel = abs(f["metrics"]["loss"] - one["metrics"]["loss"]) / abs(
            one["metrics"]["loss"])
        norm_rel = abs(f["metrics"]["grad_norm"]
                       - one["metrics"]["grad_norm"]) / abs(
            one["metrics"]["grad_norm"])
        params = _two_tier(f["params"], one["params"], lr, MODEL_AXIS_RTOL,
                           MODEL_AXIS_ATOL)
        stats = _stats_err(f["stats"], one["stats"])
        columns = set(f["blocks"]) == set(want_blocks) and all(
            torch.equal(block, f["params"][n].narrow(
                want_blocks[n], got["model_rank"] * block.shape[
                    want_blocks[n]], block.shape[want_blocks[n]]))
            for n, block in f["blocks"].items())
        check[f"rank{r}"] = {
            "rows": [got["rows"][0], got["rows"][-1]],
            "loss": f["metrics"]["loss"], "loss_rel_err": loss_rel,
            "grad_norm_rel_err": norm_rel, "params": params,
            "stats_err_over_tol": stats, "blocks": len(f["blocks"]),
            "blocks_are_columns_of_the_whole": columns,
            "k1_launches_f32": f["k1_launches"],
            "f32_max_memory_allocated_GiB": f["max_memory_allocated_GiB"]}
        if (loss_rel > PARALLEL_LOSS_RTOL or norm_rel > 1e-4
                or not params["ok"] or stats > 1 or not columns):
            bad.append(f"(c) rank {r}: {check[f'rank{r}']}")
        if f["k1_launches"] != 1:
            bad.append(f"(c) rank {r}: K1 launched {f['k1_launches']} times")
    same = all(torch.equal(ranks[0]["f32"][part][k], ranks[1]["f32"][part][k])
               for part in ("params", "stats") for k in ranks[0]["f32"][part])
    check["ranks_bit_equal"] = same
    if not same:
        bad.append("(c) the two ranks' whole parameters differ")
    record["c_f32"] = check
    bf = {}
    for r, got in enumerate(ranks):
        b = got["bf16"]
        bf[f"rank{r}"] = {
            "steps_per_s_median_after_1": 1.0 / statistics.median(
                b["step_seconds"][1:-1]),
            "step_seconds": b["step_seconds"], "feed": b["feed"],
            "sharded_weights": b["sharded"],
            "max_memory_allocated_GiB": b["max_memory_allocated_GiB"],
            "max_memory_reserved_GiB": b["max_memory_reserved_GiB"],
            "ranks_per_device": b["ranks_per_device"],
            "k1_launches": b["launches"]["normalize_image"],
            "loss": b["loss"], "validation_loss": b["validation_loss"]}
        if traced:
            t = got["trace"]
            bf[f"rank{r}"].update({
                "traced_step_s": got["traced_step_s"],
                "model_group_collectives_per_step": t["spans"],
                "model_parallel_span_device_ms_per_step": t["span_ms"],
                "model_parallel_span_device_events_per_step":
                    t["span_device_events"],
                "model_parallel_span_host_ms_per_step": t["span_host_ms"],
                "idle_bf16_all_reduce_ms": got["idle_all_reduce_ms"],
                "nccl_kernels_per_step": t["nccl_kernels"]})
            if not t["spans"]:
                bad.append(f"(c) rank {r}: the traced step holds no "
                           "model-group span")
        if b["ranks_per_device"] != (1 if cards >= 2 else 2):
            bad.append(f"(c) rank {r}: ranks_per_device "
                       f"{b['ranks_per_device']} with {cards} card(s)")
        if (b["launches"]["normalize_image"] != MODEL_AXIS_BF16_STEPS + 1
                or b["sharded"] != len(want_blocks)
                or not all(math.isfinite(v) for v in
                           (b["loss"], b["validation_loss"]))):
            bad.append(f"(c) rank {r} bf16: {bf[f'rank{r}']}")
    bf["losses_bit_equal"] = (ranks[0]["bf16"]["loss"]
                              == ranks[1]["bf16"]["loss"])
    bf["card_used_GiB"] = ranks[0]["bf16"]["card_used_GiB"]
    record["c_bf16"] = bf
    record["c_run_dirs"] = len({got["bf16"]["results_dir"]
                                for got in ranks})
    if record["c_run_dirs"] != 1:
        bad.append(f"(c) {record['c_run_dirs']} run dirs")
    del model, one, ranks
    gc.collect()
    torch.cuda.empty_cache()

    # (d) data=2 x model=2 through the train CLI, four ranks
    d_backend = "nccl" if cards >= 4 else "gloo"
    tail = _model_axis_cli_tail(tmp)
    first, whole = MODEL_AXIS_CLI_STEPS
    resume = [f"train.train_iteration={whole}",
              f"train.checkpoint_interval={whole}",
              "main.experiment_name=model_axis_cli_3", "--resume", "latest",
              *tail]
    worlds = {"whole": [("whole", _model_axis_cli_argv(
                  tmp, whole, "model_axis_cli_5"))],
              "first": [("first", _model_axis_cli_argv(
                  tmp, first, "model_axis_cli_3")), ("resume", resume)]}

    def cli_world(world, runs):
        out_dir = os.path.join(tmp, f"model_axis_cli_{world}")
        os.makedirs(out_dir, exist_ok=True)
        ports = set()
        while len(ports) < len(runs):
            ports.add(_free_port())
        t0 = time.perf_counter()
        launch.spawn(model_axis_cli_rank, 4, (
            4, cards, [(name, argv, port)
                       for (name, argv), port in zip(runs, sorted(ports))],
            out_dir), timeout=PARALLEL_WORLD_S)
        wall = time.perf_counter() - t0
        out = {}
        for name, _ in runs:
            out[name] = [torch.load(os.path.join(out_dir,
                                                 f"cli{r}_{name}.pt"),
                                    weights_only=False) for r in range(4)]
            out[name][0]["wall_seconds"] = wall
        return out

    # two worlds one after the other, each in fresh processes as a user's
    # torchrun starts them: the whole run in one, the first three steps
    # and then their --resume (a second CLI call of the same processes,
    # which builds everything anew and reads the checkpoint file alone) in
    # the other, so the resume check and the staged digests compare two
    # fresh worlds (F6 showed only between fresh processes: PERF.md), and
    # the digests name a parting's rank, stage and RSSM step
    cli = {}
    for world, runs in worlds.items():
        cli.update(cli_world(world, runs))
    run_dir = cli["first"][0]["result"]["results_dir"]
    resumed = _metric_lines(run_dir)
    straight_dir = cli["whole"][0]["result"]["results_dir"]
    a = torch.load(os.path.join(run_dir, f"models_{whole}.pt"),
                   weights_only=False)
    b = torch.load(os.path.join(straight_dir, f"models_{whole}.pt"),
                   weights_only=False)
    equal = {part: _same_state(a[part], b[part])
             for part in ("model", "optimizer", "extra")}
    equal["metrics"] = resumed == _metric_lines(straight_dir)
    whole_model = WorldModel.from_config(compose())
    shapes_whole = all(a["model"][n].shape == p.shape
                       for n, p in whole_model.state_dict().items())
    d = {"batch": MODEL_AXIS_CLI_BATCH, "chunk": MODEL_AXIS_CLI_CHUNK,
         "chunk_cut_from": SHAPE[0],
         "backend": d_backend,
         "resume_equals_whole_run": equal,
         "checkpoint_holds_whole_tensors": shapes_whole}
    for name, got in cli.items():
        d[name] = {
            "wall_seconds": got[0]["wall_seconds"],
            "start_step": got[0]["result"]["start_step"],
            "steps": len(got[0]["result"]["step_seconds"]),
            "steps_per_s_median": 1.0 / statistics.median(
                got[0]["result"]["step_seconds"]),
            "k1_launches": [g["launches"]["normalize_image"] for g in got],
            "max_memory_allocated_GiB": [g["max_memory_allocated_GiB"]
                                         for g in got],
            "loss": got[0]["result"]["metrics"]["loss"]}
        want_k1 = {"first": first + 1, "resume": whole - first,
                   "whole": whole + 1}[name]
        if {g["backend"] for g in got} != {d_backend}:
            bad.append(f"(d) {name}: backends {[g['backend'] for g in got]}"
                       f" with {cards} card(s)")
        if d[name]["k1_launches"] != [want_k1] * 4:
            bad.append(f"(d) {name}: K1 launched {d[name]['k1_launches']}")
    if not all(equal.values()) or not shapes_whole:
        bad.append(f"(d) resume against the whole run: {equal}, whole "
                   f"tensors {shapes_whole}")
    d["f6"] = {
        "steps": F6_STEPS,
        "parameters_digested": [len(g["digests"][0]["stages"]["local"])
                                for g in cli["first"]],
        "gru_calls_a_step": [len(g["digests"][0]["gru"])
                             for g in cli["first"]],
        "first_parting": _partings([g["digests"] for g in cli["first"]],
                                   [g["digests"] for g in cli["whole"]]),
        "products_recomputed_equal": all(
            row["product_recomputed_equal"] for name in ("first", "whole")
            for g in cli[name] for rec in g["digests"] for row in rec["gru"])}
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    report = check_model.main(["--run", run_dir, "--itr", str(first),
                               "--episode", "0", "--t-start",
                               str(EVAL_T_START), "--horizon",
                               str(EVAL_HORIZON), "--cwd", tmp])
    check_k1 = ck.launch_counts()["normalize_image"]
    d["check_model"] = {"seconds": time.perf_counter() - t0,
                        "k1_launches": check_k1,
                        "mse": report["mse"]}
    if not check_k1 or not _all_finite(report["mse"]):
        bad.append(f"(d) check_model: {d['check_model']}")
    record["d_cli"] = d
    record["wall_seconds"] = time.perf_counter() - t_phase
    emit(record)
    if bad:
        raise AssertionError(f"parallel/model_axis: {bad}")
    by_path = {}
    for r in (0, 1):
        by_path[f"parallel/model_axis/rank{r}/bf16"] = bf[f"rank{r}"][
            "k1_launches"]
    for name in cli:
        by_path[f"parallel/model_axis_cli/{name}"] = d[name]["k1_launches"]
    by_path["parallel/model_axis_cli/check_model"] = check_k1
    return by_path


def _collective_device_ms(trace_path: str, span: Optional[str] = None
                          ) -> dict:
    """In a Chrome trace of ``torch.profiler``: NCCL's kernels (ms, count),
    and the device work (kernels, copies, sets) launched inside the
    ``span`` spans (default ``parallel.mesh.SPAN``, around the step's
    all-reduces: the flat copies, the reduction and the division; matched
    to their launches by correlation id), and the spans' own host ms."""
    from multimodal_rssm_torch.parallel.mesh import SPAN

    span = span or SPAN
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    nccl = [e for e in device if "nccl" in e.get("name", "").lower()]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == span]
    launched = set()
    for e in events:
        if e.get("cat") != "cuda_runtime":
            continue
        for sp in spans:
            if (e.get("tid") == sp.get("tid")
                    and sp["ts"] <= e["ts"] <= sp["ts"] + sp.get("dur", 0)):
                launched.add(e.get("args", {}).get("correlation"))
                break
    mine = [e for e in device
            if e.get("args", {}).get("correlation") in launched]
    return {"nccl_ms": sum(e.get("dur", 0) for e in nccl) / 1e3,
            "nccl_kernels": len(nccl),
            "span_ms": sum(e.get("dur", 0) for e in mine) / 1e3,
            "span_device_events": len(mine), "spans": len(spans),
            "span_host_ms": sum(e.get("dur", 0) for e in spans) / 1e3}


def k1_under_a_mesh(device_name: str) -> dict:
    """K1 on one rank's shard of the main-path batch: rank 1 of 2 (offset
    25) and rank 1 of 2 under grad_accum 5 (rows 5-9, 15-19, ..., 45-49:
    its rows of each micro-batch of 10), each
    bit-equal to its plain version and to the plain version's rows of the
    global draw; device times of the shard's call against the unmapped
    call on the same block (CUDA graphs)."""
    import torch

    from multimodal_rssm_torch.ops import cuda_kernels as ck
    from multimodal_rssm_torch.parallel.mesh import BatchShard

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randint(0, 256, SHAPE, generator=g, device=dev,
                      dtype=torch.uint8).float()
    seed = torch.tensor(987654321, dtype=torch.int64, device=dev)
    whole = ck.normalize_image_plain(x, BIT_DEPTH, seed)
    out = {}
    for accum in (1, 5):
        shard = BatchShard(SHAPE[1], 1, 2, accum)
        rows = torch.as_tensor(shard.rows, device=dev)
        block = x.index_select(1, rows).contiguous()
        before = ck.normalize_image.launches
        got = ck.normalize_image(block, BIT_DEPTH, seed, shard.row_map)
        plain = ck.normalize_image_plain(block, BIT_DEPTH, seed,
                                         shard.row_map)
        torch.cuda.synchronize()
        if ck.normalize_image.launches != before + 1:
            raise AssertionError("parallel/k1: the shard's call launched "
                                 "no kernel")
        if not (torch.equal(got, plain)
                and torch.equal(got, whole.index_select(1, rows))):
            raise AssertionError(
                f"parallel/k1 accum {accum}: shard != plain version or the "
                f"global draw's rows, max |diff| "
                f"{float((got - whole.index_select(1, rows)).abs().max())}")
        n = block.numel()
        out[f"accum{accum}"] = {
            "row_map": shard.row_map._asdict(), "exact": True,
            "shard_ms": graph_time_ms(lambda: ck.normalize_image(
                block, BIT_DEPTH, seed, shard.row_map), 20),
            "unmapped_ms": graph_time_ms(lambda: ck.normalize_image(
                block, BIT_DEPTH, seed), 20),
            "bound_ms": n * 8 / hbm_rate(device_name) * 1e3}
    return out


def profiler_edges(seconds: float = 90.0, launches: int = 20) -> dict:
    """op_profile's window edges on the card: for ``seconds``, profiler
    windows (CPU and CUDA activity, one warm-up step, as op_profile) around
    ``launches`` small kernels, launched at once after the window opens and
    closed at once after the synchronise (gap 0), or
    ``core/profiling.EDGE_GAP_S`` from both edges, the two arms alternating;
    per arm the windows that lost a kernel, the kernels lost, and the least
    time from a kernel's launch (host clock) to its start (device clock) in
    the trace, which is negative where the two clocks part, with its first
    and last windows.  ``python3 chip_smoke.py --profiler-edges``."""
    import torch

    from multimodal_rssm_torch.core.profiling import EDGE_GAP_S

    x = torch.zeros(1 << 10, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    gaps = (0.0, EDGE_GAP_S)
    rows = {g: [] for g in gaps}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        while time.perf_counter() - t0 < seconds:
            gap = gaps[sum(map(len, rows.values())) % 2]
            with torch.profiler.profile(
                    activities=acts, schedule=torch.profiler.schedule(
                        wait=0, warmup=1, active=1, repeat=1)) as prof:
                x.add_(1)
                torch.cuda.synchronize()
                prof.step()
                time.sleep(gap)
                for _ in range(launches):
                    x.add_(1)
                torch.cuda.synchronize()
                time.sleep(gap)
                prof.step()
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            starts = {e["args"].get("correlation"): e["ts"] for e in events
                      if e.get("cat") == "kernel"}
            lead = [starts[e["args"].get("correlation")] - e["ts"]
                    for e in events if e.get("cat") == "cuda_runtime"
                    and "LaunchKernel" in e.get("name", "")
                    and e["args"].get("correlation") in starts]
            rows[gap].append({"age_s": time.perf_counter() - t0,
                              "kernels": len(starts),
                              "lead_us": min(lead) if lead else None})
    out = {"launches": launches, "seconds": seconds, "arms": {}}
    for gap, r in rows.items():
        leads = [w["lead_us"] for w in r if w["lead_us"] is not None]
        out["arms"][f"gap_{gap}"] = {
            "windows": len(r),
            "windows_short": sum(w["kernels"] < launches for w in r),
            "kernels_lost": sum(max(launches - w["kernels"], 0) for w in r),
            "windows_long": sum(w["kernels"] > launches for w in r),
            "min_lead_us": min(leads) if leads else None,
            "first": r[:3], "last": r[-3:]}
    return out


# --recompute-step: the arms (arm -> the ranks' work, fresh worlds or one,
# model_axis_cli_rank's ``strict``), the trials of an arm in one world, and
# the most fresh worlds an arm starts, stopping once this many have parted
RECOMPUTE_ARMS = {"cli": ("cli", True, None), "cli+flag": ("cli", True, "flag"),
                  "cli+fill": ("cli", True, "fill"),
                  "fresh": ("step", True, None),
                  "place": ("place", False, None),
                  "place+fresh": ("place", True, None)}
RECOMPUTE_TRIALS = 24
RECOMPUTE_WORLDS = 32
RECOMPUTE_PARTINGS = 3


def _strict(strict: Optional[str]) -> None:
    """Deterministic cuDNN; ``strict`` "flag" adds
    ``torch.use_deterministic_algorithms``, "fill" that and its fill of
    uninitialised memory."""
    import torch

    torch.backends.cudnn.deterministic = True
    if strict is not None:
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = (
            strict == "fill")


def recompute_rank(rank: int, nprocs: int, port: int, cards: int, tmp: str,
                   out_dir: str, name: str = "step") -> None:
    """One rank of arm "fresh"'s ``data=2 x model=2`` world, joined as
    (d)'s ranks join: (d)'s configuration (batch 8 x chunk 10, bf16, K1
    on, deterministic cuDNN), the weights from seed 0, one global batch of
    the replay with its draws and generator seed; step 1 (forward,
    backward, the data group's average, the replicated gradients'
    broadcast, the clip and Adam) with its staged digests
    (``parallel/digests.py``), without the train CLI.  Writes
    ``{name}{rank}.pt``."""
    import torch
    import torch.distributed as dist

    _join_as_torchrun(rank, nprocs, port, cards)
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.parallel.digests import StagedDigests
    from multimodal_rssm_torch.train import trainer as tr

    torch.backends.cudnn.deterministic = True
    cfg = compose(overrides=_model_axis_overrides(tmp, 1, "recompute"))
    dev = mesh_lib.init_distributed("cuda", timeout_s=PARALLEL_COLLECTIVE_S)
    try:
        dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, "cuda"),
                                    int(cfg.train.batch_size))
        D = build_buffer(cfg, seed=0)
        load_dataset(tmp, D, cfg.train.train_data_path)
        aug_spec = tr.build_aug_spec(D)
        obs, *rest = mesh_lib.shard_batch(
            D.sample(int(cfg.train.batch_size), int(cfg.train.chunk_size)),
            dp.train)
        raw = ({k: torch.from_numpy(v).to(dev) for k, v in obs.items()},
               *(torch.from_numpy(x).to(dev) for x in rest))
        draws = tr.HostAugmentDraws(D, aug_spec, seed=1).draw()
        model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
        init_parameters(model, torch.Generator().manual_seed(0))
        model.to(dev)
        opt, sched = tr.build_optimizer(cfg, model)
        tensor_lib.shard_model_(
            model, dp.model, int(cfg.train.mesh.get(
                "min_shard_width", tensor_lib.MIN_SHARD_WIDTH)), opt)
        train_step, _ = tr.make_train_step(model, cfg, opt, sched, aug_spec,
                                           dev, kernel_normalize=True, dp=dp)
        t0 = time.perf_counter()
        with StagedDigests(1) as digests:
            metrics = train_step(raw, draws,
                                 torch.Generator(dev).manual_seed(5))
        torch.save({"records": digests.records,
                    "losses": [float(metrics["loss"])],
                    "seconds": [time.perf_counter() - t0]},
                   os.path.join(out_dir, f"{name}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def placement_rank(rank: int, nprocs: int, port: int, cards: int, tmp: str,
                   out_dir: str, name: str = "place", trials: int = 1
                   ) -> None:
    """One rank of arm "place": (d)'s configuration placed as
    ``train/loop.run`` places it before the first step, ``trials`` times
    in this process: the dataset, the model initialised on the host from
    seed 0 and moved to the card, the feed's agreed budget
    (``select_feed``: two all-reduces), the validation replay, the
    weights' broadcast from rank 0 and the shard over the model group;
    each trial's weight digests at every point (``parallel/digests``'s
    ``weights/...``) and its first parameter's values there.  Writes
    ``{name}{rank}.pt``."""
    import torch
    import torch.distributed as dist

    _join_as_torchrun(rank, nprocs, port, cards)
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.data.device_buffer import DeviceReplay
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.parallel import digests as dg
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.train import loop
    from multimodal_rssm_torch.train import trainer as tr

    torch.backends.cudnn.deterministic = True
    cfg = compose(overrides=_model_axis_overrides(tmp, 1, "place"))
    dev = mesh_lib.init_distributed("cuda", timeout_s=PARALLEL_COLLECTIVE_S)
    try:
        dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, "cuda"),
                                    int(cfg.train.batch_size))
        D = build_buffer(cfg, seed=0)
        load_dataset(tmp, D, cfg.train.train_data_path)
        D_val = build_buffer(cfg, seed=1)
        load_dataset(tmp, D_val, cfg.train.validation_data_path)
        records, firsts, seconds = [], [], []
        for _ in range(trials):
            t0 = time.perf_counter()
            model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
            init_parameters(model, torch.Generator().manual_seed(0))
            digests = dg.weight_digests(model, "initialised")
            first = {"initialised": next(model.parameters()).detach().clone()}
            model.to(dev)
            tr.build_optimizer(cfg, model)
            loop.select_feed(cfg, D, dev, 0, dp)
            DeviceReplay(D_val, dev)
            digests.update(dg.weight_digests(model, "loaded"))
            first["loaded"] = next(model.parameters()).detach().cpu()
            mesh_lib.broadcast_module_(model)
            digests.update(dg.weight_digests(model, "broadcast"))
            first["broadcast"] = next(model.parameters()).detach().cpu()
            tensor_lib.shard_model_(model, dp.model, int(cfg.train.mesh.get(
                "min_shard_width", tensor_lib.MIN_SHARD_WIDTH)))
            digests.update(dg.weight_digests(model, "sharded"))
            records.append({"stages": {"inputs": digests}, "gru": []})
            firsts.append(first)
            seconds.append(time.perf_counter() - t0)
            del model
        torch.save({"records": records, "losses": [0.0] * trials,
                    "seconds": seconds, "first_parameter": firsts},
                   os.path.join(out_dir, f"{name}{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _first_parameter_parting(ranks: list, odd: list) -> list:
    """Arm "place": for each odd trial, where its first parameter differs
    from the usual trial's at each placement point: how many elements,
    the first and last flat index, the largest difference, and how many
    of the odd trial's values there are zero or not finite."""
    import torch

    out = []
    for o in odd:
        got = ranks[o["rank"]]
        usual = next(i for i in range(len(got["records"]))
                     if i not in {p["trial"] for p in odd
                                  if p["rank"] == o["rank"]})
        entry = {"trial": o["trial"], "rank": o["rank"]}
        for at, x in got["first_parameter"][o["trial"]].items():
            y = got["first_parameter"][usual][at]
            diff = (x != y).reshape(-1).nonzero().reshape(-1)
            if diff.numel():
                xd = x.reshape(-1)[diff]
                entry[at] = {
                    "elements": int(diff.numel()), "of": x.numel(),
                    "first": int(diff[0]), "last": int(diff[-1]),
                    "max_abs": float((xd - y.reshape(-1)[diff]).abs().max()),
                    "zero": int((xd == 0).sum()),
                    "nonfinite": int((~torch.isfinite(xd)).sum())}
        out.append(entry)
    return out


def _odd_trials(records: list) -> list:
    """The trials whose staged digests differ from the most frequent
    trial's, each as {"trial", and ``first_parting`` against it}."""
    from multimodal_rssm_torch.parallel.digests import first_parting

    keys = [json.dumps(r, sort_keys=True) for r in records]
    usual = collections.Counter(keys).most_common(1)[0][0]
    base = records[keys.index(usual)]
    return [{"trial": i, **first_parting([base], [r])}
            for i, (k, r) in enumerate(zip(keys, records)) if k != usual]


def _odd(ranks: list) -> list:
    """Every rank's odd trials, each with its rank."""
    return [{"rank": r, **o} for r, got in enumerate(ranks)
            for o in _odd_trials(got["records"])]


def recompute_step(tmp: str, arms=("cli",), trials: Optional[int] = None,
                   out: Optional[str] = None) -> dict:
    """F6's harness: for each arm of ``RECOMPUTE_ARMS``, ``data=2 x
    model=2`` worlds of (d)'s configuration on the card over gloo, whose
    ranks record the staged digests of step 1 (``parallel/digests.py``:
    inputs, forward, kernels, gradients) or of the weights' placement:

    - "cli", "cli+flag", "cli+fill": fresh worlds of (d)'s train CLI for
      one step (``model_axis_cli_rank``; its ``strict`` "flag" or "fill");
    - "fresh": fresh worlds of ``recompute_rank`` (the step without the
      CLI);
    - "place+fresh": fresh worlds of ``placement_rank``; "place": one world
      of it, ``trials`` trials (default ``RECOMPUTE_TRIALS``).

    An arm of fresh worlds starts at most ``trials`` (default
    ``RECOMPUTE_WORLDS``) and stops once ``RECOMPUTE_PARTINGS`` have
    parted; it compares world against world.  A trial or world parts where
    some rank's digests differ from its most frequent one's.  Each arm
    prints one line as it ends: trials or worlds, partings, and each
    parting's rank, step, first stage and first tensor or kernel; ``out``:
    a directory for the whole record (``recompute_step.json``: every
    parting's stages and RSSM steps).  ``python3 chip_smoke.py
    --recompute-step [arm ...] [--trials N] [--out DIR]``."""
    import torch

    from multimodal_rssm_torch.parallel import launch

    cards = torch.cuda.device_count()
    record = {"phase": "recompute_step",
              "batch": MODEL_AXIS_CLI_BATCH, "chunk": MODEL_AXIS_CLI_CHUNK,
              "arms": {}}
    for arm in arms:
        kind, fresh, strict = RECOMPUTE_ARMS[arm]
        out_dir = os.path.join(tmp, f"recompute_{arm}")
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        if fresh:
            ranks = _fresh_worlds(tmp, out_dir, trials or RECOMPUTE_WORLDS,
                                  cards, kind, strict)
        else:
            launch.spawn(placement_rank, 4, (
                4, _free_port(), cards, tmp, out_dir, "place",
                trials or RECOMPUTE_TRIALS), timeout=PARALLEL_WORLD_S)
            ranks = [torch.load(os.path.join(out_dir, f"place{r}.pt"),
                                weights_only=False) for r in range(4)]
        odd = _odd(ranks)
        runs = len(ranks[0]["records"])
        seconds = [t for got in ranks for t in got["seconds"][1:]]
        record["arms"][arm] = {
            "wall_seconds": time.perf_counter() - t0,
            "worlds": runs if fresh else 1, "trials": runs,
            "trial_seconds_median": statistics.median(seconds or [0.0]),
            "parted_trials": len({o["trial"] for o in odd}),
            "partings": odd,
            "losses": sorted({v for got in ranks for v in got["losses"]}),
            "gru_calls_a_step": len(ranks[0]["records"][0]["gru"]),
            "kernels_a_step": len(ranks[0]["records"][0]["stages"].get(
                "kernels", {})),
            "products_recomputed_equal": all(
                row["product_recomputed_equal"] for got in ranks
                for rec in got["records"] for row in rec["gru"])}
        summary = {k: v for k, v in record["arms"][arm].items()
                   if k != "partings"}
        summary["partings"] = [
            {k: o[k] for k in ("trial", "rank", "step", "first_stage",
                               "first")} for o in odd]
        if kind == "place":
            summary["first_parameter"] = record["arms"][arm][
                "first_parameter"] = _first_parameter_parting(ranks, odd)
        emit({"phase": "recompute_step", "arm": arm, **summary})
        if out is not None:
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "recompute_step.json"), "w") as f:
                json.dump(record, f, indent=1, default=str)
    return record


def _fresh_worlds(tmp: str, out_dir: str, n: int, cards: int, kind: str,
                  strict: Optional[str] = None) -> list:
    """The arms of fresh worlds: at most ``n`` worlds one after another,
    each in four fresh rank processes, until ``RECOMPUTE_PARTINGS`` have
    parted: (d)'s train CLI for one step (``kind`` "cli":
    ``model_axis_cli_rank``, as (d)'s runs start), ``recompute_rank``
    ("step") or ``placement_rank`` ("place"); each rank's staged digests,
    loss and seconds a world, as ``placement_rank`` gives them a trial."""
    import torch

    from multimodal_rssm_torch.parallel import launch

    ranks = [{"records": [], "losses": [], "seconds": []} for _ in range(4)]
    for i in range(n):
        name = f"{kind}_world_{i}"
        if kind == "cli":
            launch.spawn(model_axis_cli_rank, 4, (
                4, cards, [(name, _model_axis_cli_argv(tmp, 1, name),
                            _free_port())], out_dir, strict),
                timeout=PARALLEL_WORLD_S)
        else:
            launch.spawn(
                placement_rank if kind == "place" else recompute_rank, 4,
                (4, _free_port(), cards, tmp, out_dir, name),
                timeout=PARALLEL_WORLD_S)
        for r, got in enumerate(ranks):
            run = torch.load(os.path.join(
                out_dir, f"cli{r}_{name}.pt" if kind == "cli"
                else f"{name}{r}.pt"), weights_only=False)
            if kind == "cli":
                got["records"].append(run["digests"][0])
                got["losses"].append(run["result"]["metrics"]["loss"])
                got["seconds"].append(run["seconds"])
            else:
                for key in ("records", "losses", "seconds",
                            "first_parameter"):
                    if key in run:
                        got.setdefault(key, []).append(run[key][0])
        parted = sorted({o["trial"] for o in _odd(ranks)})
        print(f"recompute_step {kind} world {i}: "
              f"{ranks[0]['seconds'][-1]:.1f} s, parted so far {parted}",
              flush=True)
        if len(parted) >= RECOMPUTE_PARTINGS:
            break
    return ranks


# --init-draws: the kinds of fresh process, how many of each, and how many
# run at once (the kinds taken in turn, so that each meets the same load)
INIT_DRAW_KINDS = ("view", "parent", "serial", "port")
INIT_DRAW_PROCESSES, INIT_DRAW_AT_ONCE = 80, 6
_TRUNC_OPS = ("uniform_", "erfinv_", "mul_", "add_", "clamp_")


def _digest(x) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(x).tobytes()).hexdigest()[:12]


def _parent_draw(threads: Optional[int] = None) -> list:
    """The first parameter that the parent's ``init_parameters`` drew at
    the default width (``fc_embed_state_action``'s state columns, a
    [1024, 128] view of a [1024, 131] weight, from seed 0), made op by op
    as torch 2.11's ``nn.init.trunc_normal_`` makes it (the inverse CDF:
    ``_TRUNC_OPS``) on ``threads`` intra-op threads (default: the
    process's).  Returns a numpy copy of the view after each op (numpy's,
    so that no ATen op runs between the draw's own)."""
    import numpy as np
    import torch

    std = 128 ** -0.5 / 0.87962566103423978
    a, b = -2.0 * std, 2.0 * std
    lo, hi = (2 * ((1.0 + math.erf(x / math.sqrt(2.0))) / 2.0) - 1
              for x in (a / std, b / std))
    view = torch.zeros(1024, 131)[:, :128]
    g = torch.Generator().manual_seed(0)
    usual = torch.get_num_threads()
    torch.set_num_threads(threads or usual)
    out = []
    try:
        for op in (lambda: view.uniform_(lo, hi, generator=g), view.erfinv_,
                   lambda: view.mul_(std * math.sqrt(2.0)),
                   lambda: view.add_(0.0), lambda: view.clamp_(a, b)):
            op()
            out.append(np.array(view.numpy()))
    finally:
        torch.set_num_threads(usual)
    return out


def _view_draw() -> list:
    """The same block drawn as the parent's ``init_parameters`` drew it,
    ``nn.init.trunc_normal_`` straight on the view, with no copy between
    its ops; as ``_parent_draw``'s list, the result alone."""
    import numpy as np
    import torch
    from torch import nn

    std = 128 ** -0.5 / 0.87962566103423978
    view = torch.zeros(1024, 131)[:, :128]
    nn.init.trunc_normal_(view, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=torch.Generator().manual_seed(0))
    return [np.array(view.numpy())]


def _ops_apart(first: list, again: list) -> Optional[dict]:
    """The first op of ``_parent_draw`` whose output differs between two
    draws: its name, how many elements differ, their rows, and for up to
    four of them the uniform draw, both ``erfinv_`` outputs and the
    float64 inverse error function of the draw."""
    import numpy as np

    for i, (x, y) in enumerate(zip(first, again)):
        if not np.array_equal(x, y):
            rows, cols = np.nonzero(x != y)
            u = first[0][rows[:4], cols[:4]]
            exact = _erfinv64(u)
            return {"op": _TRUNC_OPS[i], "elements": int(rows.size),
                    "rows": sorted(set(rows.tolist()))[:8],
                    "uniform_equal": bool(np.array_equal(first[0], again[0])),
                    "at": [{"u": float(u[k]),
                            "erfinv_first": float(first[1][rows[k], cols[k]]),
                            "erfinv_again": float(again[1][rows[k], cols[k]]),
                            "erfinv_float64": float(exact[k])}
                           for k in range(len(u))]}
    return None


def _erfinv64(u) -> "numpy.ndarray":
    import torch

    return torch.erfinv(torch.from_numpy(u).double()).numpy()


def init_draw_one(kind: str) -> dict:
    """One fresh process of ``--init-draws``: the card's context made (as
    a rank's is before it initialises its model), then the first draw:
    ``kind`` "view" (``_view_draw``), "parent" (``_parent_draw`` on the
    process's threads), "serial" (the same on one thread) or "port" (this
    tree's ``init_parameters`` of the default-width world model).  All but
    "port" draw again; "parent" and "serial" name the first op apart
    (``_ops_apart``) if the two differ."""
    import torch

    torch.zeros(1, device="cuda")
    out = {"kind": kind, "threads": torch.get_num_threads()}
    if kind == "port":
        sys.path.insert(0, REPO)
        from multimodal_rssm_torch.core.config import compose
        from multimodal_rssm_torch.models.world_model import (
            WorldModel, init_parameters)
        from multimodal_rssm_torch.train import trainer as tr

        cfg = compose(overrides=[])
        model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
        init_parameters(model, torch.Generator().manual_seed(0))
        weight = model.get_parameter(
            next(n for n, _ in model.named_parameters()
                 if n.endswith("fc_embed_state_action.weight")))
        out["first_block"] = _digest(weight.detach()[:, :128].numpy())
        out["digest"] = _digest(torch.cat(
            [p.detach().reshape(-1) for p in model.parameters()]).numpy())
        return out
    if kind == "view":
        first, again = _view_draw(), _view_draw()
    else:
        threads = 1 if kind == "serial" else None
        first, again = _parent_draw(threads), _parent_draw(threads)
        out["apart"] = _ops_apart(first, again)
    out["digest"], out["again"] = _digest(first[-1]), _digest(again[-1])
    return out


def init_draws(out: Optional[str] = None) -> dict:
    """F6's first parameter draw, process by process: in this process,
    ``_parent_draw`` on 2-8 intra-op threads against one; then
    ``INIT_DRAW_PROCESSES`` fresh processes of each of
    ``INIT_DRAW_KINDS`` (``init_draw_one``), ``INIT_DRAW_AT_ONCE`` at a
    time (four ranks share a host so).  For each kind: the processes whose
    first draw differs from the kind's most frequent one, with the op
    where each parts from its own second draw; and whether the port's
    first block holds the parent's usual bits.  ``python3 chip_smoke.py
    --init-draws [--out DIR]``."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    one = _digest(_parent_draw(1)[-1])
    record = {"phase": "init_draws", "torch": torch.__version__,
              "default_threads": torch.get_num_threads(),
              "replica_is_trunc_normal": _digest(_view_draw()[0]) == one,
              "in_process_equal_to_one_thread": {
                  t: _digest(_parent_draw(t)[-1]) == one
                  for t in range(2, 9)}}
    emit(record)

    def run(kind):
        got = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--init-draw-one",
             kind], stdout=subprocess.PIPE, text=True, check=True)
        return json.loads(got.stdout.splitlines()[-1])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(INIT_DRAW_AT_ONCE) as pool:
        got = list(pool.map(run, INIT_DRAW_KINDS * INIT_DRAW_PROCESSES))
    record["seconds"] = time.perf_counter() - t0
    for kind in INIT_DRAW_KINDS:
        runs = [g for g in got if g["kind"] == kind]
        usual = collections.Counter(
            g["digest"] for g in runs).most_common(1)[0][0]
        odd = [g for g in runs if g["digest"] != usual]
        record[kind] = {
            "processes": len(runs), "odd": len(odd),
            "threads": sorted({g["threads"] for g in runs}),
            "odd_readings": odd[:10]}
        if kind == "port":
            record[kind]["first_block_is_parent_usual"] = sorted(
                {g["first_block"] for g in runs}) == [one]
        else:
            record[kind]["usual_is_one_thread"] = usual == one
            record[kind]["second_draw_odd"] = sum(
                g["again"] != usual for g in runs)
        emit({"phase": "init_draws", "kind": kind, **record[kind]})
    if out is not None:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "init_draws.json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def phase_parallel(tmp: str, device_name: str) -> dict:
    """Data parallelism (``train.mesh``) on the card.  (a) The train CLI at
    ``train.mesh.data=1`` (a one-rank NCCL world in this process) against
    the mesh-less CLI (none, then data=1; four alternated runs did not
    fit the script's time), 12 steps
    each, batch 50 x chunk 50, bf16, K1 on: steps/s over steps 3-9, peak
    memory, K1 once per step; the data=1 run traces steps 10-12 for NCCL's
    device time per step.  K1 on a shard (``k1_under_a_mesh``).  (b) Two
    ranks: NCCL on two cards where there are two, else both on this card
    over gloo (NCCL refuses two ranks on one GPU), launched through
    ``parallel.launch.spawn``: the float32 step (default augmentation,
    deterministic cuDNN, K1 on) of each rank held against a one-rank step
    here on the same global batch (``PARALLEL_F32_BATCH`` rows) and
    weights (``PARALLEL_*`` tolerances), the two ranks bit-equal; then the
    shipped bf16 settings for ``PARALLEL_BF16_STEPS`` steps and a
    validation through ``train.loop.run``: steps/s, each rank's peak
    memory and K1 launches.  Where two full-width ranks do not fit the
    card, both runs of (b) take ``rssm.remat=true`` (said in the record).
    Returns K1's launches by path."""
    import gc

    import torch
    import torch.multiprocessing  # noqa: F401 (ProcessRaisedException)

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.parallel import launch
    from multimodal_rssm_torch.train import trainer as tr

    t_phase = time.perf_counter()
    write_dataset(tmp, 4)
    record = {"phase": "parallel", "device": device_name,
              "batch": SHAPE[1], "chunk": SHAPE[0]}

    # (a) the CLI at train.mesh.data=1 against the mesh-less CLI
    common = [f"train.train_iteration={PARALLEL_STEPS}",
              f"train.validation_interval={PARALLEL_STEPS}"]
    runs = []
    for i, mesh in enumerate(("none", "data=1")):
        args = [*common, f"main.experiment_name=parallel_{i}"]
        if mesh != "none":
            args.append(f"train.mesh.{mesh}")
        if i == 1:
            args.append(f"train.profile_dir={tmp}/parallel_trace")
        rec, result, counts = train_run(f"parallel/{mesh}", tmp, args,
                                        PARALLEL_STEPS, "device_resident")
        if counts["normalize_image"] != PARALLEL_STEPS + 1:
            raise AssertionError(f"parallel/{mesh}: K1 launched "
                                 f"{counts['normalize_image']} times")
        entry = {"mesh": mesh, "steps_per_s_steps_3_9": 1.0 / statistics.median(
                     result["step_seconds"][PARALLEL_TIMED]),
                 "max_memory_allocated_GiB": rec["max_memory_allocated_GiB"],
                 "k1_launches": counts["normalize_image"],
                 "loss": rec["loss"]}
        if result["profile_trace"]:
            traced = 3   # steps 10-12
            c = _collective_device_ms(result["profile_trace"])
            if not c["spans"]:
                raise AssertionError("parallel: the trace holds no "
                                     "all-reduce span")
            entry["nccl_device_ms_per_step"] = c["nccl_ms"] / traced
            entry["nccl_kernels_per_step"] = c["nccl_kernels"] / traced
            entry["all_reduce_device_ms_per_step"] = c["span_ms"] / traced
            entry["all_reduce_device_events_per_step"] = (
                c["span_device_events"] / traced)
            entry["all_reduce_spans_per_step"] = c["spans"] / traced
        runs.append(entry)
        del result
    record["cli_runs"] = runs
    record["k1_under_a_mesh"] = k1_under_a_mesh(device_name)

    # (b) two ranks against one on the same global batch
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    record["two_ranks"] = {"backend": backend, "cards": cards,
                           "how": ("two cards over NCCL" if cards >= 2 else
                                   "two ranks sharing one card over gloo")}
    base = [f"train.train_data_path=[{tmp}/train]",
            f"train.validation_data_path=[{tmp}/validation]",
            f"train.batch_size={SHAPE[1]}", f"train.chunk_size={SHAPE[0]}",
            "train.experience_size=1000"]
    cfg = compose(overrides=base)
    D = build_buffer(cfg, seed=0)
    load_dataset(tmp, D, cfg.train.train_data_path)
    aug_spec = tr.build_aug_spec(D)
    raw = D.sample(PARALLEL_F32_BATCH, SHAPE[0])
    raw = ({k: torch.from_numpy(v) for k, v in raw[0].items()},
           *(torch.from_numpy(x) for x in raw[1:]))
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    lr = float(cfg.rssm.model_learning_rate)
    for remat in ("false", "true"):
        f32 = base + ["train.use_amp=false", f"rssm.remat={remat}",
                      f"train.batch_size={PARALLEL_F32_BATCH}"]
        bf16 = base + [
            f"train.train_iteration={PARALLEL_BF16_STEPS}",
            f"train.validation_interval={PARALLEL_BF16_STEPS}",
            "train.pallas_normalize=true", "train.mesh.data=2",
            f"rssm.remat={remat}", f"main.experiment_name=parallel_2r_{remat}"]
        spec = {"f32_overrides": f32, "bf16_overrides": bf16,
                "state_dict": model.state_dict(), "aug_spec": aug_spec,
                "raw": raw, "draws": tr.HostAugmentDraws(D, aug_spec,
                                                         seed=1).draw(),
                "seed": 5, "root": tmp}
        spec_path = os.path.join(tmp, "parallel_spec.pt")
        torch.save(spec, spec_path)
        out_dir = os.path.join(tmp, f"parallel_ranks_{remat}")
        os.makedirs(out_dir, exist_ok=True)
        try:
            torch.backends.cudnn.deterministic = True
            one = parallel_f32_step(spec, torch.device("cuda"), None)
            torch.backends.cudnn.deterministic = False
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with launch.file_rendezvous() as init_method:
                launch.spawn(parallel_rank, 2, (2, init_method, backend,
                                                spec_path, out_dir),
                             timeout=PARALLEL_WORLD_S)
            world_s = time.perf_counter() - t0
        except (torch.cuda.OutOfMemoryError,
                torch.multiprocessing.ProcessRaisedException) as e:
            torch.backends.cudnn.deterministic = False
            if remat == "true" or "out of memory" not in str(e).lower():
                raise
            emit({"phase": "parallel/two_ranks", "note": "two full-width "
                  "ranks do not fit the card: rssm.remat=true in both runs",
                  "error": str(e)[-400:]})
            gc.collect()
            torch.cuda.empty_cache()
            continue
        break
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    check = {"remat": remat == "true", "world_seconds": world_s,
             "one_rank": {"loss": one["metrics"]["loss"],
                          "k1_launches": one["k1_launches"],
                          "max_memory_allocated_GiB":
                              one["max_memory_allocated_GiB"]},
             "tolerance": {"loss_rtol": PARALLEL_LOSS_RTOL,
                           "param_rtol": PARALLEL_RTOL,
                           "param_atol": PARALLEL_ATOL,
                           "param_max_loose": PARALLEL_LOOSE,
                           "param_hard_abs": 2 * lr,
                           "stats_rtol": PARALLEL_STATS_RTOL,
                           "stats_atol_x_max": PARALLEL_STATS_ATOL}}
    bad = []
    for r, got in enumerate(ranks):
        f = got["f32"]
        loss_rel = abs(f["metrics"]["loss"] - one["metrics"]["loss"]) / abs(
            one["metrics"]["loss"])
        params = _two_tier(f["params"], one["params"], lr)
        stats = _stats_err(f["stats"], one["stats"])
        check[f"rank{r}"] = {
            "rows": [got["rows"][0], got["rows"][-1]],
            "loss": f["metrics"]["loss"], "loss_rel_err": loss_rel,
            "params": params, "stats_err_over_tol": stats,
            "k1_launches_f32": f["k1_launches"],
            "f32_max_memory_allocated_GiB": f["max_memory_allocated_GiB"]}
        if loss_rel > PARALLEL_LOSS_RTOL or not params["ok"] or stats > 1:
            bad.append(r)
        if f["k1_launches"] != 1:
            bad.append(f"rank {r}: K1 launched {f['k1_launches']} times")
    same = all(torch.equal(ranks[0]["f32"][part][k], ranks[1]["f32"][part][k])
               for part in ("params", "stats") for k in ranks[0]["f32"][part])
    check["ranks_bit_equal"] = same
    record["two_ranks"]["f32_check"] = check
    bf = {}
    for r, got in enumerate(ranks):
        b = got["bf16"]
        bf[f"rank{r}"] = {
            "steps_per_s_median_after_2": 1.0 / statistics.median(
                b["step_seconds"][2:-1]),
            "step_seconds": b["step_seconds"], "feed": b["feed"],
            "max_memory_allocated_GiB": b["max_memory_allocated_GiB"],
            "max_memory_reserved_GiB": b["max_memory_reserved_GiB"],
            "ranks_per_device": b["ranks_per_device"],
            "k1_launches": b["launches"]["normalize_image"],
            "loss": b["loss"], "validation_loss": b["validation_loss"]}
        if b["ranks_per_device"] != (1 if cards >= 2 else 2):
            bad.append(f"rank {r}: ranks_per_device "
                       f"{b['ranks_per_device']} with {cards} card(s)")
        if (b["launches"]["normalize_image"] != PARALLEL_BF16_STEPS + 1
                or not all(math.isfinite(v) for v in
                           (b["loss"], b["validation_loss"]))):
            bad.append(f"rank {r} bf16: {bf[f'rank{r}']}")
    dirs = {got["bf16"]["results_dir"] for got in ranks}
    if cards < 2:   # both ranks' contexts, libraries and collectives
        bf["card_used_beyond_reserved_GiB"] = ranks[0]["bf16"][
            "card_used_GiB"] - sum(got["bf16"]["reserved_GiB"]
                                   for got in ranks)
    record["two_ranks"]["bf16"] = bf
    record["two_ranks"]["run_dirs"] = len(dirs)
    record["wall_seconds"] = time.perf_counter() - t_phase
    emit(record)
    if bad or not same or len(dirs) != 1:
        raise AssertionError(f"parallel: two ranks against one: {bad}; "
                             f"ranks bit-equal {same}; run dirs {dirs}")
    by_path = {f"parallel/{r['mesh']}#{i}": r["k1_launches"]
               for i, r in enumerate(runs)}
    for r in (0, 1):
        by_path[f"parallel/two_ranks/rank{r}/bf16"] = bf[f"rank{r}"][
            "k1_launches"]
    by_path.update(phase_model_axis(tmp, device_name))   # (c), (d)
    return by_path


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)


def main() -> int:
    t_main = time.perf_counter()
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
    clock = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            clock[phase] = time.perf_counter() - t0

    timed("build", phase_build)
    kernel = timed("kernel", phase_kernel, name)
    launches, default = timed("train", phase_train)
    precision_k1 = timed("precision", phase_precision)
    with tempfile.TemporaryDirectory() as tmp:
        parallel_k1 = timed("parallel", phase_parallel, tmp, name)
    timed("feed", phase_feed, name)
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = timed("checkpoint", phase_checkpoint, tmp)
        eval_k1 = timed("eval", phase_eval, tmp, run_dir, name)
        control_k1 = timed("control", phase_control, tmp, run_dir, name)
        bridges_k1 = timed("bridges", phase_bridges, tmp, run_dir, name)
        with tempfile.TemporaryDirectory() as gate_tmp:
            gate = start_quality(gate_tmp)
            serve = phase_serve(tmp, run_dir, name)
            try:
                timed("serve", next, serve)   # the export and the checks
                quality = timed("waiting for quality", finish_quality, gate)
                timed("serve timing", next, serve, None)
            finally:
                serve.close()
                stop_quality(gate)
            clock["quality (beside serve)"] = quality["wall_seconds"]
    timed("budget", phase_budget,
          ((None, ()), (None, tuple(CODEC_RUNS["img256_groupnorm"]))))
    timed("parity", phase_parity)
    with tempfile.TemporaryDirectory() as tmp:
        variants_k1 = timed("variants", phase_variants, tmp, name)
    with tempfile.TemporaryDirectory() as tmp:
        codecs_k1, k1_shapes = timed("codecs", phase_codecs, tmp, name,
                                     default)
    fused = timed("fused_codec", phase_fused_codec, name, launches)
    tools_k1 = timed("tools", phase_tools_process)
    kernel["launches"] = launches["normalize_image"]
    kernel["launches_by_path"] = {
        "train": launches["normalize_image"],
        "estimate_state": eval_k1["estimate_state"],
        "check_model": eval_k1["check_model"], **control_k1["launches"],
        **bridges_k1, **variants_k1, **codecs_k1, **parallel_k1,
        **tools_k1, **precision_k1}
    kernel["eval_episode_shape_ms"] = eval_k1["episode_shape_ms"]
    kernel["agent_frame_shape"] = control_k1["frame_shape"]
    kernel["codec_shapes"] = k1_shapes
    emit({"phase": "total", "wall_seconds": time.perf_counter() - t_main,
          "phases": clock})
    emit({"kernels": [kernel, *fused]})
    print_card()
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--budget-run"]:   # phase_budget's fresh process
        sys.path.insert(0, REPO)
        arg = sys.argv[2] if len(sys.argv) > 2 else ""
        emit(budget_run(int(arg) if arg else None, sys.argv[3:]))
        sys.exit(0)
    if sys.argv[1:2] == ["--recompute-step"]:   # F6's harness
        sys.path.insert(0, REPO)
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        from multimodal_rssm_torch.core.device import configure_float32

        configure_float32()
        phase_build(force=False)
        args = sys.argv[2:]
        options = {}
        for flag, key, kind in (("--trials", "trials", int),
                                ("--out", "out", str)):
            if flag in args:
                i = args.index(flag)
                options[key] = kind(args[i + 1])
                del args[i:i + 2]
        with tempfile.TemporaryDirectory() as tmp:
            write_dataset(tmp, 4)
            recompute_step(tmp, tuple(args) or ("cli",), **options)
        print_card()
        sys.exit(0)
    if sys.argv[1:2] == ["--init-draw-one"]:   # init_draws's fresh process
        emit(init_draw_one(sys.argv[2]))
        sys.exit(0)
    if sys.argv[1:2] == ["--init-draws"]:   # F6's first draw, process by process
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        init_draws(sys.argv[3] if sys.argv[2:3] == ["--out"] else None)
        print_card()
        sys.exit(0)
    if sys.argv[1:2] == ["--profiler-edges"]:   # op_profile's window edges
        sys.path.insert(0, REPO)
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        emit(profiler_edges())
        print_card()
        sys.exit(0)
    if sys.argv[1:2] == ["--precision"]:   # phase precision alone
        sys.path.insert(0, REPO)
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        from multimodal_rssm_torch.core.device import configure_float32

        configure_float32()
        phase_build(force=False)
        emit({"precision_k1": phase_precision()})
        print_card()
        sys.exit(0)
    if sys.argv[1:2] == ["--tools"]:   # phase tools alone
        sys.path.insert(0, REPO)
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        from multimodal_rssm_torch.core.device import configure_float32

        configure_float32()
        # builds what is missing or stale: under the whole script, whose
        # phase build compiled every library moments before, nothing
        phase_build(force=False)
        with tempfile.TemporaryDirectory() as tmp:
            k1 = phase_tools(tmp, torch.cuda.get_device_name(0))
        print_card()
        emit({"tools_k1": k1})
        sys.exit(0)
    if sys.argv[1:2] == ["--model-axis"]:   # phase parallel's (c), (d) alone
        sys.path.insert(0, REPO)
        import torch

        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is visible")
        from multimodal_rssm_torch.core.device import configure_float32

        configure_float32()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            write_dataset(tmp, 4)
            emit({"model_axis_k1": phase_model_axis(
                tmp, torch.cuda.get_device_name(0), traced=True)})
        sys.exit(0)
    sys.exit(main())
