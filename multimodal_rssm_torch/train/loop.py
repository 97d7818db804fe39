"""The training run: load the replay, build or restore the model, iterate.

Mirrors the reference's orchestration (algos/MRSSM/MRSSM/train.py:27-66):
train and validation buffers, the model (or ``train.model_path``),
``train_iteration`` steps with ``validation_interval`` and
``checkpoint_interval`` cadences, metrics to ``metrics.jsonl``.

The feed follows ``train.device_replay`` (auto | true | stream | false):
- ``device_resident``: the whole loaded dataset on the device
  (``DeviceReplay``); a step receives an [n, L] index matrix;
- ``stream``: a device-resident working set of whole segments
  (``StreamingDeviceReplay``), refreshed every ``stream_refresh_interval``
  steps;
- ``host``: batches gathered on the host and copied by a prefetch thread.
"auto" takes the first that fits the device budget (``hbm_budget_bytes``
or ``train.replay_budget_gb``).  Validation batches come from a fully
resident validation set on the device feeds.  Every draw of indices and
augmentation choices happens in a fixed order (on the loop's thread, or for
the host feed in its prefetch thread from the buffer's own generator), so
a seed fixes the run.

Checkpoints hold the whole training state, the NumPy generators' states
included, and are written atomically; cadence checkpoints are written off
the loop's thread (``io/checkpoint.py``).  A run resumes from its dir's
newest and continues the draws an uninterrupted run would make; on SIGTERM
/ SIGINT it writes one at the step reached.
Each step's metrics are read back after the next step has been queued, so
the host's work for step k + 1 overlaps the device's for step k.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from multimodal_rssm_torch.core.device import configure_float32, resolve_device
from multimodal_rssm_torch.core.runtime import GracefulShutdown
from multimodal_rssm_torch.data.buffer import (
    HostBatchFeed, build_buffer, load_dataset, to_device)
from multimodal_rssm_torch.data.device_buffer import (
    DeviceReplay, StreamingDeviceReplay, hbm_budget_bytes, step_reserve_bytes)
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io.metrics import MetricLogger, make_run_dir
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.train import trainer as tr
from multimodal_rssm_torch.train.prefetch import Prefetcher

def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def _check_options(cfg) -> None:
    if not bool(cfg.train.get("async_checkpoint", True)):
        raise ValueError("train.async_checkpoint=false: the port writes "
                         "cadence checkpoints off the loop's thread only "
                         "(a synchronous save holds the loop for the whole "
                         "write); the key is kept for the JAX package's "
                         "config")
    if int(cfg.train.get("histogram_interval", 0) or 0) > 0:
        raise NotImplementedError("train.histogram_interval > 0: parameter "
                                  "and gradient histograms wait for a later "
                                  "slice of the port")
    if cfg.train.get("profile_dir"):
        raise NotImplementedError("train.profile_dir: use python -m "
                                  "multimodal_rssm_torch.cli.profile_step")


def select_feed(cfg, D, device: torch.device, seed: int):
    """(feed name, replay or None) by ``train.device_replay``; prints the
    path taken."""
    mode = str(cfg.train.get("device_replay", "auto")).lower()
    if mode not in ("auto", "true", "stream", "false"):
        raise ValueError(f"train.device_replay={mode!r} not in "
                         "(auto, true, stream, false)")
    gib = 1 << 30
    rb = cfg.train.get("replay_budget_gb")
    budget = (int(float(rb) * gib) if rb
              else hbm_budget_bytes(device, step_reserve_bytes(cfg)))
    nbytes = DeviceReplay.nbytes(D)
    if mode == "true" or (mode == "auto" and DeviceReplay.fits(D, budget)):
        print(f"feed path: device-resident replay (train.device_replay="
              f"{mode}; dataset {nbytes / gib:.3f} GiB, budget "
              f"{budget / gib:.3f} GiB)")
        return "device_resident", DeviceReplay(D, device)
    if mode in ("auto", "stream"):
        try:
            replay = StreamingDeviceReplay(
                D, chunk_size=int(cfg.train.chunk_size), device=device,
                budget_bytes=budget,
                segment_len=int(cfg.train.get("stream_segment_len", 0) or 0)
                or None,
                refresh_segments=int(cfg.train.get("stream_refresh_segments",
                                                   1)),
                seed=seed)
        except ValueError as e:
            if mode == "stream":
                raise
            print(f"streaming replay unavailable ({e})")
        else:
            print(f"feed path: streaming device-resident working set "
                  f"(dataset {nbytes / gib:.3f} GiB, budget "
                  f"{budget / gib:.3f} GiB; {replay.W} of "
                  f"{replay.n_host_segments} segments of {replay.S} rows "
                  f"resident, {replay.refresh_segments} replaced every "
                  f"{int(cfg.train.get('stream_refresh_interval', 1))} "
                  "steps)")
            return "stream", replay
    why = ("train.device_replay=false" if mode == "false" else
           f"dataset {nbytes / gib:.3f} GiB over the {budget / gib:.3f} GiB "
           "budget and too small to stream")
    print(f"feed path: host-streamed batches ({why}); a prefetch thread "
          "gathers and copies the next batches")
    return "host", None


def load_model_path(cfg, cwd: str, model, optimizer, scheduler) -> None:
    """Start from ``train.model_path`` (relative to ``cwd``): a reference
    ``.pth`` (the model's weights) or a port ``.pt`` checkpoint (model,
    optimizer and schedule; the step count starts at 0)."""
    path = os.path.join(cwd, str(cfg.train.model_path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"train.model_path {path} does not exist")
    if path.endswith(".pt"):
        ckpt.load_checkpoint(path, model, optimizer, scheduler)
    else:
        ckpt.load_model_weights(path, model)
    print(f"model weights from {path}")


def run(cfg, cwd: str = ".", device: Optional[str] = None,
        resume_dir: Optional[str] = None) -> Dict:
    """One training run.  ``device``: "cuda" (default; raises without a
    GPU) or "cpu".  ``resume_dir``: continue that run dir from its newest
    checkpoint (step, model, optimizer, schedule and generator).

    Returns the run dir, the model, the feed taken, the first step run,
    the last train and validation metrics and the wall-clock seconds of
    every step."""
    dev = resolve_device(device)
    configure_float32()
    _check_options(cfg)
    if cfg.main.experiment_name is None:
        cfg.main.experiment_name = "RSSM"
    seed = int(cfg.main.seed or 0)
    D = build_buffer(cfg, seed=seed)
    load_dataset(cwd, D, cfg.train.train_data_path)
    D_val = build_buffer(cfg, seed=seed + 1)
    load_dataset(cwd, D_val, cfg.train.validation_data_path)

    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    optimizer, scheduler = tr.build_optimizer(cfg, model)
    aug_spec = tr.build_aug_spec(D)
    draws = tr.HostAugmentDraws(D, aug_spec, seed=seed)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)

    feed, replay = select_feed(cfg, D, dev, seed)
    if replay is not None:
        val_replay = DeviceReplay(D_val, dev)
        train_step, eval_step = tr.make_device_resident_steps(
            model, cfg, optimizer, scheduler, aug_spec, dev,
            D.observation_names, replay.row_shapes)
    else:
        train_step, eval_step = tr.make_train_step(
            model, cfg, optimizer, scheduler, aug_spec, dev)
    generator = torch.Generator(dev).manual_seed(seed)

    results_dir = make_run_dir(cfg, cwd, resume_dir)
    start_step = 0
    restored = ckpt.restore_or_none(results_dir, model, optimizer, scheduler)
    if restored is not None:
        start_step, extra = restored
        generator.set_state(extra["generator"])
        rng = extra["rng"]
        D.rng.bit_generator.state = rng["buffer"]
        D_val.rng.bit_generator.state = rng["validation"]
        draws.rng.bit_generator.state = rng["augment"]
        if feed == "stream" and "stream" in rng:
            replay.set_state(rng["stream"])
        print(f"resumed from step {start_step}")
    elif cfg.train.model_path:
        load_model_path(cfg, cwd, model, optimizer, scheduler)

    total = int(cfg.train.train_iteration)
    val_every = int(cfg.train.validation_interval)
    ckpt_every = int(cfg.train.checkpoint_interval or 0)
    keep = int(cfg.train.get("keep_checkpoints", 0) or 0)
    refresh_every = max(1, int(cfg.train.get("stream_refresh_interval", 1)))
    saver = ckpt.AsyncCheckpointer()
    # the buffer generator's state after the last batch a step took (the
    # host feed's prefetch thread draws ahead)
    buffer_state = D.rng.bit_generator.state

    def state_extra():
        rng = {"buffer": (buffer_state if replay is None
                          else D.rng.bit_generator.state),
               "validation": D_val.rng.bit_generator.state,
               "augment": draws.rng.bit_generator.state}
        if feed == "stream":
            rng["stream"] = replay.state()
        return {"generator": generator.get_state(), "rng": rng}

    step_seconds = []
    last, last_val = {}, {}
    completed = last_saved = start_step
    shutdown = GracefulShutdown()
    with MetricLogger(results_dir) as logger, shutdown:
        prefetcher = (Prefetcher(HostBatchFeed(D, B, L, dev), depth=2,
                                 device=dev)
                      if replay is None else None)
        try:
            pending = None
            t_prev = t_start = time.perf_counter()
            for itr in range(start_step + 1, total + 1):
                if shutdown.requested:
                    break
                step_draws = draws.draw()
                if replay is not None:
                    metrics = train_step(replay.arrays,
                                         replay.sample_indices(B, L),
                                         step_draws, generator)
                    if feed == "stream" and itr % refresh_every == 0:
                        replay.refresh()
                else:
                    buffer_state, batch = prefetcher.get()
                    metrics = train_step(batch, step_draws, generator)
                if pending is not None:
                    last = _host(pending[1])
                    logger.log(last, pending[0], "train")
                pending = (itr, metrics)
                if itr % val_every == 0:
                    if replay is not None:
                        vmetrics = eval_step(val_replay.arrays,
                                             val_replay.sample_indices(B, L),
                                             draws.draw(), generator)
                    else:
                        vmetrics = eval_step(to_device(D_val.sample(B, L), dev),
                                             draws.draw(), generator)
                    last_val = _host(vmetrics)
                    logger.log(last_val, itr, "validation")
                if ckpt_every and itr % ckpt_every == 0:
                    saver.save(results_dir, itr, model, optimizer, scheduler,
                               state_extra(), keep=keep)
                    last_saved = itr
                completed = itr
                now = time.perf_counter()
                step_seconds.append(now - t_prev)
                t_prev = now
        finally:
            if prefetcher is not None:
                prefetcher.close()
        if pending is not None:
            last = _host(pending[1])
            logger.log(last, pending[0], "train")
        saver.wait()   # the write in flight; raises the writer's error
        if (shutdown.requested and completed > last_saved
                and bool(cfg.train.get("checkpoint_on_preempt", True))):
            path = ckpt.save_checkpoint(
                results_dir, completed, model, optimizer, scheduler,
                state_extra())
            print(f"preempted at step {completed}; checkpoint saved to {path}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t_start
        if completed > start_step:
            logger.log({"steps_per_sec": (completed - start_step) / elapsed},
                       completed, "perf")
    return {"results_dir": results_dir, "model": model, "feed": feed,
            "start_step": start_step, "metrics": last,
            "validation_metrics": last_val, "step_seconds": step_seconds}
