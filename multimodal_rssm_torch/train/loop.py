"""The training loop: load the replay, build the model, iterate.

Mirrors the reference's orchestration (algos/MRSSM/MRSSM/train.py:27-66):
train and validation buffers, model build, ``train_iteration`` steps with a
``validation_interval`` cadence, metrics to ``metrics.jsonl``.  Batches are
sampled on the host and copied through pinned memory.  Each step's metrics
are read back after the next step has been queued, so the host's work for
step k+1 overlaps the device's for step k.  Checkpoints, resume and a
device-resident replay wait for a later slice of the port.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from multimodal_rssm_torch.core.device import configure_float32, resolve_device
from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset, to_device
from multimodal_rssm_torch.io.metrics import MetricLogger, make_run_dir
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.train import trainer as tr


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def run(cfg, cwd: str = ".", device: Optional[str] = None) -> Dict:
    """One training run.  ``device``: "cuda" (default; raises without a
    GPU) or "cpu".  Returns the run dir, the model, the last train and
    validation metrics and the wall-clock seconds of every step."""
    dev = resolve_device(device)
    configure_float32()
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
    train_step, eval_step = tr.make_train_step(
        model, cfg, optimizer, scheduler, aug_spec, dev)
    generator = torch.Generator(dev).manual_seed(seed)

    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)
    total = int(cfg.train.train_iteration)
    val_every = int(cfg.train.validation_interval)
    results_dir = make_run_dir(cfg, cwd)
    step_seconds = []
    last, last_val = {}, {}
    with MetricLogger(results_dir) as logger:
        pending = None
        t_prev = time.perf_counter()
        t_start = t_prev
        for itr in range(1, total + 1):
            batch = to_device(D.sample(B, L), dev)
            metrics = train_step(batch, draws.draw(), generator)
            if pending is not None:
                last = _host(pending[1])
                logger.log(last, pending[0], "train")
            pending = (itr, metrics)
            if itr % val_every == 0:
                vbatch = to_device(D_val.sample(B, L), dev)
                last_val = _host(eval_step(vbatch, draws.draw(), generator))
                logger.log(last_val, itr, "validation")
            now = time.perf_counter()
            step_seconds.append(now - t_prev)
            t_prev = now
        if pending is not None:
            last = _host(pending[1])
            logger.log(last, pending[0], "train")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t_start
        if total:
            logger.log({"steps_per_sec": total / elapsed}, total, "perf")
    return {"results_dir": results_dir, "model": model, "metrics": last,
            "validation_metrics": last_val, "step_seconds": step_seconds}
