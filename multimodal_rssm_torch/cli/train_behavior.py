"""Behavior (actor-critic) training on top of a trained world model.

    python -m multimodal_rssm_torch.cli.train_behavior --run-dir RUN_DIR \\
        [--model-path PATH] [--cwd .] [--device cuda|cpu] \\
        [behavior.horizon=15 behavior.train_iteration=2000 ...]

``--run-dir`` is a world-model training run (its ``hydra_config.yaml``;
the weights: its newest ``models_*.pt`` or JAX package
``models_*.msgpack``, or ``--model-path``, a port ``.pt``, a reference
``.pth`` or a JAX package ``.msgpack``).  The run's train set feeds the imagination
starts by the train loop's ``train.device_replay`` rule (the replay on the
device, whole or streamed, or host batches behind a prefetch thread;
relative data paths from ``--cwd``).  The actor, the value head and their
metrics land in ``{run_dir}/behavior/`` (``models_{itr}.pt``,
``metrics.jsonl``).  Runs on the GPU unless ``--device cpu``; without a
GPU it raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence


class StepClock:
    """Each step's seconds, from the end of the step before (the first from
    the clock's start).  On CUDA the ends are events recorded on the
    current stream, read once in ``seconds`` (which waits for the last):
    the loop never waits for the device to time a step, and a step's time
    is the device's, idle gaps included.  Elsewhere the host's clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: List = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> List[float]:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv`` and train; returns the behavior dir, the world model,
    the behavior state, the feed taken, the last logged metrics and each
    step's seconds (``StepClock``)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--run-dir", required=True,
                        help="world-model run dir (hydra_config.yaml + ckpt)")
    parser.add_argument("--model-path", default=None,
                        help="explicit checkpoint (.pt, reference .pth or JAX "
                             ".msgpack); default: the newest models_*.pt "
                             "or .msgpack in --run-dir")
    parser.add_argument("--cwd", default=".",
                        help="base of the run's relative data paths")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    import torch

    from multimodal_rssm_torch.core.config import (
        apply_overrides, load_run_config)
    from multimodal_rssm_torch.core.device import (
        configure_float32, resolve_device)
    from multimodal_rssm_torch.data.buffer import (
        HostBatchFeed, build_buffer, load_dataset)
    from multimodal_rssm_torch.data.device_buffer import gather_batch
    from multimodal_rssm_torch.eval.state_estimation import load_eval_model
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.io.metrics import MetricLogger
    from multimodal_rssm_torch.train import behavior as bh
    from multimodal_rssm_torch.train import trainer as tr
    from multimodal_rssm_torch.train.loop import select_feed
    from multimodal_rssm_torch.train.prefetch import Prefetcher

    dev = resolve_device(args.device)
    configure_float32()
    cfg = apply_overrides(load_run_config(args.run_dir), args.overrides)
    bh.behavior_cfg(cfg)
    model_path = args.model_path or ckpt.latest_checkpoint(args.run_dir)
    if model_path is None:
        raise FileNotFoundError(
            f"no models_*.pt or .msgpack under {args.run_dir}")
    print(f"world model: {model_path}")
    model = load_eval_model(cfg, model_path, dev)

    seed = int(cfg.main.seed or 0)
    D = build_buffer(cfg, seed=seed)
    load_dataset(args.cwd, D, cfg.train.train_data_path)
    aug_spec = tr.build_aug_spec(D)
    draws = tr.HostAugmentDraws(D, aug_spec, seed=seed)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)
    feed, replay = select_feed(cfg, D, dev, seed)
    refresh_every = max(1, int(cfg.train.get("stream_refresh_interval", 1)))

    bstate = bh.init_behavior_state(cfg, dev, seed)
    step_fn = bh.BehaviorStep(model, cfg, aug_spec, dev)
    generator = torch.Generator(dev).manual_seed(seed)
    out_dir = os.path.join(args.run_dir, "behavior")
    os.makedirs(out_dir, exist_ok=True)

    b = cfg.behavior
    iters = int(b.train_iteration)
    host = {}
    # each step's end, marked on the device's stream: nothing in the loop
    # waits for the device except the logged metrics' copy to the host
    clock = StepClock(dev)
    prefetcher = (Prefetcher(HostBatchFeed(D, B, L, dev), depth=2,
                             device=dev) if replay is None else None)
    try:
        with MetricLogger(out_dir) as logger:
            t0 = time.perf_counter()
            for itr in range(1, iters + 1):
                if replay is not None:
                    batch = gather_batch(replay.arrays,
                                         replay.sample_indices(B, L),
                                         D.observation_names,
                                         replay.row_shapes)
                    if feed == "stream" and itr % refresh_every == 0:
                        replay.refresh()
                else:
                    _, batch = prefetcher.get()
                metrics = step_fn(bstate, batch, draws.draw(), generator)
                clock.mark()
                if itr % int(b.log_interval) == 0 or itr == iters:
                    host = {k: float(v) for k, v in metrics.items()}
                    host["steps_per_sec"] = itr / (time.perf_counter() - t0)
                    logger.log(host, itr)
                    print(f"[{itr}/{iters}] actor {host['actor_loss']:.4f} "
                          f"value {host['value_loss']:.4f} "
                          f"return {host['imag_return']:.4f} "
                          f"({host['steps_per_sec']:.2f} it/s)", flush=True)
                if itr % int(b.checkpoint_interval) == 0 or itr == iters:
                    path = ckpt.save_behavior_checkpoint(out_dir, itr, bstate)
                    print(f"saved {path}")
    finally:
        if prefetcher is not None:
            prefetcher.close()
    return {"out_dir": out_dir, "model": model, "state": bstate, "feed": feed,
            "metrics": host, "step_seconds": clock.seconds()}


if __name__ == "__main__":
    main()
