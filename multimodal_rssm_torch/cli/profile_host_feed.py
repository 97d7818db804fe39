"""Where the host-streamed feed's time goes: each host-side component of
the ``train.device_replay=false`` path timed alone at the default COBOTTA
scale (batch 50 x chunk 50), then the composed loop with and without the
prefetch thread.

    python -m multimodal_rssm_torch.cli.profile_host_feed [--batch-size 50 --chunk-size 50]
        [--episodes 4] [--episode-length 120] [--reps 10] [--device cuda|cpu]

Prints a JSON dict of per-component milliseconds (the median of ``--reps``
calls after 2 warm-up calls; the JAX package's
``scripts/profile_host_feed.py`` keys):

- ``sample_indices_ms``: the buffer's chunk draw, [B, L] indices;
- ``host_gather_ms``: the C++ gather (``data/native.py``) of those chunks
  into pinned staging memory, as the host feed gathers;
- ``batch_mb``, ``transfer_ms``, ``transfer_mb_per_s``: copying the
  gathered batch from pinned memory to the device, synchronised;
- ``aug_draw_ms``: one step's augmentation draws (``HostAugmentDraws``);
- ``device_batch_blocked_ms``: draw + gather + copy as the prefetch thread
  runs it (``data/buffer.HostBatchFeed``), synchronised;
- ``compiled_step_ms``: the name kept for comparison with the JAX records;
  in the port it is the eager train step on a batch already on the device
  (no host feed), synchronised by reading the loss;
- ``sync_feed_step_ms``: a batch from ``HostBatchFeed`` then the step, on
  one thread;
- ``prefetch_feed_step_ms``: the step on batches from the prefetch thread
  (``train/prefetch.Prefetcher``, depth 2), as the loop runs it;
- ``ncpu``: the host's cores.

Every device wait is ``torch.cuda.synchronize()`` or the loss's read,
never a sleep.  The replay is ``--episodes`` synthetic episodes written
straight into the ring buffer (``cli/_profiling_common``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from multimodal_rssm_torch.cli._profiling_common import (
    add_device_argument, build_model, compose_config, fill_synthetic_buffer,
    setup_device, synchronize)


def timeit(fn: Callable[[], object], n: int = 10, warmup: int = 2) -> float:
    """Median host milliseconds of ``fn()`` over ``n`` calls after
    ``warmup``."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv``, time the components, print and return them."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--batch-size", type=int, default=50)
    parser.add_argument("--chunk-size", type=int, default=50)
    parser.add_argument("--episodes", type=int, default=4)
    parser.add_argument("--episode-length", type=int, default=120)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--override", action="append", default=[])
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.data.buffer import (
        HostBatchFeed, build_buffer, to_device)
    from multimodal_rssm_torch.train import trainer as tr
    from multimodal_rssm_torch.train.prefetch import Prefetcher

    dev = setup_device(args.device)
    cfg = compose_config([f"train.batch_size={args.batch_size}",
                          f"train.chunk_size={args.chunk_size}",
                          "train.experience_size=20000", *args.override])
    D = fill_synthetic_buffer(build_buffer(cfg), cfg, episodes=args.episodes,
                              ep_len=args.episode_length)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)

    def timed(fn):
        return timeit(fn, n=args.reps)

    out = {}
    # 1. index sampling (the rejection loop, B draws)
    out["sample_indices_ms"] = timed(lambda: D.sample_indices(B, L))

    # 2. the native gather into pinned staging memory
    idxs = D.sample_indices(B, L)
    staging = D.gather(idxs)
    pin = dev.type == "cuda"
    obs, act, rew, nt = (
        {k: torch.from_numpy(v).pin_memory() if pin else torch.from_numpy(v)
         for k, v in staging[0].items()},
        *(torch.from_numpy(x).pin_memory() if pin else torch.from_numpy(x)
          for x in staging[1:]))
    into = ({k: v.numpy() for k, v in obs.items()}, act.numpy(), rew.numpy(),
            nt.numpy())
    out["host_gather_ms"] = timed(lambda: D.gather(idxs, out=into))

    # 3. one gathered batch to the device, blocked
    leaves = [*obs.values(), act, rew, nt]
    nbytes = sum(t.nbytes for t in leaves)
    out["batch_mb"] = round(nbytes / 1e6, 1)

    def transfer():
        moved = [t.to(dev, non_blocking=pin) for t in leaves]
        synchronize(dev)
        return moved

    out["transfer_ms"] = timed(transfer)
    out["transfer_mb_per_s"] = round(
        nbytes / 1e6 / (out["transfer_ms"] / 1e3), 1)

    # 4. augmentation draws
    spec = tr.build_aug_spec(D)
    draws_src = tr.HostAugmentDraws(D, spec)
    out["aug_draw_ms"] = timed(draws_src.draw)

    # 5. draw + gather + copy, as the prefetch thread runs it
    feed = HostBatchFeed(D, B, L, dev)

    def device_batch():
        return feed()[1]

    def device_batch_blocked():
        batch = device_batch()
        synchronize(dev)
        return batch

    out["device_batch_blocked_ms"] = timed(device_batch_blocked)

    # 6. the step alone on a batch already on the device
    model, optimizer, scheduler = build_model(cfg, dev)
    generator = torch.Generator(dev).manual_seed(0)
    train_step, _ = tr.make_train_step(model, cfg, optimizer, scheduler,
                                       spec, dev)
    fixed = to_device(D.sample(B, L), dev)
    synchronize(dev)
    float(train_step(fixed, draws_src.draw(), generator)["loss"])

    def step_only():
        float(train_step(fixed, draws_src.draw(), generator)["loss"])

    out["compiled_step_ms"] = timed(step_only)

    # 7. composed: the host feed on the loop's thread (no prefetcher)
    def sync_loop():
        float(train_step(device_batch(), draws_src.draw(), generator)["loss"])

    out["sync_feed_step_ms"] = timed(sync_loop)

    # 8. composed: the prefetch thread, depth 2 (the loop's host feed)
    pf = Prefetcher(HostBatchFeed(D, B, L, dev), depth=2, device=dev)
    try:
        def pf_loop():
            float(train_step(pf.get()[1], draws_src.draw(),
                             generator)["loss"])

        out["prefetch_feed_step_ms"] = timed(pf_loop)
    finally:
        pf.close()

    out["ncpu"] = os.cpu_count()
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
