"""The training run: load the replay, build or restore the model, iterate.

Mirrors the reference's orchestration (algos/MRSSM/MRSSM/train.py:27-66):
train and validation buffers, the model (or ``train.model_path``),
``train_iteration`` steps with ``validation_interval`` and
``checkpoint_interval`` cadences, metrics to ``metrics.jsonl`` (and to
wandb under ``main.wandb``) in the JAX loop's order: the previous step's
train line and its ``frame`` line (step x global batch x chunk; none after
the run's last step), the validation line, the histogram lines.

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

``train.histogram_interval`` logs per-module histograms of the parameters
and of the gradients of one extra forward and backward on the step's batch
(``trainer.make_grad_fn``; its own generator, frozen running stats, no
optimizer) every N steps, so a run with them equals one without.
``train.profile_dir`` traces steps 10-15 after the first with
``torch.profiler`` (CPU and CUDA activities; ``core/profiling``: quiet at
both edges) into a Chrome trace there.

Checkpoints hold the whole training state, the NumPy generators' states
included, and are written atomically; cadence checkpoints are written off
the loop's thread (``io/checkpoint.py``).  A run resumes from its dir's
newest and continues the draws an uninterrupted run would make; on SIGTERM
/ SIGINT it writes one at the step reached.
Each step's metrics are read back after the next step has been queued, so
the host's work for step k + 1 overlaps the device's for step k.

``train.mesh.data`` / ``train.mesh.slice`` (``parallel/mesh.py``) train
data-parallel in a world of ranks, one process per GPU, which the train
CLI or ``torchrun`` starts: every rank loads the dataset and keeps its
replay, draws the global batch's indices and augmentation choices from the
shared seed and gathers only its rows (``DataParallel``, by its data-group
rank); the weights are broadcast from rank 0 after init or load; each step
averages gradients and metrics over the data group.  ``train.mesh.model``
> 1 then column-shards the wide weights over each model group
(``parallel/tensor.shard_model_``, at ``train.mesh.min_shard_width``) --
after the init, restore or load and the broadcast, so that restored Adam
moments are cut with their weights, as the JAX package's ``_place``.
Rank 0 alone creates the run dir and writes metrics, histograms, the
profile trace and the checkpoints (every rank loads the same file on
``--resume`` and ``train.model_path``); under a model axis every rank
first gathers the sharded weights and moments on the loop's thread (never
in the writer thread: the ranks' collectives must run in one order), so
every file holds whole tensors.  The device budget for the replay is
agreed over the world (the least over the ranks).  A preemption stop is
agreed too: each step all-reduces the ranks' stop flags over the world and
every rank reads the sum one step later, so all stop after the same step
and rank 0 writes that step's checkpoint (a rank stopping alone would
leave the others waiting in their next collective).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, Optional

import torch

from multimodal_rssm_torch.core.device import configure_float32, resolve_device
from multimodal_rssm_torch.core.profiling import ProfilerWindow
from multimodal_rssm_torch.core.runtime import GracefulShutdown
from multimodal_rssm_torch.data.buffer import (
    HostBatchFeed, build_buffer, load_dataset, to_device)
from multimodal_rssm_torch.data.device_buffer import (
    DeviceReplay, StreamingDeviceReplay, gather_batch, hbm_budget_bytes,
    step_reserve_bytes)
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io.metrics import (
    MetricLogger, NullLogger, make_run_dir, wandb_kwargs)
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.parallel import mesh as mesh_lib
from multimodal_rssm_torch.parallel import tensor as tensor_lib
from multimodal_rssm_torch.train import trainer as tr
from multimodal_rssm_torch.train.prefetch import Prefetcher


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def check_options(cfg) -> None:
    """Raise on options the port refuses (before anything is built)."""
    if not bool(cfg.train.get("async_checkpoint", True)):
        raise ValueError("train.async_checkpoint=false: the port writes "
                         "cadence checkpoints off the loop's thread only "
                         "(a synchronous save holds the loop for the whole "
                         "write); the key is kept for the JAX package's "
                         "config")


def ranks_per_device(device: torch.device,
                     dp: Optional[mesh_lib.DataParallel] = None) -> int:
    """Ranks of the world on this rank's card (under ``dp``), by the
    cards' UUIDs: right whatever each rank sees (every GPU of the host, or
    one card bound to it by the launcher).  1 on the CPU or outside a
    world."""
    if device.type != "cuda" or dp is None:
        return 1
    uuid = str(torch.cuda.get_device_properties(device).uuid).encode()
    mine = int.from_bytes(hashlib.sha1(uuid).digest()[:7], "little")
    ids = torch.zeros(torch.distributed.get_world_size(), dtype=torch.int64,
                      device=device)
    ids[torch.distributed.get_rank()] = mine
    torch.distributed.all_reduce(ids)
    return int((ids == mine).sum())


def log_histograms(logger: MetricLogger, model, grads: Dict[str, torch.Tensor],
                   step: int) -> None:
    """The parameters' and the gradients' histograms, per top-level module
    of ``model`` (``params_<module>/hist``, ``grads_<module>/hist``), of
    whole tensors: a sharded weight's blocks are gathered first (every
    rank calls it; ``logger`` writes on rank 0)."""
    for prefix, tensors in (
            ("params", tensor_lib.full_named(dict(model.named_parameters()),
                                             model)),
            ("grads", tensor_lib.full_named(grads, model))):
        logger.log_histograms(
            {mod: [tensors[f"{mod}.{n}"] for n, _ in child.named_parameters()]
             for mod, child in model.named_children()}, step, prefix)


class ProfileWindow:
    """A ``torch.profiler`` trace of steps ``first``..``last`` (CPU and, on
    CUDA, device activities) in a ``core/profiling.ProfilerWindow`` (quiet
    at both edges), written as a Chrome trace into ``out_dir``: the JAX
    package's ``jax.profiler`` window.  ``at_start(itr)`` before a step,
    ``at_end(itr)`` after it; ``close(itr)`` ends a trace the run left open
    (a run shorter than the window).  ``path``: the trace written, or None;
    ``summary``: the window's kernel and wall ms, idle share and
    hand-written kernel launches, or None."""

    def __init__(self, out_dir: str, first: int, last: int,
                 device: torch.device):
        self.out_dir, self.first, self.last = out_dir, first, last
        self.device = device
        self.window: Optional[ProfilerWindow] = None
        self.path: Optional[str] = None
        self.summary: Optional[Dict] = None

    def at_start(self, itr: int) -> None:
        if itr == self.first:
            self.window = ProfilerWindow(self.device).open()

    def at_end(self, itr: int) -> None:
        if itr == self.last:
            self.close(itr)

    def close(self, itr: Optional[int] = None) -> None:
        if self.window is None:
            return
        self.window.close()
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = self.window.export(os.path.join(
            self.out_dir, f"trace_steps_{self.first}-{itr or self.last}.json"))
        self.summary = self.window.summary()
        print(f"profile of steps {self.first}-{itr or self.last}: "
              f"{self.path}")
        self.window = None


def select_feed(cfg, D, device: torch.device, seed: int,
                dp: Optional[mesh_lib.DataParallel] = None):
    """(feed name, replay or None) by ``train.device_replay``; prints the
    path taken.  Under ``dp`` the budget is the least of the ranks' (each
    sized for its local batch and its share of the card), so every rank
    takes the same feed and draws the same indices."""
    mode = str(cfg.train.get("device_replay", "auto")).lower()
    if mode not in ("auto", "true", "stream", "false"):
        raise ValueError(f"train.device_replay={mode!r} not in "
                         "(auto, true, stream, false)")
    say = print if mesh_lib.is_main() else (lambda *a, **k: None)
    gib = 1 << 30
    rb = cfg.train.get("replay_budget_gb")
    ranks = 1 if dp is None else dp.train.size
    budget = (int(float(rb) * gib) if rb
              else hbm_budget_bytes(device, step_reserve_bytes(cfg, ranks),
                                    ranks_per_device(device, dp)))
    if dp is not None:
        agreed = torch.tensor([budget], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(agreed, torch.distributed.ReduceOp.MIN)
        budget = int(agreed.item())
    nbytes = DeviceReplay.nbytes(D)
    if mode == "true" or (mode == "auto" and DeviceReplay.fits(D, budget)):
        say(f"feed path: device-resident replay (train.device_replay="
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
            say(f"streaming replay unavailable ({e})")
        else:
            say(f"feed path: streaming device-resident working set "
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
    say(f"feed path: host-streamed batches ({why}); a prefetch thread "
        "gathers and copies the next batches")
    return "host", None


def load_model_path(cfg, cwd: str, model, optimizer, scheduler) -> None:
    """Start from ``train.model_path`` (relative to ``cwd``): a reference
    ``.pth`` (the model's weights), a port ``.pt`` checkpoint (model,
    optimizer and schedule) or a JAX package ``.msgpack`` (its whole
    TrainState, as the JAX loop restores it: weights, running stats, Adam's
    moments and count, the schedule's count).  The loop's step count starts
    at 0, as the JAX loop's does."""
    path = os.path.join(cwd, str(cfg.train.model_path))
    if not os.path.exists(path):
        raise FileNotFoundError(f"train.model_path {path} does not exist")
    if path.endswith(".pt"):
        ckpt.load_checkpoint(path, model, optimizer, scheduler)
    elif path.endswith(".msgpack"):
        ckpt.load_jax_train_state(path, model, optimizer, scheduler)
    else:
        ckpt.load_model_weights(path, model)
    if mesh_lib.is_main():
        print(f"model weights from {path}")


def run(cfg, cwd: str = ".", device: Optional[str] = None,
        resume_dir: Optional[str] = None) -> Dict:
    """One training run.  ``device``: "cuda" (default; raises without a
    GPU; a rank of a world: ``cuda:LOCAL_RANK``), "cuda:k" or "cpu".
    ``resume_dir``: continue that run dir from its newest checkpoint (step,
    model, optimizer, schedule and generator).  A ``train.mesh`` needs the
    world joined first (``parallel/mesh.init_distributed``; the train CLI
    does it).

    Returns the run dir, the model, the feed taken, the first step run,
    the last train and validation metrics (the global batch's), the
    wall-clock seconds of every step and the profile trace's path (or
    None)."""
    dev = resolve_device(device)
    configure_float32()
    check_options(cfg)
    mesh = mesh_lib.mesh_from_config(cfg, dev.type)
    main = mesh_lib.is_main()
    if cfg.main.experiment_name is None:
        cfg.main.experiment_name = "RSSM"
    seed = int(cfg.main.seed or 0)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)
    dp = (None if mesh is None else
          mesh_lib.data_parallel(mesh, B, tr.resolve_grad_accum(cfg)))
    if dp is not None and main:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{torch.distributed.get_world_size()} ranks "
              f"({torch.distributed.get_backend()}); "
              f"{dp.train.local_batch} rows of the batch of {B} a rank")
    D = build_buffer(cfg, seed=seed)
    load_dataset(cwd, D, cfg.train.train_data_path)
    D_val = build_buffer(cfg, seed=seed + 1)
    load_dataset(cwd, D_val, cfg.train.validation_data_path)

    model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
    init_parameters(model, torch.Generator().manual_seed(seed))
    tr.stage("weights", model, at="initialised")
    model.to(dev)
    optimizer, scheduler = tr.build_optimizer(cfg, model)
    aug_spec = tr.build_aug_spec(D)
    draws = tr.HostAugmentDraws(D, aug_spec, seed=seed)
    train_rows = None if dp is None else dp.train.rows
    eval_rows = None if dp is None else dp.eval.rows

    feed, replay = select_feed(cfg, D, dev, seed, dp)
    if replay is not None:
        val_replay = DeviceReplay(D_val, dev)
        train_step, eval_step = tr.make_device_resident_steps(
            model, cfg, optimizer, scheduler, aug_spec, dev,
            D.observation_names, replay.row_shapes, dp=dp)
    else:
        train_step, eval_step = tr.make_train_step(
            model, cfg, optimizer, scheduler, aug_spec, dev, dp=dp)
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
        if main:
            print(f"resumed from step {start_step}")
    elif resume_dir is not None and ckpt.latest_checkpoint(
            results_dir, (".msgpack",)):
        raise ValueError(
            f"{results_dir} holds the JAX package's checkpoints only: "
            "--resume continues a port run; start from one with "
            "train.model_path=<its models_N.msgpack>")
    elif cfg.train.model_path:
        load_model_path(cfg, cwd, model, optimizer, scheduler)
    tr.stage("weights", model, at="loaded")
    if dp is not None:
        mesh_lib.broadcast_module_(model)
        tr.stage("weights", model, at="broadcast")
    if dp is not None and dp.model is not None:
        spec = tensor_lib.shard_model_(
            model, dp.model,
            int(cfg.train.mesh.get("min_shard_width",
                                   tensor_lib.MIN_SHARD_WIDTH)), optimizer)
        if main:
            print(f"model axis: {len(spec)} weights column-sharded over "
                  f"{dp.model.size} ranks")

    total = int(cfg.train.train_iteration)
    val_every = int(cfg.train.validation_interval)
    ckpt_every = int(cfg.train.checkpoint_interval or 0)
    keep = int(cfg.train.get("keep_checkpoints", 0) or 0)
    refresh_every = max(1, int(cfg.train.get("stream_refresh_interval", 1)))
    hist_every = int(cfg.train.get("histogram_interval", 0) or 0)
    grad_fn = (tr.make_grad_fn(model, cfg, aug_spec, dev, dp) if hist_every
               else None)
    profile_dir = cfg.train.get("profile_dir")
    window = (ProfileWindow(os.path.join(cwd, str(profile_dir)),
                            start_step + 10, start_step + 15, dev)
              if profile_dir and main else None)
    saver = ckpt.AsyncCheckpointer() if main else None
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

    def stop_flags() -> Optional[torch.Tensor]:
        """The ranks' stop requests summed over the world (queued; read a
        step later)."""
        if dp is None:
            return None
        flag = torch.full((1,), float(shutdown.requested), device=dev)
        torch.distributed.all_reduce(flag)
        return flag

    def saved_state():
        """(model, optimizer) for a checkpoint: the objects, or under a
        model axis their whole state_dicts (every rank gathers)."""
        if dp is None or dp.model is None:
            return model, optimizer
        return (tensor_lib.full_state_dict(model),
                tensor_lib.full_optimizer_state_dict(model, optimizer))

    step_seconds = []
    last, last_val = {}, {}
    completed = last_saved = start_step
    stop = False   # agreed under dp (the flags read a step late)
    shutdown = GracefulShutdown()
    logger = (MetricLogger(results_dir,
                           use_wandb=bool(cfg.main.get("wandb", False)),
                           wandb_kwargs=wandb_kwargs(cfg, cwd, results_dir))
              if main else NullLogger())
    with logger, shutdown:
        prefetcher = (Prefetcher(HostBatchFeed(D, B, L, dev, train_rows),
                                 depth=2, device=dev)
                      if replay is None else None)
        try:
            pending = None
            t_prev = t_start = time.perf_counter()
            for itr in range(start_step + 1, total + 1):
                if stop or (dp is None and shutdown.requested):
                    break
                if window is not None:
                    window.at_start(itr)
                step_draws = draws.draw()
                if replay is not None:
                    idxs = replay.sample_indices(B, L, train_rows)
                    metrics = train_step(replay.arrays, idxs, step_draws,
                                         generator)
                else:
                    buffer_state, batch = prefetcher.get()
                    metrics = train_step(batch, step_draws, generator)
                hist_grads = None
                if hist_every and itr % hist_every == 0:
                    # the step's batch and draws again, with a generator
                    # of its own: no stream of the run advances (before
                    # the stream's refresh replaces the batch's rows)
                    if replay is not None:
                        batch = gather_batch(replay.arrays, idxs,
                                             D.observation_names,
                                             replay.row_shapes)
                    hist_grads = grad_fn(
                        batch, step_draws,
                        torch.Generator(dev).manual_seed(seed + itr))
                if feed == "stream" and itr % refresh_every == 0:
                    replay.refresh()
                flags = stop_flags()
                if pending is not None:
                    last = _host(pending[1])
                    logger.log(last, pending[0], "train")
                    logger.log_frame_count(pending[0], B, L)
                    stop = stop or (pending[2] is not None
                                    and float(pending[2]) > 0)
                pending = (itr, metrics, flags)
                if itr % val_every == 0:
                    if replay is not None:
                        vmetrics = eval_step(
                            val_replay.arrays,
                            val_replay.sample_indices(B, L, eval_rows),
                            draws.draw(), generator)
                    else:
                        vmetrics = eval_step(
                            to_device(D_val.sample(B, L, eval_rows), dev),
                            draws.draw(), generator)
                    last_val = _host(vmetrics)
                    logger.log(last_val, itr, "validation")
                if hist_grads is not None:
                    log_histograms(logger, model, hist_grads, itr)
                if ckpt_every and itr % ckpt_every == 0:
                    state = saved_state()
                    if saver is not None:
                        saver.save(results_dir, itr, *state, scheduler,
                                   state_extra(), keep=keep)
                    del state
                    last_saved = itr
                completed = itr
                if window is not None:
                    window.at_end(itr)
                now = time.perf_counter()
                step_seconds.append(now - t_prev)
                t_prev = now
        finally:
            if prefetcher is not None:
                prefetcher.close()
            if window is not None:
                window.close(completed)
        if pending is not None:
            last = _host(pending[1])
            logger.log(last, pending[0], "train")
            stop = stop or (pending[2] is not None and float(pending[2]) > 0)
        requested = stop if dp is not None else shutdown.requested
        if saver is not None:
            saver.wait()   # the write in flight; raises the writer's error
        if (requested and completed > last_saved
                and bool(cfg.train.get("checkpoint_on_preempt", True))):
            state = saved_state()   # every rank: the stop is agreed
            if saver is not None:
                path = ckpt.save_checkpoint(results_dir, completed, *state,
                                            scheduler, state_extra())
                print(f"preempted at step {completed}; checkpoint saved to "
                      f"{path}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t_start
        if completed > start_step:
            logger.log({"steps_per_sec": (completed - start_step) / elapsed},
                       completed, "perf")
    if dp is not None:   # rank 0's files are written before any rank returns
        mesh_lib.barrier(dev)
    return {"results_dir": results_dir, "model": model, "feed": feed,
            "start_step": start_step, "metrics": last,
            "validation_metrics": last_val, "step_seconds": step_seconds,
            "profile_trace": None if window is None else window.path,
            "profile": None if window is None else window.summary,
            "preempted": requested}
