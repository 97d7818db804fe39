"""The ranks of ``test_torch_port_parallel.py``'s worlds (gloo on the CPU).

Each function here runs as ``fn(rank, ...)`` in a process that
``multimodal_rssm_torch.parallel.launch.spawn`` starts, joins its world
through a ``file://`` rendezvous and writes what it saw to
``{out_dir}/{case}_{rank}.pt`` for the test to assert on.  Imports neither
JAX nor the JAX package (a spawned rank starts a fresh interpreter).
"""

import os
import signal

import torch
import torch.distributed as dist

from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
from multimodal_rssm_torch.data.buffer import HostBatchFeed
from multimodal_rssm_torch.data.device_buffer import (
    DeviceReplay, StreamingDeviceReplay, gather_batch)
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.parallel import feed
from multimodal_rssm_torch.parallel import mesh as mesh_lib
from multimodal_rssm_torch.parallel import tensor as tensor_lib
from multimodal_rssm_torch.parallel.digests import StagedDigests
from multimodal_rssm_torch.train import trainer as tr

TIMEOUT_S = 300.0   # a collective (or the rendezvous) waiting longer fails
CPU = torch.device("cpu")


def _join(rank, nprocs, init_method):
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=init_method, rank=rank,
                              world_size=nprocs, timeout_s=TIMEOUT_S)


def _model(cfg, state_dict, device=CPU):
    model = WorldModel.from_config(cfg)
    model.load_state_dict(state_dict)
    return model.to(device)


def _result(model, metrics):
    """The metrics, the whole parameters (a sharded weight's blocks
    gathered), this rank's blocks of the sharded weights and the running
    stats, on the CPU."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: p.cpu().clone() for n, p in
                       tensor_lib.full_named(params, model).items()},
            "blocks": {n: params[n].cpu().clone()
                       for n in tensor_lib.sharded(model)},
            "stats": {k: v.cpu().clone()
                      for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def deterministic_step(cfg, state_dict, batch, dp, device=CPU):
    """One clipped Adam step on ``dp``'s rows of a prepared global batch,
    deterministic (no generator), on ``device``: the step the tests hold
    against the JAX package's on the whole batch.  Under ``dp.model`` the
    weights are column-sharded first (``train.mesh.min_shard_width``)."""
    model = _model(cfg, state_dict, device)
    opt, sched = tr.build_optimizer(cfg, model)
    if dp is not None and dp.model is not None:
        tensor_lib.shard_model_(model, dp.model,
                                int(cfg.train.mesh.min_shard_width), opt)
    local = batch if dp is None else mesh_lib.shard_batch(batch, dp.train)
    observations, *rest = local
    local = ({k: v.to(device) for k, v in observations.items()},
             *(x.to(device) for x in rest))
    metrics = tr.optimizer_step(
        model, tr.make_loss_fn(model, cfg), local, None, opt, sched,
        tr.resolve_grad_accum(cfg), float(cfg.rssm.grad_clip_norm), dp)
    return _result(model, metrics)


def full_step(cfg, state_dict, raw, val_raw, seed, dp):
    """The train step (input pipeline with its draws, K1's plain version,
    the sampled rollout) and a validation step on ``dp``'s rows of raw
    global batches, from the generator ``seed``."""
    model = _model(cfg, state_dict)
    opt, sched = tr.build_optimizer(cfg, model)
    train_step, eval_step = tr.make_train_step(
        model, cfg, opt, sched, raw["spec"], CPU, kernel_normalize=True,
        dp=dp)
    g = torch.Generator().manual_seed(seed)
    batch, vbatch = raw["batch"], val_raw
    if dp is not None:
        batch = mesh_lib.shard_batch(batch, dp.train)
        vbatch = mesh_lib.shard_batch(vbatch, dp.eval)
    metrics = train_step(batch, raw["draws"], g)
    vmetrics = eval_step(vbatch, raw["draws"], g)
    out = _result(model, metrics)
    out["validation"] = {k: float(v) for k, v in vmetrics.items()}
    return out


def step_world(rank, nprocs, init_method, in_path, out_dir):
    """The step cases (``inputs["cases"]``: name -> overrides), each on the
    same weights and batches; then the mesh refusals that need a world."""
    _join(rank, nprocs, init_method)
    inputs = torch.load(in_path, weights_only=False)
    for name, (kind, overrides) in inputs["cases"].items():
        cfg = compose(overrides=inputs["overrides"] + list(overrides))
        mesh = mesh_lib.mesh_from_config(cfg, "cpu")
        dp = mesh_lib.data_parallel(mesh, int(cfg.train.batch_size),
                                    tr.resolve_grad_accum(cfg))
        if kind == "deterministic":
            out = deterministic_step(cfg, inputs["state_dict"],
                                     inputs["batch"], dp)
        else:
            out = full_step(cfg, inputs["state_dict"], inputs["raw"],
                            inputs["val_raw"], inputs["seed"], dp)
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out["rows"] = dp.train.rows.tolist()
        torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    refusals = {}
    try:
        mesh_lib.create_mesh(4, 1, "cpu")
    except ValueError as e:
        refusals["mesh_over_world"] = str(e)
    try:
        mesh_lib.mesh_from_config(compose(overrides=["train.mesh.data=0"]))
    except ValueError as e:
        refusals["world_without_mesh"] = str(e)
    torch.save(refusals, os.path.join(out_dir, f"refusals_{rank}.pt"))
    dist.destroy_process_group()


def feed_world(rank, nprocs, init_method, overrides, data_dir, out_dir):
    """Each feed's local blocks gathered back to the global batch, beside a
    one-process draw of the same seed: the device-resident replay, the
    streaming working set and the host feed's producer."""
    _join(rank, nprocs, init_method)
    cfg = compose(overrides=overrides)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)
    dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, "cpu"), B,
                                tr.resolve_grad_accum(cfg))

    def buffer():
        D = build_buffer(cfg, seed=3)
        load_dataset(data_dir, D, "train")
        return D

    names = buffer().observation_names
    out = {}
    for kind in ("device", "stream", "host"):
        local_buffer, oracle_buffer = buffer(), buffer()
        if kind == "host":
            _, local = HostBatchFeed(local_buffer, B, L, CPU,
                                     dp.train.rows)()
            _, whole = HostBatchFeed(oracle_buffer, B, L, CPU)()
        else:
            if kind == "device":
                replays = [DeviceReplay(b, CPU)
                           for b in (local_buffer, oracle_buffer)]
            else:
                replays = [StreamingDeviceReplay(b, L, CPU, 1 << 14,
                                                 segment_len=2 * L, seed=5)
                           for b in (local_buffer, oracle_buffer)]
            local = gather_batch(
                replays[0].arrays, replays[0].sample_indices(
                    B, L, dp.train.rows), names, replays[0].row_shapes)
            whole = gather_batch(replays[1].arrays,
                                 replays[1].sample_indices(B, L), names,
                                 replays[1].row_shapes)
        out[kind] = {"local": local,
                     "gathered": feed.global_batch_from_local(local, dp),
                     "oracle": whole,
                     "cut": mesh_lib.shard_batch(whole, dp.train)}
    torch.save(out, os.path.join(out_dir, f"feed_{rank}.pt"))
    dist.destroy_process_group()


def sigterm_world(rank, nprocs, init_method, argv, signal_rank, signal_step,
                  out_dir):
    """The train CLI's run in a world where rank ``signal_rank`` alone
    receives SIGTERM during its step ``signal_step``."""
    from multimodal_rssm_torch.cli import train as cli_train

    _join(rank, nprocs, init_method)
    if rank == signal_rank:
        make = tr.make_device_resident_steps

        def with_sigterm(*args, **kwargs):
            train_step, eval_step = make(*args, **kwargs)
            calls = []

            def step(*a):
                calls.append(1)
                if len(calls) == signal_step:
                    signal.raise_signal(signal.SIGTERM)
                return train_step(*a)

            return step, eval_step

        tr.make_device_resident_steps = with_sigterm
    parser = cli_train._parser()
    result = cli_train._train(parser.parse_args(argv), parser, "cpu")
    torch.save({k: v for k, v in result.items() if k != "model"},
               os.path.join(out_dir, f"sigterm_{rank}.pt"))
    dist.destroy_process_group()


def cli_digest_world(rank, nprocs, init_method, argv, name, out_dir,
                     flip_rank=None):
    """The train CLI's run in a fresh world of ranks, each recording its
    staged digests (``parallel/digests.py``) of the first step; rank
    ``flip_rank`` first flips one bit of its first raw batch (the lowest
    bit of the first byte of the first observation it gathers)."""
    from multimodal_rssm_torch.cli import train as cli_train

    _join(rank, nprocs, init_method)
    if rank == flip_rank:
        gather = tr.gather_batch

        def flipped(*args, **kwargs):
            observations, *rest = gather(*args, **kwargs)
            first = next(iter(observations.values()))
            first.view(-1).view(torch.uint8)[0] ^= 1
            tr.gather_batch = gather
            return (observations, *rest)

        tr.gather_batch = flipped
    parser = cli_train._parser()
    with StagedDigests(1) as digests:
        cli_train._train(parser.parse_args(argv), parser, "cpu")
    torch.save(digests.records,
               os.path.join(out_dir, f"{name}_{rank}.pt"))
    dist.destroy_process_group()


def model_axis_world(rank, nprocs, init_method, in_path, out_dir):
    """The model-axis step cases of this world's size (``inputs["cases"]``:
    name -> (world size, overrides)), each on the same weights and batch,
    with this rank's groups and its staged digests (the case
    ``inputs["digested"]`` twice); in a world of 2, the refusals of meshes
    that do not cover it."""
    _join(rank, nprocs, init_method)
    inputs = torch.load(in_path, weights_only=False)
    for name, (size, overrides) in inputs["cases"].items():
        if size != nprocs:
            continue
        cfg = compose(overrides=inputs["overrides"] + list(overrides))
        mesh = mesh_lib.mesh_from_config(cfg, "cpu")
        dp = mesh_lib.data_parallel(mesh, int(cfg.train.batch_size),
                                    tr.resolve_grad_accum(cfg))
        runs = []
        for _ in range(2 if name == inputs.get("digested") else 1):
            with StagedDigests(1) as digests:
                out = deterministic_step(cfg, inputs["state_dict"],
                                         inputs["batch"], dp)
            runs.append(digests.records)
        out["digests"] = runs
        out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        out["rows"] = dp.train.rows.tolist()
        out["data_rank"], out["model_rank"] = dp.train.rank, dp.model.rank
        out["model_size"] = dp.model.size
        torch.save(out, os.path.join(out_dir, f"{name}_{rank}.pt"))
    if nprocs == 2:
        refusals = {}
        for key, over in (("mesh", ["train.mesh.data=2",
                                    "train.mesh.model=2"]),
                          ("no_data", ["train.mesh.data=-1",
                                       "train.mesh.model=4"])):
            try:
                mesh_lib.mesh_from_config(compose(overrides=over), "cpu")
            except ValueError as e:
                refusals[key] = str(e)
        try:
            mesh_lib.create_mesh(2, 2, "cpu")
        except ValueError as e:
            refusals["create_mesh"] = str(e)
        torch.save(refusals, os.path.join(out_dir, f"refusals_{rank}.pt"))
    dist.destroy_process_group()


def gpu_model_axis_world(rank, nprocs, init_method, backend, in_path,
                         out_dir):
    """``deterministic_step`` at ``train.mesh.model=2`` on the card (both
    ranks on card 0 over gloo, or a card each over NCCL), deterministic
    cuDNN, no TF32: ``tests/test_torch_port_gpu.py``'s model-axis world."""
    from multimodal_rssm_torch.core.device import configure_float32

    configure_float32()
    torch.backends.cudnn.deterministic = True
    dev = mesh_lib.init_distributed(
        "cuda:0" if backend == "gloo" else f"cuda:{rank}", backend,
        init_method, rank, nprocs, TIMEOUT_S)
    inputs = torch.load(in_path, weights_only=False)
    cfg = compose(overrides=inputs["overrides"] + ["train.mesh.data=1",
                                                   "train.mesh.model=2"])
    dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, "cuda"),
                                int(cfg.train.batch_size))
    out = deterministic_step(cfg, inputs["state_dict"], inputs["batch"], dp,
                             dev)
    out["model_rank"] = dp.model.rank
    torch.save(out, os.path.join(out_dir, f"gpu_model_axis_{rank}.pt"))
    dist.destroy_process_group()

