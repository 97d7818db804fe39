"""Mesh-size scaling sweep: train-step throughput at a list of mesh shapes.

    python -m multimodal_rssm_torch.cli.bench_scaling --meshes 1x1,2x1 --virtual-cpu 2 --small
    python -m multimodal_rssm_torch.cli.bench_scaling --meshes 1x1 --steps 20   # one card

The port's counterpart of the JAX package's ``scripts/bench_scaling.py``
(same flags, rows and ``efficiency_vs_first``).  Each ``DATAxMODEL`` shape
runs the device-resident train step of the train loop at
``train.mesh.data`` x ``train.mesh.model`` ranks: one shape of one rank in
this process without a mesh (as the JAX script runs it), a larger one as
that many ranks started through ``parallel/launch.spawn`` and joined as
the train CLI joins them (``parallel/mesh.init_distributed``, its backend
by ``mesh.default_backend``: NCCL with a card a rank, gloo on the CPU and
where ranks share a card), the model's weights column-sharded over each
model group.  The global batch grows with the data axis (weak scaling)
unless ``--fixed-batch``.  3 warm-up steps, then ``--steps`` steps
synchronised at the end by reading the loss.

``--virtual-cpu N`` runs up to N gloo ranks on the CPU: the numbers then
validate the harness and the collectives' layout, not throughput (a
warning says so).  On the card a shape of more ranks than the host has
cards puts several ranks on one card over gloo: its row carries
``"shared_card": true`` and the same warning.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from multimodal_rssm_torch.cli._profiling_common import (
    SMALL, add_device_argument, build_model, compose_config,
    fill_synthetic_buffer, setup_device)

WARNING = "numbers validate the harness, not throughput"


def parse_meshes(spec: str):
    out = []
    for item in spec.split(","):
        d, m = item.lower().split("x")
        out.append((int(d), int(m)))
    return out


def measure(cfg, device: torch.device, steps: int, dp=None, warmup: int = 3):
    """(steps/s, the last loss) of ``steps`` device-resident train steps
    after ``warmup``; under ``dp`` this rank's share of the global batch,
    the weights broadcast from rank 0 and sharded over the model group as
    the train loop does."""
    from multimodal_rssm_torch.data.buffer import build_buffer
    from multimodal_rssm_torch.data.device_buffer import DeviceReplay
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.parallel import tensor as tensor_lib
    from multimodal_rssm_torch.train import trainer as tr

    D = fill_synthetic_buffer(build_buffer(cfg), cfg)
    model, optimizer, scheduler = build_model(cfg, device)
    if dp is not None:
        mesh_lib.broadcast_module_(model)
        if dp.model is not None:
            tensor_lib.shard_model_(
                model, dp.model,
                int(cfg.train.mesh.get("min_shard_width",
                                       tensor_lib.MIN_SHARD_WIDTH)),
                optimizer)
    spec = tr.build_aug_spec(D)
    draws_src = tr.HostAugmentDraws(D, spec)
    generator = torch.Generator(device).manual_seed(0)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)
    rows = None if dp is None else dp.train.rows
    replay = DeviceReplay(D, device)
    train_step, _ = tr.make_device_resident_steps(
        model, cfg, optimizer, scheduler, spec, device, D.observation_names,
        replay.row_shapes, dp=dp)

    def run_step():
        return train_step(replay.arrays, replay.sample_indices(B, L, rows),
                          draws_src.draw(), generator)

    for _ in range(warmup):
        metrics = run_step()
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = run_step()
    loss = float(metrics["loss"])
    return steps / (time.perf_counter() - t0), loss


def _rank(rank: int, nprocs: int, init_method: str, device: str,
          overrides: List[str], steps: int, out_path: str) -> None:
    """One rank of a shape (``parallel/launch.spawn``): join the world,
    measure; rank 0 writes (steps/s, loss) to ``out_path``."""
    import torch.distributed as dist

    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.train.trainer import resolve_grad_accum

    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    if device == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
        name = "cpu"
    else:
        name = f"cuda:{rank % torch.cuda.device_count()}"
    dev = mesh_lib.init_distributed(name, init_method=init_method, rank=rank,
                                    world_size=nprocs)
    configure_float32()
    try:
        cfg = compose_config(overrides)
        dp = mesh_lib.data_parallel(mesh_lib.mesh_from_config(cfg, dev.type),
                                    int(cfg.train.batch_size),
                                    resolve_grad_accum(cfg))
        sps, loss = measure(cfg, dev, steps, dp)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump([sps, loss], f)
    finally:
        dist.destroy_process_group()


def run_shape(n_data: int, n_model: int, overrides: List[str], steps: int,
              device: torch.device):
    """(steps/s, loss) of one mesh shape."""
    from multimodal_rssm_torch.parallel import launch

    if n_data * n_model == 1:
        return measure(compose_config(overrides), device, steps)
    nprocs = n_data * n_model
    overrides = [*overrides, f"train.mesh.data={n_data}",
                 f"train.mesh.model={n_model}"]
    with launch.file_rendezvous() as init_method, \
            tempfile.TemporaryDirectory(prefix="mrssm_scaling_") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        launch.spawn(_rank, nprocs, (nprocs, init_method, device.type,
                                     overrides, steps, out_path))
        with open(out_path) as f:
            return tuple(json.load(f))


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parse ``argv``, measure each shape, print its row; returns the
    rows."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--meshes", default="1x1",
                        help="comma list of DATAxMODEL mesh shapes")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=50,
                        help="per-data-shard batch (weak scaling)")
    parser.add_argument("--chunk-size", type=int, default=50)
    parser.add_argument("--fixed-batch", action="store_true",
                        help="keep the global batch at --batch-size "
                             "regardless of mesh size (strong scaling)")
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--virtual-cpu", type=int, default=0, metavar="N",
                        help="up to N gloo ranks on the CPU (harness "
                             "validation only)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON line per mesh shape")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    if args.virtual_cpu:
        print(f"WARNING: {args.virtual_cpu} gloo ranks on the CPU — "
              f"{WARNING}", file=sys.stderr)
        device = setup_device("cpu")
        n_avail = args.virtual_cpu
    else:
        device = setup_device(args.device)
        n_avail = (torch.cuda.device_count() if device.type == "cuda"
                   else 1)
    results = []
    for n_data, n_model in parse_meshes(args.meshes):
        n_dev = n_data * n_model
        shared = device.type == "cuda" and n_dev > n_avail
        if n_dev > n_avail and not shared:
            print(f"{n_data}x{n_model}: skipped (needs {n_dev} devices, "
                  f"have {n_avail})", flush=True)
            continue
        if shared:
            print(f"WARNING: {n_data}x{n_model}: {n_dev} ranks share "
                  f"{n_avail} card(s) over gloo — {WARNING}", file=sys.stderr)
        B = args.batch_size if args.fixed_batch else args.batch_size * n_data
        overrides = [f"train.batch_size={B}",
                     f"train.chunk_size={args.chunk_size}",
                     "train.experience_size=20000"]
        if args.small:
            overrides += [*SMALL, "train.mesh.min_shard_width=1"]
        sps, loss = run_shape(n_data, n_model, overrides, args.steps, device)
        frames = sps * B * args.chunk_size
        row = {"mesh": f"{n_data}x{n_model}", "devices": n_dev,
               "global_batch": B, "steps_per_sec": round(sps, 3),
               "frames_per_sec": round(frames, 1), "loss": round(loss, 2)}
        if results:
            base = results[0]
            row["efficiency_vs_first"] = round(
                (frames / n_dev) / (base["frames_per_sec"] / base["devices"]),
                3)
        if shared:
            row["shared_card"] = True
        results.append(row)
        if args.json:
            print(json.dumps(row), flush=True)
        else:
            eff = row.get("efficiency_vs_first")
            print(f"{row['mesh']:>5s}  B={B:<4d} {sps:7.3f} steps/s  "
                  f"{frames:10.0f} frames/s"
                  + (f"  per-chip eff {eff:.2f}" if eff is not None else ""),
                  flush=True)
    return results


if __name__ == "__main__":
    main()
