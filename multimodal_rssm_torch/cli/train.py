"""World-model training entry point of the PyTorch port.

    python -m multimodal_rssm_torch.cli.train [dotted.overrides ...] \\
        [--device cuda|cpu] [--cwd DIR] [--seeds 0,1,2] \\
        [--config-dir DIR] [--config-name NAME] \\
        [--resume RUN_DIR|latest] [--dist-timeout SECONDS]

Composes the config from ``{config dir}/{config name}.yaml`` (the
package's ``configs/``, or ``$MRSSM_CONFIG_DIR``, and ``config``, unless
``--config-dir`` / ``--config-name`` say otherwise; hydra-style dotted
overrides, e.g. ``train.batch_size=32 train.device_replay=stream``) and
trains on the GPU; ``--device cpu`` runs on the CPU instead.  Without a
GPU and without ``--device cpu`` it raises.  ``main.wandb=true`` mirrors
the run's metrics to wandb (rank 0; the package must be installed).

``--seeds`` runs one training run per seed (``-seed_<s>`` appended to the
experiment name when there are several).  ``--resume`` continues an
interrupted run from its dir's newest checkpoint, with the run's saved
config (``hydra_config.yaml``) and the command line's overrides on top
(e.g. a larger ``train.train_iteration``); ``latest`` takes the most
recently modified run of the composed ``main.experiment_name``.

Several GPUs (``train.mesh.data=N``, ``train.mesh.slice=S``: data
parallelism over N x S ranks; ``train.mesh.model=M``: the wide weights and
their Adam moments column-sharded over M ranks of each (slice, data)
coordinate; one process per GPU, ``parallel/mesh.py``,
``parallel/tensor.py``):

    torchrun --standalone --nproc_per_node=N -m multimodal_rssm_torch.cli.train \\
        train.mesh.data=N
    python -m multimodal_rssm_torch.cli.train train.mesh.data=N \\
        [train.mesh.model=M]

Under ``torchrun`` each process joins the world (NCCL on ``cuda:LOCAL_RANK``).
Without it, a mesh of more than one rank makes this command start the
S x N x M ranks itself (one per visible GPU at most; ``--device cpu``: gloo
ranks on the CPU) and wait for them; ``train.mesh.data=1`` is a one-rank
world in this process.  The ranks join over NCCL, or over gloo where a
launcher puts more ranks on a host than it has visible GPUs (NCCL refuses
two ranks on one card; gloo runs them, slowly: ``mesh.default_backend``).
``--dist-timeout`` fails a collective that waits longer (default 1800 s).
Rank 0 writes the run dir; the command returns its result.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

from multimodal_rssm_torch.cli import command
from multimodal_rssm_torch.core.config import (
    apply_overrides, compose, load_run_config)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--config-dir", default=None,
                        help="config tree (default: $MRSSM_CONFIG_DIR, "
                             "else the packaged configs/)")
    parser.add_argument("--config-name", default="config",
                        help="the tree's root file, without .yaml")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cwd", default=".",
                        help="base of relative data paths and of results/")
    parser.add_argument("--seeds", default=None,
                        help="comma-separated seeds (default: main.seed)")
    parser.add_argument("--resume", default=None, metavar="RUN_DIR|latest",
                        help="continue a run from its newest checkpoint")
    parser.add_argument("--dist-timeout", type=float, default=1800.0,
                        metavar="SECONDS",
                        help="a collective waiting longer fails the run")
    return parser


def _resume_dir(args, parser) -> Optional[str]:
    """``--resume``'s run dir (``latest`` resolved on rank 0)."""
    from multimodal_rssm_torch.io.metrics import find_latest_run
    from multimodal_rssm_torch.parallel.mesh import broadcast_object, is_main

    if not args.resume or args.resume != "latest":
        return args.resume
    cfg = compose(args.config_dir, args.config_name, args.overrides)
    if cfg.main.experiment_name is None:
        parser.error("--resume latest needs main.experiment_name")
    found = (find_latest_run(args.cwd, cfg.main.experiment_name)
             if is_main() else None)
    return broadcast_object(found)


def _config(args, parser, resume_dir: Optional[str]):
    if resume_dir:
        return apply_overrides(load_run_config(resume_dir), args.overrides)
    return compose(args.config_dir, args.config_name, args.overrides)


def _train(args, parser, device: str) -> Dict:
    """The runs the command line asks for, in this process (one rank of a
    world, or the only process)."""
    from multimodal_rssm_torch.parallel.mesh import is_main
    from multimodal_rssm_torch.train.loop import run

    say = print if is_main() else (lambda *a, **k: None)
    if args.resume:
        if args.seeds:
            parser.error("--resume continues one run; --seeds is not allowed")
        resume_dir = _resume_dir(args, parser)
        cfg = _config(args, parser, resume_dir)
        say(f"resuming run at {resume_dir}")
        result = run(cfg, cwd=args.cwd, device=device, resume_dir=resume_dir)
        say(f"run dir: {result['results_dir']}")
        return result

    cfg = compose(args.config_dir, args.config_name, args.overrides)
    if cfg.main.experiment_name is None:
        cfg.main.experiment_name = "RSSM"
    seeds = ([int(s) for s in args.seeds.split(",")] if args.seeds
             else [int(cfg.main.seed or 0)])
    for seed in seeds:
        run_cfg = copy.deepcopy(cfg)
        run_cfg.main.seed = seed
        if len(seeds) > 1:
            run_cfg.main.experiment_name = (
                f"{cfg.main.experiment_name}-seed_{seed}")
        result = run(run_cfg, cwd=args.cwd, device=device)
        say(f"run dir: {result['results_dir']}")
    return result


def _rank_main(rank: int, nprocs: int, init_method: str, argv: List[str],
               out_path: str) -> None:
    """One rank the command started: join the world, train, and on rank 0
    write the result (without the model) to ``out_path``."""
    import torch
    import torch.distributed as dist

    from multimodal_rssm_torch.parallel.mesh import init_distributed

    parser = _parser()
    args = parser.parse_args(argv)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    if args.device == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    device = init_distributed(
        "cpu" if args.device == "cpu" else f"cuda:{rank}",
        init_method=init_method, rank=rank, world_size=nprocs,
        timeout_s=args.dist_timeout)
    try:
        result = _train(args, parser, str(device))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({k: v for k, v in result.items() if k != "model"},
                          f)
    finally:
        dist.destroy_process_group()


@command
def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv`` and train; returns the last run's result
    (``train.loop.run``; from ranks this command started: rank 0's,
    without the model)."""
    import torch
    import torch.distributed as dist

    from multimodal_rssm_torch.core.device import resolve_device
    from multimodal_rssm_torch.parallel import launch
    from multimodal_rssm_torch.parallel import mesh as mesh_lib
    from multimodal_rssm_torch.train.loop import check_options
    from multimodal_rssm_torch.train.trainer import resolve_grad_accum

    parser = _parser()
    args = parser.parse_args(argv)

    if mesh_lib.in_launched_world():   # a rank torchrun started
        device = mesh_lib.init_distributed(args.device,
                                           timeout_s=args.dist_timeout)
        try:
            return _train(args, parser, str(device))
        finally:
            dist.destroy_process_group()

    resolve_device(args.device)   # raises without a GPU
    rank_argv = list(sys.argv[1:] if argv is None else argv)
    resume_dir = None
    if args.resume and not args.seeds:
        resume_dir = _resume_dir(args, parser)
        rank_argv += ["--resume", resume_dir]   # the last one counts
    cfg = _config(args, parser, resume_dir)
    check_options(cfg)   # what no rank could run raises before any starts
    gpus = torch.cuda.device_count() if args.device == "cuda" else None
    sizes = mesh_lib.mesh_sizes(cfg, gpus)
    if sizes is None:
        return _train(args, parser, args.device)
    nprocs = math.prod(sizes)
    mesh_lib.local_rows(int(cfg.train.batch_size), 0, sizes[0] * sizes[1],
                        resolve_grad_accum(cfg))
    if nprocs == 1:   # a one-rank world in this process
        with launch.file_rendezvous() as init_method:
            device = mesh_lib.init_distributed(
                args.device, init_method=init_method, rank=0, world_size=1,
                timeout_s=args.dist_timeout)
            try:
                return _train(args, parser, str(device))
            finally:
                dist.destroy_process_group()
    if gpus is not None and nprocs > gpus:
        raise ValueError(
            f"train.mesh asks for {nprocs} ranks and {gpus} GPU(s) are "
            "visible: under NCCL every rank needs a card of its own")
    with launch.file_rendezvous() as init_method, \
            tempfile.TemporaryDirectory(prefix="mrssm_train_") as tmp:
        out_path = os.path.join(tmp, "result.json")
        launch.spawn(_rank_main, nprocs,
                     (nprocs, init_method, rank_argv, out_path))
        with open(out_path) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
