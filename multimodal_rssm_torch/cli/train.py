"""World-model training entry point of the PyTorch port.

    python -m multimodal_rssm_torch.cli.train [dotted.overrides ...] \\
        [--device cuda|cpu] [--cwd DIR] [--seeds 0,1,2] \\
        [--resume RUN_DIR|latest]

Composes the config from the package's ``configs/`` (hydra-style dotted
overrides, e.g. ``train.batch_size=32 train.device_replay=stream``) and
trains on the GPU; ``--device cpu`` runs on the CPU instead.  Without a
GPU and without ``--device cpu`` it raises.

``--seeds`` runs one training run per seed (``-seed_<s>`` appended to the
experiment name when there are several).  ``--resume`` continues an
interrupted run from its dir's newest checkpoint, with the run's saved
config (``hydra_config.yaml``) and the command line's overrides on top
(e.g. a larger ``train.train_iteration``); ``latest`` takes the most
recently modified run of the composed ``main.experiment_name``.
"""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Optional, Sequence

from multimodal_rssm_torch.core.config import (
    apply_overrides, compose, load_run_config)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv`` and train; returns the last run's result
    (``train.loop.run``)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--config-dir", default=None,
                        help="config tree (default: the packaged configs/)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cwd", default=".",
                        help="base of relative data paths and of results/")
    parser.add_argument("--seeds", default=None,
                        help="comma-separated seeds (default: main.seed)")
    parser.add_argument("--resume", default=None, metavar="RUN_DIR|latest",
                        help="continue a run from its newest checkpoint")
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.io.metrics import find_latest_run
    from multimodal_rssm_torch.train.loop import run

    if args.resume:
        if args.seeds:
            parser.error("--resume continues one run; --seeds is not allowed")
        resume_dir = args.resume
        if resume_dir == "latest":
            cfg = compose(args.config_dir, overrides=args.overrides)
            if cfg.main.experiment_name is None:
                parser.error("--resume latest needs main.experiment_name")
            resume_dir = find_latest_run(args.cwd, cfg.main.experiment_name)
        cfg = apply_overrides(load_run_config(resume_dir), args.overrides)
        print(f"resuming run at {resume_dir}")
        result = run(cfg, cwd=args.cwd, device=args.device,
                     resume_dir=resume_dir)
        print(f"run dir: {result['results_dir']}")
        return result

    cfg = compose(args.config_dir, overrides=args.overrides)
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
        result = run(run_cfg, cwd=args.cwd, device=args.device)
        print(f"run dir: {result['results_dir']}")
    return result


if __name__ == "__main__":
    main()
