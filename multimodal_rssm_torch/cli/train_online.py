"""Online Dreamer / PlaNet training: learn the world model (and, in the
actor mode, the actor-critic) while collecting episodes in an environment.

    python -m multimodal_rssm_torch.cli.train_online --env synthetic \\
        [--env-length 100] [--cwd .] [--device cuda|cpu] \\
        [--config-dir DIR] [--config-name NAME] \\
        [main.experiment_name=online online.episodes=50 \\
         online.collect_interval=100 online.collect_policy=actor|cem ...]

Composes the config from ``{config dir}/{config name}.yaml`` (the
package's ``configs/``, or ``$MRSSM_CONFIG_DIR``, and ``config`` by
default) with the dotted overrides, injects the ``online`` / ``behavior``
defaults (``train/online.py::online_cfg``, which turns
``rssm.predict_reward`` on) and builds the environment (``synthetic``,
``peg`` or a suite spec such as ``gym:Pendulum-v1``, ``envs/``);
``env.action_size`` follows the environment's.  The run dir
(``{cwd}/results/{experiment}/{date}/run_k``) holds the config,
``metrics.jsonl`` (mirrored to wandb under ``main.wandb``), the
world-model checkpoints ``models_{episode}.pt`` (what ``estimate_state`` /
``check_model`` / ``eval_policy`` read) and the behavior checkpoints under
``behavior/``.  Runs on the GPU unless ``--device cpu``; without a GPU it
raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from multimodal_rssm_torch.cli import command


@command
def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv`` and run; returns the run dir, the world model and
    the behavior state (None in the cem mode)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--config-dir", default=None,
                        help="config tree (default: $MRSSM_CONFIG_DIR, "
                             "else the packaged configs/)")
    parser.add_argument("--config-name", default="config",
                        help="the tree's root file, without .yaml")
    parser.add_argument(
        "--env", default="synthetic",
        help="'synthetic' | 'peg' | external-suite spec ('gym:Pendulum-v1', "
             "'dmc:cartpole:swingup', 'robosuite:Lift'), envs/zoo.py")
    parser.add_argument("--env-length", type=int, default=100,
                        help="episode length of the environment")
    parser.add_argument("--cwd", default=".", help="base of results/")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import (
        configure_float32, resolve_device)
    from multimodal_rssm_torch.envs import make_env
    from multimodal_rssm_torch.io.metrics import (
        MetricLogger, make_run_dir, wandb_kwargs)
    from multimodal_rssm_torch.train.online import online_cfg, run_online

    dev = resolve_device(args.device)
    configure_float32()
    cfg = compose(args.config_dir, args.config_name, args.overrides)
    if cfg.main.experiment_name is None:
        cfg.main.experiment_name = "online"
    online_cfg(cfg)
    env = make_env(args.env, length=args.env_length)
    if int(cfg.env.action_size) != int(env.action_size):
        # zoo adapters carry the suite's action width; the model and the
        # buffer are built to match it
        print(f"online training: env.action_size {cfg.env.action_size} -> "
              f"{env.action_size} (from --env {args.env})")
        cfg.env.action_size = int(env.action_size)
    results_dir = make_run_dir(cfg, args.cwd)
    with MetricLogger(results_dir,
                      use_wandb=bool(cfg.main.get("wandb", False)),
                      wandb_kwargs=wandb_kwargs(cfg, args.cwd,
                                                results_dir)) as logger:
        model, bstate = run_online(cfg, env, results_dir, logger, dev)
    print(f"done: {results_dir}")
    return {"results_dir": results_dir, "model": model, "behavior": bstate}


if __name__ == "__main__":
    main()
