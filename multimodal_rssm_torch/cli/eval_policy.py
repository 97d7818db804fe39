"""Evaluate a policy in an environment (greedy episodes).

    python -m multimodal_rssm_torch.cli.eval_policy --run-dir RUN_DIR \\
        [--env synthetic] [--env-length 100] [--episodes 5] \\
        [--policy actor|cem] [--stochastic] [--device cuda|cpu] \\
        [planner.candidates=1000 ...]

Loads a run dir of ``train_online`` (or a world-model run plus
``train_behavior``'s ``behavior/``), the port's or the JAX package's: the
newest world-model checkpoint ``models_*.pt`` or ``.msgpack`` at its top
and, for ``--policy actor``, the newest ``behavior/models_*.pt`` or
``.msgpack``, and rolls the latent agent without exploration
noise, printing one JSON line of return statistics.  ``--policy cem``
plans through the world model alone (``train/planner.py``; ``planner.*``
overrides) and raises ``ValueError`` unless the run trained its reward
head (``rssm.predict_reward``).  The run's ``env.action_size`` must equal
the environment's (``ValueError`` otherwise).  Runs on the GPU unless
``--device cpu``; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv``, evaluate, print and return the statistics."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--run-dir", required=True)
    parser.add_argument(
        "--env", default="synthetic",
        help="'synthetic' | 'peg' | suite spec ('gym:<id>', "
             "'dmc:<domain>:<task>', 'robosuite:<Task>'), envs/zoo.py")
    parser.add_argument("--env-length", type=int, default=100)
    parser.add_argument("--episodes", type=int, default=5)
    parser.add_argument("--stochastic", action="store_true",
                        help="sample the actor instead of the mode-seeking "
                             "deterministic action")
    parser.add_argument("--policy", default="actor", choices=["actor", "cem"],
                        help="'actor': the trained behavior head (needs the "
                             "behavior/ checkpoint); 'cem': CEM planning "
                             "through the world model alone")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.policy == "cem" and args.stochastic:
        parser.error("--stochastic only applies to --policy actor (CEM "
                     "planning is already the greedy policy)")

    from multimodal_rssm_torch.core.config import (
        apply_overrides, load_run_config)
    from multimodal_rssm_torch.core.device import (
        configure_float32, resolve_device)
    from multimodal_rssm_torch.data.buffer import build_buffer
    from multimodal_rssm_torch.envs import make_env
    from multimodal_rssm_torch.eval.policy import evaluate_policy
    from multimodal_rssm_torch.eval.state_estimation import load_eval_model
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.train import behavior as bh

    dev = resolve_device(args.device)
    configure_float32()
    cfg = apply_overrides(load_run_config(args.run_dir), args.overrides)
    bh.behavior_cfg(cfg)
    env = make_env(args.env, length=args.env_length)
    if int(cfg.env.action_size) != int(env.action_size):
        raise ValueError(
            f"the run's env.action_size {cfg.env.action_size} != the "
            f"environment's {env.action_size} (--env {args.env}): the model "
            "was trained for other actions")
    wm_path = ckpt.latest_checkpoint(args.run_dir)
    if wm_path is None:
        raise FileNotFoundError(
            f"need models_*.pt or .msgpack in {args.run_dir}")
    model = load_eval_model(cfg, wm_path, dev)

    agent = actor = None
    if args.policy == "cem":
        from multimodal_rssm_torch.train.planner import (
            CEMAgent, check_reward_head_trained)

        check_reward_head_trained(cfg, "--policy cem")
        print(f"world model: {wm_path}\npolicy: CEM planner", file=sys.stderr)
        agent = CEMAgent(cfg, model, build_buffer(cfg))
    else:
        bh_path = ckpt.latest_checkpoint(os.path.join(args.run_dir,
                                                      "behavior"))
        if bh_path is None:
            raise FileNotFoundError(
                f"need a behavior/ checkpoint in {args.run_dir} for "
                "--policy actor (or use --policy cem)")
        print(f"world model: {wm_path}\nactor/value: {bh_path}",
              file=sys.stderr)
        bstate = bh.init_behavior_state(cfg, dev)
        ckpt.load_behavior_checkpoint(bh_path, bstate)
        actor = bstate.actor
    stats = evaluate_policy(cfg, env, model, actor, episodes=args.episodes,
                            seed=int(cfg.main.seed or 0),
                            det=not args.stochastic, agent=agent)
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
