"""Policy evaluation: greedy rollouts of a trained actor in an environment.

Port of the JAX package's ``eval/policy.py``: the latent agent
(``train/agent.py``, or any agent of its calling convention such as
``train/planner.CEMAgent``) without exploration noise for N episodes, and
the return statistics.  ``det=True`` takes the reference actor's
100-sample mode-seeking action.  One generator seeded ``seed`` on the
agent's device draws every frame's noise.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from multimodal_rssm_torch.data.buffer import build_buffer
from multimodal_rssm_torch.train.agent import LatentAgent


def evaluate_policy(cfg, env, model, actor, episodes: int = 5,
                    seed: int = 0, det: bool = True, agent=None
                    ) -> Dict[str, object]:
    """{"returns", "mean_return", "std_return", "mean_steps",
    "final_rewards", "best_rewards"} over ``episodes`` episodes (episode k
    resets the env with seed ``seed * 10000 + k``).  ``agent``: a built
    agent (e.g. a ``CEMAgent``, which ignores ``actor``); default: the
    actor's ``LatentAgent``."""
    if agent is None:
        agent = LatentAgent(cfg, model, actor, build_buffer(cfg))
    generator = torch.Generator(agent.device).manual_seed(seed)
    returns: List[float] = []
    steps_list: List[float] = []
    final_rewards: List[float] = []
    best_rewards: List[float] = []
    for ep in range(episodes):
        obs = env.reset(seed=seed * 10_000 + ep)
        agent.reset()
        total, steps, done = 0.0, 0, False
        last_r, best_r = 0.0, -np.inf
        while not done:
            action = agent(obs, generator, det=det)
            obs, reward, done = env.step(action)
            total += float(reward)
            last_r = float(reward)
            best_r = max(best_r, last_r)
            steps += 1
        returns.append(total)
        steps_list.append(float(steps))
        final_rewards.append(last_r)
        best_rewards.append(best_r)
    return {
        "returns": returns,
        "mean_return": float(np.mean(returns)),
        "std_return": float(np.std(returns)),
        "mean_steps": float(np.mean(steps_list)),
        # per-episode terminal / best per-step reward: for distance-shaped
        # envs (envs/peg.py: reward = -tip-to-hole distance) a success
        # proxy, e.g. best_reward > -0.08: the tip entered the hole mouth
        "final_rewards": final_rewards,
        "best_rewards": best_rewards,
    }
