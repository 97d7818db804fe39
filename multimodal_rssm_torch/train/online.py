"""Online Dreamer training: environment interaction in the loop.

Port of the JAX package's ``train/online.py``.  One outer iteration
(Dreamer, Hafner et al. 2020):

    for _ in range(collect_interval):        # learn
        world-model step on a replayed batch  (trainer.make_train_step)
        behavior step through the updated world model  (train/behavior.py)
    collect one episode with the actor (+ exploration noise) -> D.append

after ``seed_episodes`` random-policy episodes.  ``rssm.predict_reward`` is
forced on: imagination returns come from the learned reward head.  Every
normalise of the loop (world-model step, behavior step, acted frame) goes
through K1's wrapper, whatever ``train.pallas_normalize`` says; on a CPU
tensor the wrapper runs its plain version.
``online.collect_policy="cem"`` is PlaNet (Hafner et al. 2019): collection
plans through the reward head every step (``train/planner.py``) and there
is no behavior training.

The update block's batches come from the host buffer behind a prefetch
thread (gather, pin, copy) that is closed before collection appends to
the ring.  Every draw happens on the loop's thread, in a fixed order: the
chunk indices of the whole block from the buffer's generator before the
block starts, the augmentation choices, the torch generator's noise, the
random policy's actions; so a seed fixes a run.  World-model checkpoints
go to the top of the run dir (``models_{episode}.pt``), behavior ones to
``behavior/``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from multimodal_rssm_torch.data.buffer import build_buffer, to_device
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.models.world_model import (
    WorldModel, init_parameters)
from multimodal_rssm_torch.train import behavior as bh
from multimodal_rssm_torch.train import trainer as tr
from multimodal_rssm_torch.train.agent import LatentAgent
from multimodal_rssm_torch.train.prefetch import Prefetcher

ONLINE_DEFAULTS = {
    # random-policy episodes before learning starts
    "seed_episodes": 5,
    # actor-driven episodes to collect (the outer loop's length)
    "episodes": 50,
    # (world-model + behavior) update steps per collected episode
    # (Dreamer: 100)
    "collect_interval": 100,
    # exploration noise scale; None -> cfg.train.action_noise
    "expl_noise": None,
    "checkpoint_interval": 10,  # episodes
    # "actor": Dreamer (the actor drives collection); "cem": PlaNet (CEM
    # planning through the reward head, no behavior training)
    "collect_policy": "actor",
}
COLLECT_POLICIES = ("actor", "cem")


def online_cfg(cfg):
    """Inject the ``cfg.online`` and ``cfg.behavior`` defaults and turn the
    reward head on; raises ``ValueError`` on an unknown
    ``collect_policy``."""
    section = dict(ONLINE_DEFAULTS)
    section.update(dict(cfg.get("online", {}) or {}))
    cfg["online"] = section
    if section["collect_policy"] not in COLLECT_POLICIES:
        raise ValueError(f"online.collect_policy must be one of "
                         f"{COLLECT_POLICIES}, got "
                         f"{section['collect_policy']!r}")
    bh.behavior_cfg(cfg)
    if not cfg.rssm.predict_reward:
        print("online training: enabling rssm.predict_reward "
              "(imagination returns use the learned reward head)")
        cfg.rssm.predict_reward = True
    if section["expl_noise"] is not None:
        cfg.train.action_noise = float(section["expl_noise"])
    return cfg


def collect_episode(env, D, agent: Optional[LatentAgent],
                    rng: np.random.Generator, seed: int,
                    generator: Optional[torch.Generator] = None,
                    explore: bool = True) -> Dict[str, float]:
    """One episode into the buffer, until the env says ``done``.
    ``agent=None``: the uniform random policy (the seed phase, from
    ``rng``).  Frames are appended raw (uint8).  Row t = (o_t, a_t, r_t),
    a_t the action taken from o_t: the (actions[:-1], obs[1:]) pairing the
    trainer scans; the terminal observation is dropped, as in the
    recorded datasets' episodes."""
    obs = env.reset(seed=seed)
    if agent is not None:
        agent.reset()
    total_reward, steps, done = 0.0, 0, False
    while not done:
        if agent is None:
            action = rng.uniform(-1.0, 1.0, env.action_size).astype(
                np.float32)
        else:
            action = agent(obs, generator, explore=explore)
        next_obs, reward, done = env.step(action)
        D.append(obs, action, reward, done, raw=True)
        obs = next_obs
        total_reward += float(reward)
        steps += 1
    return {"episode_reward": total_reward, "episode_steps": float(steps)}


def run_online(cfg, env, results_dir: str, logger, device: torch.device,
               progress: bool = True):
    """The online loop on ``device``; returns (the world model, the
    behavior state or None in "cem" mode)."""
    o = cfg.online
    seed = int(cfg.main.seed or 0)
    rng = np.random.default_rng(seed)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)

    D = build_buffer(cfg, seed=seed)
    for ep in range(int(o.seed_episodes)):
        m = collect_episode(env, D, None, rng, seed=seed * 10_000 + ep)
        logger.log(m, ep, "seed")
    if D.idx <= L and not D.full:
        raise ValueError(
            f"seed data too short: {D.idx} steps buffered, chunk_size={L}; "
            "raise online.seed_episodes or the env episode length")

    model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer, scheduler = tr.build_optimizer(cfg, model)
    aug_spec = tr.build_aug_spec(D)
    draws = tr.HostAugmentDraws(D, aug_spec, seed=seed)
    train_step, _ = tr.make_train_step(model, cfg, optimizer, scheduler,
                                       aug_spec, device,
                                       kernel_normalize=True)
    generator = torch.Generator(device).manual_seed(seed)

    planning = str(o.collect_policy) == "cem"
    if planning:
        from multimodal_rssm_torch.train.planner import CEMAgent

        bstate = behavior_step = None
        agent = CEMAgent(cfg, model, D)
    else:
        bstate = bh.init_behavior_state(cfg, device, seed)
        behavior_step = bh.BehaviorStep(model, cfg, aug_spec, device)
        agent = LatentAgent(cfg, model, bstate.actor, D)

    episodes, updates = int(o.episodes), int(o.collect_interval)
    batches = updates * (1 if planning else 2)
    behavior_dir = os.path.join(results_dir, "behavior")
    wm_metrics = bh_metrics = {}
    for episode in range(1, episodes + 1):
        # the block's indices, drawn here; the prefetch thread gathers and
        # copies them, and is closed before collection writes the ring
        order = iter([D.sample_indices(B, L) for _ in range(batches)])
        prefetcher = Prefetcher(
            lambda order=order: to_device(D.gather(next(order)), device),
            depth=2, device=device)
        try:
            for _ in range(updates):
                wm_metrics = train_step(prefetcher.get(), draws.draw(),
                                        generator)
                if behavior_step is not None:
                    bh_metrics = behavior_step(bstate, prefetcher.get(),
                                               draws.draw(), generator)
        finally:
            prefetcher.close()

        ep_metrics = collect_episode(env, D, agent, rng,
                                     seed=seed * 10_000 + 7_000 + episode,
                                     generator=generator)
        host = {**ep_metrics,
                **{f"wm_{k}": float(v) for k, v in wm_metrics.items()},
                **{k: float(v) for k, v in bh_metrics.items()}}
        logger.log(host, episode, "online")
        if progress:
            line = (f"[episode {episode}/{episodes}] "
                    f"reward {host['episode_reward']:.3f} "
                    f"wm_loss {host.get('wm_loss', float('nan')):.2f}")
            if not planning:
                line += f" actor {host.get('actor_loss', float('nan')):.3f}"
            print(line, flush=True)
        if episode % int(o.checkpoint_interval) == 0 or episode == episodes:
            ckpt.save_checkpoint(results_dir, episode, model, optimizer,
                                 scheduler)
            if bstate is not None:
                ckpt.save_behavior_checkpoint(behavior_dir, episode, bstate)
    return model, bstate
