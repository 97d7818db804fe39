"""PlaNet-style CEM planner: model-predictive control in latent space.

Port of the JAX package's ``train/planner.py``: zero-shot control from a
trained world model alone (PlaNet, Hafner et al. 2019), by optimising an
action sequence against the model's reward head with the cross-entropy
method.  The J candidates of each batch row are the batch axis of one
``rollout_prior`` (row b * J + j is candidate j of batch row b:
``repeat_interleave``); each of the ``optimisation_iters`` iterations
draws candidates around the current mean and std, scores them by the sum
of predicted rewards over the horizon, and refits mean and (population)
std to the top ``top_candidates``.  The plan is clipped to [-1, 1] after
the last iteration.

Randomness comes from a generator, or from ``noise`` = (action noise
[iters, H, B, J, A], state noise [iters, H, B * J, S] or None), the
tensors the JAX package draws from its key splits.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.train.agent import LatentAgent

# PlaNet's published hyperparameters; injected as cfg.planner
PLANNER_DEFAULTS = {
    "planning_horizon": 12,
    "optimisation_iters": 10,
    "candidates": 1000,
    "top_candidates": 100,
    # sample latent-state noise in the candidates' rollouts (PlaNet's
    # choice; False scores them on the prior means)
    "stochastic_rollout": True,
}


def planner_cfg(cfg):
    """Inject the ``cfg.planner`` defaults (see PLANNER_DEFAULTS)."""
    section = dict(PLANNER_DEFAULTS)
    section.update(dict(cfg.get("planner", {}) or {}))
    cfg["planner"] = section
    return cfg


def check_reward_head_trained(cfg, what: str = "CEM planning") -> None:
    """Raise ``ValueError`` when the run's reward head was never trained
    (``rssm.predict_reward: False``, the shipped offline configs: the
    reward loss was zeroed, so the head is its random init and its plans
    would be meaningless).  ``rssm.predict_reward=true`` given explicitly
    passes."""
    if not cfg.rssm.predict_reward:
        raise ValueError(
            f"{what} optimizes the model's reward head, but this run was "
            "trained with rssm.predict_reward=False (the reward loss was "
            "zeroed, so the head is untrained random init) - its plans "
            "would be meaningless.  Train with rssm.predict_reward=True "
            "(train_online enables it automatically), or override "
            "rssm.predict_reward=true explicitly if you know the head is "
            "trained.")


def make_cem_planner(model: WorldModel, cfg, full_sequence: bool = False):
    """``plan(h, s, generator=None, noise=None, record=None)`` -> the first
    action [B, A] of the refined mean sequence (``full_sequence``: the
    whole [H, B, A] plan), from the posterior (belief [B, H], state
    [B, S]).  ``record``, a list, receives each iteration's candidate
    returns [B, J] and elite indices [B, K].  Raises ``ValueError`` when
    ``top_candidates`` exceeds ``candidates``."""
    planner_cfg(cfg)
    p = cfg.planner
    H, iters = int(p.planning_horizon), int(p.optimisation_iters)
    J, K = int(p.candidates), int(p.top_candidates)
    stochastic = bool(p.stochastic_rollout)
    if K > J:
        raise ValueError(f"planner.top_candidates ({K}) > candidates ({J})")
    A = int(cfg.env.action_size)

    def score(h0, s0, actions, generator, state_eps):
        """Each candidate's predicted return: the sum over the open-loop
        prior rollout of the reward head's mean."""
        roll = model.rollout_prior(h0, s0, actions, None,
                                   generator if stochastic else None,
                                   state_eps if stochastic else None)
        r = model.reward(roll["beliefs"], roll["prior_states"])
        return r["loc"].sum(0)                                  # [B * J]

    @torch.no_grad()
    def plan(h: torch.Tensor, s: torch.Tensor,
             generator: Optional[torch.Generator] = None, noise=None,
             record: Optional[List] = None) -> torch.Tensor:
        B, dev = h.shape[0], h.device
        h_rep = torch.repeat_interleave(h, J, dim=0)
        s_rep = torch.repeat_interleave(s, J, dim=0)
        mean = torch.zeros(H, B, A, device=dev)
        std = torch.ones(H, B, A, device=dev)
        for i in range(iters):
            if noise is None:
                eps = torch.randn((H, B, J, A), generator=generator,
                                  device=dev)
                state_eps = None
            else:
                eps = noise[0][i].to(dev)
                state_eps = None if noise[1] is None else noise[1][i].to(dev)
            actions = torch.clamp(mean[:, :, None] + std[:, :, None] * eps,
                                  -1.0, 1.0)
            returns = score(h_rep, s_rep, actions.reshape(H, B * J, A),
                            generator, state_eps).reshape(B, J)
            idx = torch.topk(returns, K, dim=1).indices             # [B, K]
            elite = torch.gather(actions, 2, idx[None, :, :, None].expand(
                H, B, K, A))                                     # [H, B, K, A]
            mean = elite.mean(2)
            # population std; + 1e-6 keeps the next draw non-degenerate
            std = elite.std(2, correction=0) + 1e-6
            if record is not None:
                record.append({"returns": returns, "elites": idx})
        mean = torch.clamp(mean, -1.0, 1.0)
        return mean if full_sequence else mean[0]

    return plan


class CEMAgent(LatentAgent):
    """``LatentAgent`` with CEM planning in place of the actor head: the
    same filter and frame normalisation, the action from
    ``make_cem_planner`` (a trained world model suffices).  ``det`` is
    ignored: planning is already the greedy policy; its ``eps`` is the
    planner's ``noise``."""

    def __init__(self, cfg, model: WorldModel, buffer):
        planner_cfg(cfg)
        super().__init__(cfg, model, None, buffer)
        self.plan = make_cem_planner(model, cfg)

    def act(self, h, s, generator, det, eps):
        return self.plan(h, s, generator, eps)
