"""Deployment-time latent-space agent.

Port of the JAX package's ``train/agent.py``: the world model's streaming
posterior filter (``WorldModel.filter_step``) paired with the reference's
``ActorModel`` head, to act in an environment.  Each frame goes through the
evaluation's input pipeline (``eval/state_estimation.fixed_draws``: crop
offset 0, no noise or PCA shift) with the bit-depth normalise always
through K1's wrapper (``ops/cuda_kernels.normalize_image``: one launch per
frame and image modality on the card, its plain version on the CPU), then
one deterministic filter step (the world model in ``eval()`` mode in its
compute dtype, no gradient), and the agent carries the belief
and the posterior MEANS.  The actor samples, or takes its mode-seeking
action (``det``); exploration adds Gaussian noise of scale
``train.action_noise`` and clips to [-1, 1].
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from multimodal_rssm_torch.eval.state_estimation import fixed_draws
from multimodal_rssm_torch.models.world_model import (
    WorldModel, effective_state_size)
from multimodal_rssm_torch.train import trainer as tr


class LatentAgent:
    """Carries (belief, state, previous action) across environment steps,
    batch 1, on the world model's device.  ``agent(obs, generator,
    explore, det)`` -> the action [A] as NumPy; ``prepare`` and ``step``
    are its two halves."""

    def __init__(self, cfg, model: WorldModel, actor, buffer):
        self.cfg = cfg
        self.model = model
        self.actor = actor
        self.spec = tr.build_aug_spec(buffer)
        self.draws = fixed_draws(buffer, self.spec)
        self.bit_depth = int(cfg.env.bit_depth)
        self.action_noise = float(cfg.train.action_noise or 0.0)
        self.belief_size = int(cfg.rssm.belief_size)
        self.state_size = effective_state_size(cfg)
        self.action_size = int(cfg.env.action_size)
        self.device = next(model.parameters()).device
        self.reset()

    def reset(self) -> None:
        self.h = torch.zeros(1, self.belief_size, device=self.device)
        self.s = torch.zeros(1, self.state_size, device=self.device)
        self.prev_action = torch.zeros(1, self.action_size,
                                       device=self.device)

    def prepare(self, obs: Dict[str, np.ndarray],
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """One observation frame -> the prepared frame {name: [1, ...]} of
        the modalities the model encodes (others are ignored); its
        normalise noise from ``generator``."""
        frame = {k: torch.as_tensor(np.asarray(obs[k]))[None, None].to(
                     self.device) for k in self.model.observation_names_enc}
        if generator is None:
            generator = torch.Generator(self.device)
        prepared = tr.prepare_observations(frame, self.spec, self.draws,
                                           self.bit_depth, generator,
                                           kernel_normalize=True)
        return {k: v[0] for k, v in prepared.items()}

    def act(self, h: torch.Tensor, s: torch.Tensor, generator, det: bool,
            eps: Optional[torch.Tensor]) -> torch.Tensor:
        """The action [1, A] for the filtered (belief, state)."""
        return self.actor(h, s, generator, det, eps)

    @torch.no_grad()
    def step(self, frame: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             explore: bool = False, det: bool = False,
             action_eps: Optional[torch.Tensor] = None,
             explore_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fold a prepared frame into the carried posterior and return the
        action [1, A] (a tensor on the device).  ``action_eps`` /
        ``explore_eps`` are the actor's and the exploration's noise in
        place of draws from ``generator``."""
        model = self.model
        was_training = model.training
        model.eval()
        try:
            states = model.filter_step(self.h, self.s, self.prev_action,
                                       frame)
        finally:
            model.train(was_training)
        h, s = states["beliefs"], states["posterior_means"]
        action = self.act(h, s, generator, det, action_eps)
        if explore and self.action_noise > 0.0:
            if explore_eps is None:
                explore_eps = torch.randn(action.shape, generator=generator,
                                          device=self.device)
            action = torch.clamp(
                action + self.action_noise * explore_eps.to(self.device),
                -1.0, 1.0)
        self.h, self.s, self.prev_action = h, s, action
        return action

    def __call__(self, obs: Dict[str, np.ndarray],
                 generator: Optional[torch.Generator] = None,
                 explore: bool = False, det: bool = False) -> np.ndarray:
        """Incorporate one observation frame and return the action [A]."""
        action = self.step(self.prepare(obs, generator), generator, explore,
                           det)
        return action[0].cpu().numpy()
