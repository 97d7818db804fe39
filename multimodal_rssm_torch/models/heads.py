"""Latent-state and reward heads (reference utils/models/encoder.py:126-190,
utils/models/reward_model.py:10-41).

Heads emit float32 ``loc`` and ``scale = softplus(raw) + min_std``.
``ObsEncoder`` keeps the reference's single ``fc1`` over [h, o]; the RSSM
core applies its observation columns to all timesteps at once
(``project_obs``) and its belief columns inside the time loop
(``step_raw``), which is the same affine map split over its input blocks
(under a model axis, ``parallel/tensor.column_linear`` gathers each
block's output features).
The latent heads take ``out_size``, the width of ``fc2`` (default 2 *
state: loc and raw scale); the RSSM core reads their raw output (``raw``,
``step_raw``) as (loc, raw scale) or as V * K categorical logits.
``ObsEncoderNoBelief`` is q(s_t | o_t), the per-modality expert of
``expert_dist="q(st|ot)"``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rssm_torch.models.layers import (
    Linear, act_fn, fold_tb, unfold_tb)
from multimodal_rssm_torch.parallel.tensor import column_linear


def scale_from_raw(raw: torch.Tensor, min_std_dev: float) -> torch.Tensor:
    """softplus(raw) + min_std."""
    return F.softplus(raw) + min_std_dev


def loc_scale(out: torch.Tensor, min_std_dev: float
              ) -> Dict[str, torch.Tensor]:
    """fc2 output -> float32 {loc, scale}."""
    loc, raw = out.float().chunk(2, dim=-1)
    return {"loc": loc, "scale": scale_from_raw(raw, min_std_dev)}


class StochasticStateModel(nn.Module):
    """p(s_t | h_t): fc1 -> act -> fc2 -> (loc, scale)."""

    def __init__(self, belief_size: int, hidden_size: int, state_size: int,
                 activation_function: str = "elu", min_std_dev: float = 0.1,
                 out_size: Optional[int] = None):
        super().__init__()
        self.fc1 = Linear(belief_size, hidden_size)
        self.fc2 = Linear(hidden_size, out_size or 2 * state_size)
        self.act = act_fn(activation_function)
        self.min_std_dev = min_std_dev

    def raw(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(h)))

    def forward(self, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        return loc_scale(self.raw(h), self.min_std_dev)


class ObsEncoder(nn.Module):
    """q(s_t | h_t, o_t): fc1 over [h, o] -> act -> fc2 -> (loc, scale)."""

    def __init__(self, belief_size: int, embedding_size: int, hidden_size: int,
                 state_size: int, activation_function: str = "elu",
                 min_std_dev: float = 0.1, out_size: Optional[int] = None):
        super().__init__()
        self.belief_size = belief_size
        self.fc1 = Linear(belief_size + embedding_size, hidden_size)
        # two Dense layers in the JAX package: init draws each block apart
        self.fc1.input_blocks = (belief_size, embedding_size)
        self.fc2 = Linear(hidden_size, out_size or 2 * state_size)
        self.act = act_fn(activation_function)
        self.min_std_dev = min_std_dev

    def project_obs(self, obs_emb: torch.Tensor) -> torch.Tensor:
        """Observation columns of fc1, for all timesteps at once."""
        return column_linear(obs_emb, self.fc1.weight[:, self.belief_size:],
                             None, self.fc1)

    def step_raw(self, h: torch.Tensor, obs_proj: torch.Tensor,
                 w_h: torch.Tensor) -> torch.Tensor:
        """fc2's output on one timestep: the belief columns ``w_h`` of fc1
        (plus its bias) on ``h``, the hoisted ``obs_proj`` added."""
        return self.fc2(self.act(
            column_linear(h, w_h, self.fc1.bias, self.fc1) + obs_proj))

    def forward(self, h: torch.Tensor, obs_emb: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        return loc_scale(self.fc2(self.act(self.fc1(
            torch.cat([h, obs_emb], -1)))), self.min_std_dev)


class ObsEncoderNoBelief(nn.Module):
    """q(s_t | o_t): fc1 over the embedding -> act -> fc2 -> (loc, scale)
    (ref encoder.py:250-280)."""

    def __init__(self, embedding_size: int, hidden_size: int, state_size: int,
                 activation_function: str = "elu", min_std_dev: float = 0.1):
        super().__init__()
        self.fc1 = Linear(embedding_size, hidden_size)
        self.fc2 = Linear(hidden_size, 2 * state_size)
        self.act = act_fn(activation_function)
        self.min_std_dev = min_std_dev

    def forward(self, obs_emb: torch.Tensor) -> Dict[str, torch.Tensor]:
        return loc_scale(self.fc2(self.act(self.fc1(obs_emb))),
                          self.min_std_dev)


class RewardModel(nn.Module):
    """p(r_t | h_t, s_t) over stacked [T, B, .]: 3-layer MLP, unit scale."""

    def __init__(self, belief_size: int, state_size: int, hidden_size: int,
                 activation_function: str = "elu"):
        super().__init__()
        self.fc1 = Linear(belief_size + state_size, hidden_size)
        self.fc2 = Linear(hidden_size, hidden_size)
        self.fc3 = Linear(hidden_size, 1)
        self.act = act_fn(activation_function)

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        T, B = h.shape[:2]
        x = torch.cat([fold_tb(h), fold_tb(s)], -1)
        x = self.act(self.fc2(self.act(self.fc1(x))))
        r = unfold_tb(self.fc3(x).float(), T, B).reshape(T, B)
        return {"loc": r, "scale": torch.ones_like(r)}
