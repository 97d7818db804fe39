"""The MRSSM world model: encoder + transition model + decoders + reward.

One ``nn.Module`` whose children carry the reference's names
(``encoder``, ``transition_model``, ``observation_model``,
``reward_model``), so its ``state_dict`` keys are the reference torch
schema's (with ``transition_model.main.*`` flattened into
``transition_model.*``).  ``from_config`` builds the default
configuration: multimodal MoPoE over ``q(st|ht,ot)`` experts with a
Gaussian latent and, as in the reference, a relu core (reference quirk:
its multimodal transition models never receive
``activation_function.dense``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_rssm_torch.models.decoders import MultimodalObservationModel
from multimodal_rssm_torch.models.encoders import MultimodalEncoder
from multimodal_rssm_torch.models.heads import RewardModel
from multimodal_rssm_torch.models.layers import fold_tb, unfold_tb
from multimodal_rssm_torch.rssm.core import TransitionModel, expert_dict


def bottle(fn, tree: Mapping[str, torch.Tensor], T: int, B: int):
    """Fold the leading (T, B) dims of every entry, apply, unfold."""
    out = fn({k: fold_tb(v) for k, v in tree.items()})
    return {k: unfold_tb(v, T, B) for k, v in out.items()}


def modality_embedding_size(name: str, embedding_size: Mapping[str, int]) -> int:
    if "image" in name:
        return embedding_size["image"]
    if "sound" in name:
        return embedding_size["sound"]
    return embedding_size["other"]


class WorldModel(nn.Module):
    def __init__(self, observation_names_enc: Sequence[str],
                 observation_names_rec: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 belief_size: int, state_size: int, hidden_size: int,
                 action_size: int, normalization: Optional[str] = "BatchNorm",
                 fusion_method: str = "MoPoE", core_activation: str = "relu",
                 min_std_dev: float = 0.1):
        super().__init__()
        self.observation_names_enc = tuple(observation_names_enc)
        self.observation_names_rec = tuple(observation_names_rec)
        self.belief_size = belief_size
        self.state_size = state_size
        self.encoder = MultimodalEncoder(
            self.observation_names_enc, observation_shapes, embedding_size,
            activation_function, normalization)
        self.transition_model = TransitionModel(
            belief_size, state_size, action_size, hidden_size,
            {n: modality_embedding_size(n, embedding_size)
             for n in self.observation_names_enc},
            self.observation_names_enc, fusion_method, core_activation,
            min_std_dev)
        self.observation_model = MultimodalObservationModel(
            self.observation_names_rec, observation_shapes, belief_size,
            state_size, embedding_size, normalization)
        self.reward_model = RewardModel(belief_size, state_size, hidden_size,
                                        activation_function["dense"])

    def encode(self, observations: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Encoder over the folded (T*B) batch -> {name: [T, B, E]}."""
        T, B = next(iter(observations.values())).shape[:2]
        obs = {n: observations[n] for n in self.observation_names_enc}
        return bottle(self.encoder, obs, T, B)

    def draw_state_noise(self, generator: torch.Generator, T: int, B: int
                         ) -> torch.Tensor:
        return torch.randn((T, B, self.state_size), generator=generator,
                           device=generator.device)

    def estimate_state(self, observations: Mapping[str, torch.Tensor],
                       actions: torch.Tensor,
                       nonterminals: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """Posterior rollout from zero belief/state over [T, B] targets.
        ``generator=None`` is the deterministic rollout (zero noise)."""
        T, B = actions.shape[:2]
        obs_emb = self.encode(observations)
        if generator is None:
            eps_prior = eps_post = torch.zeros(T, B, self.state_size,
                                               device=actions.device)
        else:
            eps_prior = self.draw_state_noise(generator, T, B)
            eps_post = self.draw_state_noise(generator, T, B)
        init_h = torch.zeros(B, self.belief_size, device=actions.device)
        init_s = torch.zeros(B, self.state_size, device=actions.device)
        states = self.transition_model(init_h, init_s, actions, nonterminals,
                                       obs_emb, eps_prior, eps_post)
        states["expert_means_stacked"] = states["expert_means"]
        states["expert_std_devs_stacked"] = states["expert_std_devs"]
        states["expert_means"] = expert_dict(states["expert_means_stacked"],
                                             self.observation_names_enc)
        states["expert_std_devs"] = expert_dict(
            states["expert_std_devs_stacked"], self.observation_names_enc)
        return states

    def train_forward(self, observations_target: Mapping[str, torch.Tensor],
                      actions: torch.Tensor,
                      nonterminals: Optional[torch.Tensor],
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[Dict, Dict, Dict]:
        """States, per-element reconstruction MSE and the reward
        prediction in one pass."""
        states = self.estimate_state(observations_target, actions,
                                     nonterminals, generator)
        h, s = states["beliefs"], states["posterior_states"]
        per_elem = self.observation_model.get_mse(h, s, observations_target)
        return states, per_elem, self.reward_model(h, s)

    @staticmethod
    def from_config(cfg) -> "WorldModel":
        """Build the configured model; raises on what the port does not run
        yet (unimodal, PoE/NN fusion, q(st|ot) experts, categorical
        latents, log-prob losses)."""
        rssm = cfg.rssm
        mp = rssm.multimodal_params
        unsupported = {
            "rssm.multimodal": (bool(rssm.multimodal), True),
            "rssm.multimodal_params.fusion_method": (mp.fusion_method, "MoPoE"),
            "rssm.multimodal_params.expert_dist": (mp.expert_dist, "q(st|ht,ot)"),
            "rssm.latent_dist": (rssm.get("latent_dist", "gaussian"), "gaussian"),
        }
        for key, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(
                    f"{key}={got!r}: the port runs {want!r} so far")
        return WorldModel(
            observation_names_enc=tuple(rssm.observation_names_enc),
            observation_names_rec=tuple(rssm.observation_names_rec),
            observation_shapes={k: tuple(v) for k, v in
                                cfg.env.observation_shapes.items()},
            embedding_size=dict(rssm.embedding_size),
            activation_function=dict(rssm.activation_function),
            belief_size=int(rssm.belief_size),
            state_size=int(rssm.state_size),
            hidden_size=int(rssm.hidden_size),
            action_size=int(cfg.env.action_size),
            normalization=rssm.normalization,
            fusion_method="MoPoE",
            core_activation=rssm.get("core_activation") or "relu",
        )


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every parameter from ``generator``: weights and biases
    uniform in +-1/sqrt(fan_in) (torch's default bounds), norm scales 1 and
    shifts 0.  Seeded model construction without the global RNG."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = model.get_submodule(name.rsplit(".", 1)[0])
            if hasattr(owner, "num_features"):  # norm affine
                p.fill_(1.0 if name.endswith("weight") else 0.0)
                continue
            weight = owner.weight if hasattr(owner, "weight") else p
            if hasattr(owner, "weight_ih"):  # GRU: 1/sqrt(hidden)
                fan_in = owner.hidden_size
            elif isinstance(owner, nn.ConvTranspose2d):
                fan_in = weight.shape[1] * weight[0, 0].numel()
            else:
                fan_in = weight[0].numel()
            bound = fan_in ** -0.5
            p.copy_(torch.rand(p.shape, generator=generator,
                               device=generator.device) * 2 * bound - bound)
