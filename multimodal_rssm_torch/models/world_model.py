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

Beside ``train_forward`` it serves evaluation and streaming inference:
``estimate_state_from`` (any initial belief and state), ``filter_step``
(one frame), ``rollout_prior`` (open loop) and ``decode``.  The posterior
entry points take ``names``, the modalities whose encoders and experts run
(default: all; a cross-modal estimate passes a subset).  Their mode is the
caller's:
evaluation runs the model in ``eval()`` mode, so the norms read their
running statistics.
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

    def resolve_names(self, names: Optional[Sequence[str]] = None
                      ) -> Tuple[str, ...]:
        """``names`` as a tuple (default: every encoded modality); raises
        on a modality this model does not encode."""
        if names is None:
            return self.observation_names_enc
        unknown = set(names) - set(self.observation_names_enc)
        if unknown:
            raise ValueError(f"{sorted(unknown)} are not encoded modalities "
                             f"{self.observation_names_enc}")
        return tuple(names)

    def encode(self, observations: Mapping[str, torch.Tensor],
               names: Optional[Sequence[str]] = None
               ) -> Dict[str, torch.Tensor]:
        """Encoder over the folded (T*B) batch -> {name: [T, B, E]}, for
        the modalities ``names`` (default: all)."""
        obs = {n: observations[n] for n in self.resolve_names(names)}
        T, B = next(iter(obs.values())).shape[:2]
        return bottle(self.encoder, obs, T, B)

    def noise_shape(self, T: int, B: int) -> Tuple[int, int, int]:
        """Shape of one rollout's reparameterisation noise: standard normal
        [T, B, S] (the Gaussian latent; zeros are the deterministic
        rollout)."""
        return (T, B, self.state_size)

    def draw_state_noise(self, generator: torch.Generator, T: int, B: int
                         ) -> torch.Tensor:
        return torch.randn(self.noise_shape(T, B), generator=generator,
                           device=generator.device)

    def _noise(self, generator: Optional[torch.Generator], T: int, B: int,
               device: torch.device) -> torch.Tensor:
        if generator is None:
            return torch.zeros(self.noise_shape(T, B), device=device)
        return self.draw_state_noise(generator, T, B)

    def estimate_state(self, observations: Mapping[str, torch.Tensor],
                       actions: torch.Tensor,
                       nonterminals: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       names: Optional[Sequence[str]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Posterior rollout from zero belief/state over [T, B] targets.
        ``generator=None`` is the deterministic rollout (zero noise)."""
        B = actions.shape[1]
        return self.estimate_state_from(
            torch.zeros(B, self.belief_size, device=actions.device),
            torch.zeros(B, self.state_size, device=actions.device),
            observations, actions, nonterminals, generator, names)

    def estimate_state_from(self, init_belief: torch.Tensor,
                            init_state: torch.Tensor,
                            observations: Mapping[str, torch.Tensor],
                            actions: torch.Tensor,
                            nonterminals: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            names: Optional[Sequence[str]] = None
                            ) -> Dict[str, torch.Tensor]:
        """``estimate_state`` from a given (belief [B, H], state [B, S]):
        the building block of streaming and warm-started inference.  The
        state dict holds the experts twice: stacked [T, K, B, S] and as
        dicts keyed by 'prior_expert' + modality."""
        names = self.resolve_names(names)
        T, B = actions.shape[:2]
        obs_emb = self.encode(observations, names)
        eps_prior = self._noise(generator, T, B, actions.device)
        eps_post = self._noise(generator, T, B, actions.device)
        states = self.transition_model(init_belief, init_state, actions,
                                       nonterminals, obs_emb, eps_prior,
                                       eps_post, names)
        states["expert_means_stacked"] = states["expert_means"]
        states["expert_std_devs_stacked"] = states["expert_std_devs"]
        states["expert_means"] = expert_dict(states["expert_means_stacked"],
                                             names)
        states["expert_std_devs"] = expert_dict(
            states["expert_std_devs_stacked"], names)
        return states

    def filter_step(self, belief: torch.Tensor, state: torch.Tensor,
                    action: torch.Tensor,
                    observations: Mapping[str, torch.Tensor],
                    nonterminal: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    names: Optional[Sequence[str]] = None
                    ) -> Dict[str, torch.Tensor]:
        """One online posterior update: ``estimate_state_from`` over one
        frame (belief [B, H], state [B, S], action [B, A], observations
        {name: [B, ...]}, nonterminal [B, 1]), the time axis squeezed.
        Carry ``beliefs`` and ``posterior_states`` forward."""
        states = self.estimate_state_from(
            belief, state, {k: v[None] for k, v in observations.items()},
            action[None], None if nonterminal is None else nonterminal[None],
            generator, names)
        return {k: ({n: x[0] for n, x in v.items()} if isinstance(v, dict)
                    else v[0]) for k, v in states.items()}

    def rollout_prior(self, init_belief: torch.Tensor,
                      init_state: torch.Tensor, actions: torch.Tensor,
                      nonterminals: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """Open-loop prior rollout over [T, B, A] actions (imagination);
        ``generator=None`` is the deterministic (mean) rollout."""
        T, B = actions.shape[:2]
        return self.transition_model.prior_rollout(
            init_belief, init_state, actions, nonterminals,
            self._noise(generator, T, B, actions.device))

    def decode(self, beliefs: torch.Tensor, states: torch.Tensor
               ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-modality reconstructions {name: {loc, scale}} of [T, B, .]
        beliefs and states."""
        return self.observation_model(beliefs, states)

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
