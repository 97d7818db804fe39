"""The MRSSM world model: encoder + transition model + decoders + reward.

One ``nn.Module`` whose children carry the reference's names
(``encoder``, ``transition_model``, ``observation_model``,
``reward_model``), so its ``state_dict`` keys are the reference torch
schema's (with ``transition_model.main.*`` flattened into
``transition_model.*``).  ``from_config`` builds every variant of the JAX
package's config schema, dispatched as its ``from_config``:

- multimodal (``rssm.multimodal``): one encoder and one decoder per
  modality (dicts keyed by name), the prior expert plus one expert per
  modality fused by ``multimodal_params.fusion_method`` (MoPoE, PoE; "NN"
  runs PoE, as in the reference), the experts q(s|h, o) in the core or,
  for ``expert_dist="q(st|ot)"``, q(s|o) heads in the encoder;
- unimodal (``rssm=unimodal``): the reference's ``RSSM``, which encodes
  only ``observation_names_enc[0]`` and decodes only
  ``observation_names_rec[0]``; ``encoder`` and ``observation_model`` are
  then that one module, as in the reference's flat state dict;
- ``rssm.latent_dist``: gaussian, or categorical (V x K one-hot variables,
  ``state_size`` = V * K; ``rssm.state_size`` is ignored);
- the codecs by modality name and shape (``models/encoders.py``,
  ``models/decoders.py``): images at 64 / 84 / 128 / 256 px under
  ``rssm.normalization`` (BatchNorm, InstanceNorm, GroupNorm, None),
  sound, symbolic modalities (``pose_*``) and the ``draw_target`` label
  head; ``rssm.remat`` checkpoints the codecs (``models/remat.py``).

The core's activation follows the reference: relu for the multimodal
transition models (they never receive ``activation_function.dense``), the
configured ``dense`` for the unimodal one; ``rssm.core_activation``
overrides both.

Beside ``train_forward`` it serves evaluation and streaming inference:
``estimate_state_from`` (any initial belief and state), ``filter_step``
(one frame), ``rollout_prior`` (open loop), ``decode`` and, for control,
``reward``.  The rollouts take their state noise as tensors (``eps``) where
a caller holds them against another draw.  The posterior
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

from multimodal_rssm_torch.models.decoders import (
    MultimodalObservationModel, build_observation_model)
from multimodal_rssm_torch.models.encoders import (
    MultimodalEncoder, MultimodalStochasticEncoder, build_encoder,
    modality_embedding_size)
from multimodal_rssm_torch.models.heads import RewardModel
from multimodal_rssm_torch.models.layers import fold_tb, unfold_tb
from multimodal_rssm_torch.models.remat import (
    check_remat, decoder_mode, encoder_mode)
from multimodal_rssm_torch.ops import categorical
from multimodal_rssm_torch.rssm.core import TransitionModel, expert_dict


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def bottle(fn, tree: Mapping[str, torch.Tensor], T: int, B: int):
    """Fold the leading (T, B) dims of every entry, apply, unfold every
    tensor of the (nested) output."""
    out = fn({k: fold_tb(v) for k, v in tree.items()})
    return _tree_map(lambda y: unfold_tb(y, T, B), out)


class WorldModel(nn.Module):
    def __init__(self, observation_names_enc: Sequence[str],
                 observation_names_rec: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 belief_size: int, state_size: int, hidden_size: int,
                 action_size: int, normalization: Optional[str] = "BatchNorm",
                 multimodal: bool = True, fusion_method: str = "MoPoE",
                 expert_dist: str = "q(st|ht,ot)",
                 core_activation: str = "relu", min_std_dev: float = 0.1,
                 latent_dist: str = "gaussian", latent_variables: int = 0,
                 latent_classes: int = 0, unimix: float = 0.0,
                 remat=False):
        super().__init__()
        if not multimodal:
            observation_names_enc = tuple(observation_names_enc)[:1]
            observation_names_rec = tuple(observation_names_rec)[:1]
        if latent_dist == "categorical" and (
                state_size != latent_variables * latent_classes):
            raise ValueError(f"categorical state_size {state_size} != "
                             f"{latent_variables} x {latent_classes}")
        self.observation_names_enc = tuple(observation_names_enc)
        self.observation_names_rec = tuple(observation_names_rec)
        self.belief_size = belief_size
        self.state_size = state_size
        self.multimodal = multimodal
        self.latent_dist = latent_dist
        self.latent_variables = latent_variables
        self.latent_classes = latent_classes
        self.transition_model = TransitionModel(
            belief_size, state_size, action_size, hidden_size,
            {n: modality_embedding_size(n, embedding_size)
             for n in self.observation_names_enc},
            self.observation_names_enc, multimodal=multimodal,
            fusion_method=fusion_method, expert_dist=expert_dist,
            activation_function=core_activation, min_std_dev=min_std_dev,
            latent_dist=latent_dist, latent_variables=latent_variables,
            latent_classes=latent_classes, unimix=unimix)
        remat = check_remat(remat)
        enc_args = (observation_shapes, embedding_size, activation_function,
                    normalization)
        dec_args = (observation_shapes, belief_size, state_size, hidden_size,
                    embedding_size, activation_function, normalization,
                    decoder_mode(remat))
        if not multimodal:
            self.encoder = build_encoder(self.observation_names_enc[0],
                                         *enc_args, encoder_mode(remat))
            self.observation_model = build_observation_model(
                self.observation_names_rec[0], *dec_args)
        else:
            self.encoder = (
                MultimodalStochasticEncoder(
                    self.observation_names_enc, *enc_args, state_size,
                    hidden_size, min_std_dev, encoder_mode(remat))
                if expert_dist == "q(st|ot)" else
                MultimodalEncoder(self.observation_names_enc, *enc_args,
                                  encoder_mode(remat)))
            self.observation_model = MultimodalObservationModel(
                self.observation_names_rec, *dec_args)
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
               names: Optional[Sequence[str]] = None) -> Dict:
        """Encoder over the folded (T*B) batch -> {name: [T, B, E]} (for
        ``q(st|ot)``: {name: {loc, scale}} experts), for the modalities
        ``names`` (default: all)."""
        obs = {n: observations[n] for n in self.resolve_names(names)}
        T, B = next(iter(obs.values())).shape[:2]
        if not self.multimodal:
            return bottle(lambda o: {k: self.encoder(v) for k, v in o.items()},
                          obs, T, B)
        return bottle(self.encoder, obs, T, B)

    def noise_shape(self, T: int, B: int) -> Tuple[int, ...]:
        """Shape of one rollout's noise: standard normal [T, B, S] for the
        Gaussian latent, Gumbel [T, B, V, K] for the categorical one (zeros
        are the deterministic rollout: the mean, the mode)."""
        if self.latent_dist == "categorical":
            return (T, B, self.latent_variables, self.latent_classes)
        return (T, B, self.state_size)

    def draw_state_noise(self, generator: torch.Generator, T: int, B: int
                         ) -> torch.Tensor:
        if self.latent_dist == "categorical":
            return categorical.gumbel_noise(generator, self.noise_shape(T, B))
        return torch.randn(self.noise_shape(T, B), generator=generator,
                           device=generator.device)

    def _noise(self, generator: Optional[torch.Generator], T: int, B: int,
               device: torch.device,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        if eps is not None:
            if tuple(eps.shape) != self.noise_shape(T, B):
                raise ValueError(f"state noise of shape {tuple(eps.shape)}, "
                                 f"expected {self.noise_shape(T, B)}")
            return eps.to(device)
        if generator is None:
            return torch.zeros(self.noise_shape(T, B), device=device)
        return self.draw_state_noise(generator, T, B)

    def estimate_state(self, observations: Mapping[str, torch.Tensor],
                       actions: torch.Tensor,
                       nonterminals: Optional[torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       names: Optional[Sequence[str]] = None,
                       eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Posterior rollout from zero belief/state over [T, B] targets.
        ``generator=None`` is the deterministic rollout (zero noise)."""
        B = actions.shape[1]
        return self.estimate_state_from(
            torch.zeros(B, self.belief_size, device=actions.device),
            torch.zeros(B, self.state_size, device=actions.device),
            observations, actions, nonterminals, generator, names, eps)

    def estimate_state_from(self, init_belief: torch.Tensor,
                            init_state: torch.Tensor,
                            observations: Mapping[str, torch.Tensor],
                            actions: torch.Tensor,
                            nonterminals: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            names: Optional[Sequence[str]] = None,
                            eps: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                            ) -> Dict[str, torch.Tensor]:
        """``estimate_state`` from a given (belief [B, H], state [B, S]):
        the building block of streaming and warm-started inference.  A
        multimodal state dict holds the experts twice: stacked [T, K, B, .]
        (``expert_means_stacked`` / ``expert_std_devs_stacked``, or
        ``expert_logits_stacked``) and as dicts keyed by 'prior_expert' +
        modality.  ``eps``: the prior's and the posterior's noise, each of
        ``noise_shape(T, B)``, in place of draws from ``generator``."""
        names = self.resolve_names(names)
        T, B = actions.shape[:2]
        obs_emb = self.encode(observations, names)
        eps_prior, eps_post = eps or (None, None)
        eps_prior = self._noise(generator, T, B, actions.device, eps_prior)
        eps_post = self._noise(generator, T, B, actions.device, eps_post)
        states = self.transition_model(init_belief, init_state, actions,
                                       nonterminals, obs_emb, eps_prior,
                                       eps_post, names)
        if self.multimodal:
            keys = (("expert_logits",) if self.latent_dist == "categorical"
                    else ("expert_means", "expert_std_devs"))
            for k in keys:
                states[f"{k}_stacked"] = states[k]
                states[k] = expert_dict(states[k], names)
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
                      generator: Optional[torch.Generator] = None,
                      eps: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
        """Open-loop prior rollout over [T, B, A] actions (imagination);
        ``generator=None`` is the deterministic rollout (the mean, or the
        mode one-hot); ``eps`` of ``noise_shape(T, B)`` is the noise in
        place of a draw from ``generator``."""
        T, B = actions.shape[:2]
        return self.transition_model.prior_rollout(
            init_belief, init_state, actions, nonterminals,
            self._noise(generator, T, B, actions.device, eps))

    def reward(self, beliefs: torch.Tensor, states: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """The reward head's {loc, scale} over [T, B, .] beliefs and
        states."""
        return self.reward_model(beliefs, states)

    def decode(self, beliefs: torch.Tensor, states: torch.Tensor
               ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per-modality reconstructions {name: {loc, scale}} of [T, B, .]
        beliefs and states."""
        if not self.multimodal:
            return {self.observation_names_rec[0]:
                    self.observation_model(beliefs, states)}
        return self.observation_model(beliefs, states)

    def observation_losses(self, beliefs: torch.Tensor, states: torch.Tensor,
                           targets: Mapping[str, torch.Tensor],
                           use_log_prob: bool = False
                           ) -> Dict[str, torch.Tensor]:
        """Per-modality per-element reconstruction terms: the squared error
        or (``use_log_prob``) the log density of the targets."""
        method = "get_log_prob" if use_log_prob else "get_mse"
        if not self.multimodal:
            name = self.observation_names_rec[0]
            return {name: getattr(self.observation_model, method)(
                beliefs, states, targets[name])}
        return getattr(self.observation_model, method)(beliefs, states,
                                                       targets)

    def train_forward(self, observations_target: Mapping[str, torch.Tensor],
                      actions: torch.Tensor,
                      nonterminals: Optional[torch.Tensor],
                      generator: Optional[torch.Generator] = None,
                      use_log_prob: bool = False) -> Tuple[Dict, Dict, Dict]:
        """States, per-element reconstruction terms (squared error, or the
        log density with ``use_log_prob``) and the reward prediction in one
        pass."""
        states = self.estimate_state(observations_target, actions,
                                     nonterminals, generator)
        h, s = states["beliefs"], states["posterior_states"]
        per_elem = self.observation_losses(h, s, observations_target,
                                           use_log_prob)
        return states, per_elem, self.reward_model(h, s)

    @staticmethod
    def from_config(cfg) -> "WorldModel":
        """Build the configured model, dispatched as the JAX package's
        ``from_config``: unimodal or multimodal, PoE / NN / MoPoE fusion,
        q(st|ht,ot) or q(st|ot) experts, Gaussian or categorical latents,
        every codec and norm by modality, ``rssm.remat`` (false when the
        key is absent; a value outside ``remat.REMAT_VALUES`` raises
        ``ValueError``)."""
        rssm = cfg.rssm
        check_lowering_keys(rssm)
        multimodal = bool(rssm.multimodal)
        mp = rssm.multimodal_params
        latent_dist, latent_v, latent_k, unimix = resolve_latent(rssm)
        return WorldModel(
            observation_names_enc=tuple(rssm.observation_names_enc),
            observation_names_rec=tuple(rssm.observation_names_rec),
            observation_shapes={k: tuple(v) for k, v in
                                cfg.env.observation_shapes.items()},
            embedding_size=dict(rssm.embedding_size),
            activation_function=dict(rssm.activation_function),
            belief_size=int(rssm.belief_size),
            state_size=effective_state_size(cfg),
            hidden_size=int(rssm.hidden_size),
            action_size=int(cfg.env.action_size),
            normalization=rssm.normalization,
            multimodal=multimodal,
            fusion_method=mp.fusion_method if multimodal else "PoE",
            expert_dist=mp.expert_dist if multimodal else "q(st|ht,ot)",
            # the reference's multimodal transition models run relu, its
            # unimodal one activation_function.dense
            core_activation=(rssm.get("core_activation")
                             or ("relu" if multimodal
                                 else rssm.activation_function["dense"])),
            latent_dist=latent_dist, latent_variables=latent_v,
            latent_classes=latent_k, unimix=unimix,
            remat=rssm.get("remat", False),
        )


# the JAX package's ConvTranspose lowerings (its models/layers.py)
CONVT_IMPLS = ("dilated", "dilated_autodiff", "phased")


def check_lowering_keys(rssm) -> None:
    """``rssm.convt_impl`` and ``rssm.scan_unroll`` choose how the JAX
    package lowers its ConvTranspose and its time loop; every choice
    computes the same model, so the port reads them only to refuse what the
    JAX package refuses: a ``convt_impl`` outside ``CONVT_IMPLS`` and a
    ``scan_unroll`` below 1 (null or 0 reads as 1) raise ``ValueError``."""
    impl = rssm.get("convt_impl")
    if impl and str(impl) not in CONVT_IMPLS:
        raise ValueError(f"rssm.convt_impl={impl!r} is not one of "
                         f"{CONVT_IMPLS}")
    unroll = int(rssm.get("scan_unroll", 1) or 1)
    if unroll < 1:
        raise ValueError(f"rssm.scan_unroll={unroll} must be >= 1")


def resolve_latent(rssm) -> Tuple[str, int, int, float]:
    """``rssm.latent_dist`` (+ ``rssm.categorical_params``) ->
    (latent_dist, variables, classes, unimix); zeros for the Gaussian
    latent."""
    latent_dist = str(rssm.get("latent_dist", "gaussian") or "gaussian")
    if latent_dist == "gaussian":
        return latent_dist, 0, 0, 0.0
    if latent_dist != "categorical":
        raise ValueError(f"rssm.latent_dist={latent_dist!r} not in "
                         "('gaussian', 'categorical')")
    cp = rssm.get("categorical_params", None) or {}
    variables = int(cp.get("variables", 32))
    classes = int(cp.get("classes", 32))
    unimix = float(cp.get("unimix", 0.01))
    if variables < 1 or classes < 2:
        raise ValueError(f"categorical_params needs variables >= 1 and "
                         f"classes >= 2, got {variables} x {classes}")
    if not 0.0 <= unimix < 1.0:
        raise ValueError(f"categorical_params.unimix={unimix} not in [0, 1)")
    return latent_dist, variables, classes, unimix


def effective_state_size(cfg) -> int:
    """The flattened state width the belief, decoders and reward read:
    ``rssm.state_size`` for the Gaussian latent, V * K for the categorical
    one."""
    latent_dist, v, k, _ = resolve_latent(cfg.rssm)
    return v * k if latent_dist == "categorical" else int(cfg.rssm.state_size)


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
