"""The multimodal RSSM recurrence (Gaussian latent) as a Python time loop.

Port of the JAX package's ``RSSMCell`` / ``RSSMCore`` (reference
utils/models/transition_model.py:139-307).  Module names follow the
reference's ``MultimodalTransitionModel``: ``fc_embed_state_action`` over
[s, a], ``rnn``, the prior head ``stochastic_state_model``, and the
experts ``obs_encoder[prior_expert | <modality>]``.

The action columns of ``fc_embed_state_action`` and the observation columns
of each expert's ``fc1`` do not depend on the recurrent carry, so they are
applied to all timesteps before the loop (``_project_obs``); only the
carry-dependent columns run per step.  The belief is carried in float32.
The posterior rollout (``forward``) and the open-loop prior rollout
(``prior_rollout``, imagination) share that step (``_transition``).

Time contract: given T actions / nonterminals / observation embeddings,
outputs are stacked [T, B, .] for times 1..T; the initial belief and state
are consumed, not re-emitted.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rssm_torch.models.heads import ObsEncoder, StochasticStateModel
from multimodal_rssm_torch.models.layers import GRUCell, act_fn
from multimodal_rssm_torch.ops import fusion

PRIOR_EXPERT = "prior_expert"
# what an open-loop (prior) rollout emits; a posterior rollout adds the
# posterior and the experts
PRIOR_KEYS = ("beliefs", "prior_states", "prior_means", "prior_std_devs")


class TransitionModel(nn.Module):
    """Posterior rollout over per-modality experts fused by PoE / MoPoE."""

    def __init__(self, belief_size: int, state_size: int, action_size: int,
                 hidden_size: int, embedding_sizes: Mapping[str, int],
                 observation_names_enc: Sequence[str],
                 fusion_method: str = "MoPoE",
                 activation_function: str = "relu",
                 min_std_dev: float = 0.1):
        super().__init__()
        self.belief_size = belief_size
        self.state_size = state_size
        self.observation_names_enc = tuple(observation_names_enc)
        self.fusion_method = fusion_method
        self.act = act_fn(activation_function)
        self.fc_embed_state_action = nn.Linear(state_size + action_size,
                                               belief_size)
        self.rnn = GRUCell(belief_size, belief_size)
        self.stochastic_state_model = StochasticStateModel(
            belief_size, hidden_size, state_size, activation_function,
            min_std_dev)
        experts = {PRIOR_EXPERT: StochasticStateModel(
            belief_size, hidden_size, state_size, activation_function,
            min_std_dev)}
        for name in self.observation_names_enc:
            experts[name] = ObsEncoder(
                belief_size, embedding_sizes[name], hidden_size, state_size,
                activation_function, min_std_dev)
        self.obs_encoder = nn.ModuleDict(experts)

    def _project_obs(self, obs_emb: Mapping[str, torch.Tensor],
                     names: Sequence[str]) -> Dict[str, torch.Tensor]:
        """The hoisted observation columns of the experts' fc1."""
        return {name: self.obs_encoder[name].project_obs(obs_emb[name])
                for name in names}

    def _carry_inputs(self, actions: torch.Tensor,
                      nonterminals: Optional[torch.Tensor]):
        """(nonterminals, the hoisted action columns [T, B, H], the state
        columns of ``fc_embed_state_action``)."""
        if nonterminals is None:
            nonterminals = torch.ones(*actions.shape[:2], 1,
                                      device=actions.device)
        w_sa = self.fc_embed_state_action.weight
        S = self.state_size
        return nonterminals, F.linear(actions, w_sa[:, S:]), w_sa[:, :S]

    def _transition(self, h: torch.Tensor, s: torch.Tensor,
                    nonterminal: torch.Tensor, a_proj: torch.Tensor,
                    w_s: torch.Tensor):
        """One step of the belief and the prior: h_t = GRU(act(W_s
        (s_{t-1} * nonterminal) + W_a a_{t-1} + b), h_{t-1}) in float32,
        then p(s_t | h_t)."""
        hidden = self.act(F.linear(s * nonterminal, w_s,
                                   self.fc_embed_state_action.bias) + a_proj)
        h = self.rnn(hidden, h).float()
        return h, self.stochastic_state_model(h)

    def prior_rollout(self, init_belief: torch.Tensor,
                      init_state: torch.Tensor, actions: torch.Tensor,
                      nonterminals: Optional[torch.Tensor],
                      eps_prior: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Open-loop rollout without observations (imagination): the carry
        is the prior sample ``loc + scale * eps`` in float32, the mean at
        zero noise.  Returns ``beliefs``, ``prior_states``, ``prior_means``,
        ``prior_std_devs``, stacked [T, B, .]."""
        nonterminals, a_proj, w_s = self._carry_inputs(actions, nonterminals)
        h, s = init_belief, init_state
        out = {k: [] for k in PRIOR_KEYS}
        for t in range(actions.shape[0]):
            h, prior = self._transition(h, s, nonterminals[t], a_proj[t], w_s)
            s = (prior["loc"] + prior["scale"] * eps_prior[t]).float()
            for k, v in zip(PRIOR_KEYS, (h, s, prior["loc"], prior["scale"])):
                out[k].append(v)
        return {k: torch.stack(v, 0) for k, v in out.items()}

    def forward(self, init_belief: torch.Tensor, init_state: torch.Tensor,
                actions: torch.Tensor, nonterminals: Optional[torch.Tensor],
                obs_emb: Mapping[str, torch.Tensor], eps_prior: torch.Tensor,
                eps_post: torch.Tensor,
                names: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
        """actions [T, B, A]; nonterminals [T, B, 1] or None; obs_emb
        {name: [T, B, E]}; eps_* [T, B, S] (zeros: deterministic rollout);
        ``names``: the modalities whose experts join the prior expert
        (default: all; the fusion follows their count).  Returns the
        stacked state dict, experts as [T, K, B, S]."""
        names = self.observation_names_enc if names is None else tuple(names)
        nonterminals, a_proj, w_s = self._carry_inputs(actions, nonterminals)
        obs_proj = self._project_obs(obs_emb, names)
        w_h = {name: self.obs_encoder[name].fc1.weight[:, :self.belief_size]
               for name in names}

        h, s = init_belief, init_state
        keys = (*PRIOR_KEYS, "posterior_states", "posterior_means",
                "posterior_std_devs", "expert_means", "expert_std_devs")
        out = {k: [] for k in keys}
        for t in range(actions.shape[0]):
            h, prior = self._transition(h, s, nonterminals[t], a_proj[t], w_s)
            pe = self.obs_encoder[PRIOR_EXPERT](h)
            means, stds = [pe["loc"]], [pe["scale"]]
            for name in names:
                e = self.obs_encoder[name].step(h, obs_proj[name][t], w_h[name])
                means.append(e["loc"])
                stds.append(e["scale"])
            expert_means = torch.stack(means, 0)  # [K, B, S]
            expert_stds = torch.stack(stds, 0)
            post_mean, post_std = fusion.fuse(self.fusion_method,
                                              expert_means, expert_stds)
            s = (post_mean + post_std * eps_post[t]).float()
            for k, v in (("beliefs", h),
                         ("prior_states", prior["loc"] + prior["scale"] * eps_prior[t]),
                         ("prior_means", prior["loc"]),
                         ("prior_std_devs", prior["scale"]),
                         ("posterior_states", s),
                         ("posterior_means", post_mean),
                         ("posterior_std_devs", post_std),
                         ("expert_means", expert_means),
                         ("expert_std_devs", expert_stds)):
                out[k].append(v)
        return {k: torch.stack(v, 0) for k, v in out.items()}


def expert_dict(stacked: torch.Tensor, observation_names_enc: Sequence[str]
                ) -> Dict[str, torch.Tensor]:
    """Unstack a [T, K, B, S] expert tensor into the reference's dict keyed
    by 'prior_expert' + modality names."""
    names = (PRIOR_EXPERT, *observation_names_enc)
    return {name: stacked[:, i] for i, name in enumerate(names)}
