"""The RSSM recurrence as a Python time loop, for every variant of the JAX
package's ``RSSMCell`` / ``RSSMCore`` (reference
utils/models/transition_model.py:10-307).

Module names follow the reference's transition models:
``fc_embed_state_action`` over [s, a], ``rnn``, the prior head
``stochastic_state_model``, and the posterior heads ``obs_encoder``:

- multimodal (``MultimodalTransitionModel``): ``obs_encoder[prior_expert]``
  plus, for ``expert_dist="q(st|ht,ot)"``, one ``obs_encoder[<modality>]``
  per modality; for ``"q(st|ot)"`` the modalities' experts come from the
  encoder (``MultimodalStochasticEncoder``) as {loc, scale}.  The experts
  are fused by MoPoE, or by PoE for "PoE" and "NN" (``ops/fusion.py``);
- unimodal (``TransitionModel``): one ``obs_encoder`` over the first
  modality's embedding, the reference's flat names.

The latent is Gaussian (heads emit loc and softplus scale; samples are
``loc + scale * eps``) or categorical (heads emit V * K raw logits,
normalised with unimix; samples are straight-through one-hots of
``argmax(logits + gumbel)``, flattened to V * K; ``ops/categorical.py``).
A categorical step emits ``*_logits`` [B, V, K] in place of ``*_std_devs``
and the flattened class probabilities as ``*_means``, and the experts as
``expert_logits``.

The action columns of ``fc_embed_state_action`` and the observation columns
of each expert's ``fc1`` do not depend on the recurrent carry, so they are
applied to all timesteps before the loop (``_project_obs``); only the
carry-dependent columns run per step.  The belief and the state are carried
in float32.  The posterior rollout (``forward``) and the open-loop prior
rollout (``prior_rollout``, imagination and overshooting) share that step
(``_transition``).

Time contract: given T actions / nonterminals / observation embeddings,
outputs are stacked [T, B, .] for times 1..T; the initial belief and state
are consumed, not re-emitted.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rssm_torch.models.heads import (
    ObsEncoder, StochasticStateModel, loc_scale)
from multimodal_rssm_torch.models.layers import GRUCell, act_fn
from multimodal_rssm_torch.ops import categorical, fusion

PRIOR_EXPERT = "prior_expert"
EXPERT_DISTS = ("q(st|ht,ot)", "q(st|ot)")
FUSION_METHODS = ("NN", "PoE", "MoPoE")


class TransitionModel(nn.Module):
    """Prior and posterior rollouts of one configured RSSM variant."""

    def __init__(self, belief_size: int, state_size: int, action_size: int,
                 hidden_size: int, embedding_sizes: Mapping[str, int],
                 observation_names_enc: Sequence[str],
                 multimodal: bool = True, fusion_method: str = "MoPoE",
                 expert_dist: str = "q(st|ht,ot)",
                 activation_function: str = "relu",
                 min_std_dev: float = 0.1, latent_dist: str = "gaussian",
                 latent_variables: int = 0, latent_classes: int = 0,
                 unimix: float = 0.0):
        super().__init__()
        if fusion_method not in FUSION_METHODS:
            raise ValueError(f"fusion_method={fusion_method!r} not in "
                             f"{FUSION_METHODS}")
        if expert_dist not in EXPERT_DISTS:
            raise ValueError(f"expert_dist={expert_dist!r} not in "
                             f"{EXPERT_DISTS}")
        if latent_dist == "categorical" and expert_dist != "q(st|ht,ot)":
            raise ValueError(
                "latent_dist=categorical requires expert_dist='q(st|ht,ot)' "
                "(the stochastic-encoder q(st|ot) path emits Gaussian "
                "(loc, scale) experts)")
        self.belief_size = belief_size
        self.state_size = state_size
        self.observation_names_enc = tuple(observation_names_enc)
        self.multimodal = multimodal
        self.fusion_method = fusion_method
        self.expert_dist = expert_dist
        self.categorical = latent_dist == "categorical"
        self.latent_variables = latent_variables
        self.latent_classes = latent_classes
        self.unimix = unimix
        self.min_std_dev = min_std_dev
        self.act = act_fn(activation_function)
        out_size = (latent_variables * latent_classes if self.categorical
                    else None)
        self.fc_embed_state_action = nn.Linear(state_size + action_size,
                                               belief_size)
        self.rnn = GRUCell(belief_size, belief_size)

        def prior_head():
            return StochasticStateModel(belief_size, hidden_size, state_size,
                                        activation_function, min_std_dev,
                                        out_size)

        def obs_head(name):
            return ObsEncoder(belief_size, embedding_sizes[name], hidden_size,
                              state_size, activation_function, min_std_dev,
                              out_size)

        self.stochastic_state_model = prior_head()
        if not multimodal:
            self.obs_encoder = obs_head(self.observation_names_enc[0])
        else:
            experts = {PRIOR_EXPERT: prior_head()}
            if expert_dist == "q(st|ht,ot)":
                experts.update((name, obs_head(name))
                               for name in self.observation_names_enc)
            self.obs_encoder = nn.ModuleDict(experts)

    # -- the latent distribution ------------------------------------------

    def _dist(self, raw: torch.Tensor):
        """A head's fc2 output -> {loc, scale} or normalised logits
        [B, V, K], in float32."""
        if self.categorical:
            return categorical.normalize_logits(
                categorical.unflatten_state(raw.float(), self.latent_variables,
                                            self.latent_classes), self.unimix)
        return loc_scale(raw, self.min_std_dev)

    def _sample(self, dist, eps: torch.Tensor) -> torch.Tensor:
        """A sample from pre-drawn noise (zero noise: the mean / the mode)."""
        if self.categorical:
            return categorical.flatten_state(categorical.st_sample(dist, eps))
        return dist["loc"] + dist["scale"] * eps

    def _stats(self, prefix: str, dist) -> Dict[str, torch.Tensor]:
        if self.categorical:
            return {f"{prefix}_means": categorical.flatten_state(
                        torch.exp(dist)),
                    f"{prefix}_logits": dist}
        return {f"{prefix}_means": dist["loc"],
                f"{prefix}_std_devs": dist["scale"]}

    def _fuse(self, experts: List):
        """Experts (prior expert first) -> (the posterior, the stacked
        experts [K, B, ...] by output key)."""
        if self.categorical:
            stacked = torch.stack(experts, 0)
            return (categorical.fuse_logits(self.fusion_method, stacked),
                    {"expert_logits": stacked})
        means = torch.stack([e["loc"] for e in experts], 0)
        stds = torch.stack([e["scale"] for e in experts], 0)
        mean, std = fusion.fuse(self.fusion_method, means, stds)
        return ({"loc": mean, "scale": std},
                {"expert_means": means, "expert_std_devs": stds})

    # -- the step -----------------------------------------------------------

    def _obs_head(self, name: str) -> ObsEncoder:
        return self.obs_encoder[name] if self.multimodal else self.obs_encoder

    def _project_obs(self, obs_emb: Mapping, names: Sequence[str]) -> Dict:
        """The hoisted observation columns of the q(s|h, o) heads' fc1 over
        all timesteps; for q(st|ot), the encoder's experts as they are."""
        if self.expert_dist == "q(st|ot)":
            return {name: obs_emb[name] for name in names}
        return {name: self._obs_head(name).project_obs(obs_emb[name])
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
        return h, self._dist(self.stochastic_state_model.raw(h))

    def prior_rollout(self, init_belief: torch.Tensor,
                      init_state: torch.Tensor, actions: torch.Tensor,
                      nonterminals: Optional[torch.Tensor],
                      eps_prior: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Open-loop rollout without observations (imagination,
        overshooting): the carry is the prior sample in float32 (zero
        noise: the mean, or the mode one-hot).  Returns ``beliefs``,
        ``prior_states`` and the prior's statistics, stacked [T, B, .]."""
        nonterminals, a_proj, w_s = self._carry_inputs(actions, nonterminals)
        h, s = init_belief, init_state
        out = []
        for t in range(actions.shape[0]):
            h, prior = self._transition(h, s, nonterminals[t], a_proj[t], w_s)
            s = self._sample(prior, eps_prior[t]).float()
            out.append({"beliefs": h, "prior_states": s,
                        **self._stats("prior", prior)})
        return _stack(out)

    def forward(self, init_belief: torch.Tensor, init_state: torch.Tensor,
                actions: torch.Tensor, nonterminals: Optional[torch.Tensor],
                obs_emb: Mapping, eps_prior: torch.Tensor,
                eps_post: torch.Tensor,
                names: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
        """Posterior rollout.  actions [T, B, A]; nonterminals [T, B, 1] or
        None; obs_emb {name: [T, B, E]} (q(st|ot): {name: {loc, scale}});
        eps_* [T, B, S] Gaussian or [T, B, V, K] Gumbel noise (zeros: the
        deterministic rollout); ``names``: the modalities whose experts join
        the prior expert (default: all; the fusion follows their count).
        Returns the stacked state dict, experts as [T, K, B, ...]."""
        names = self.observation_names_enc if names is None else tuple(names)
        nonterminals, a_proj, w_s = self._carry_inputs(actions, nonterminals)
        obs = self._project_obs(obs_emb, names)
        w_h = ({} if self.expert_dist == "q(st|ot)" else
               {name: self._obs_head(name).fc1.weight[:, :self.belief_size]
                for name in names})

        def expert(name, h, t):
            if self.expert_dist == "q(st|ot)":
                return {"loc": obs[name]["loc"][t],
                        "scale": obs[name]["scale"][t]}
            return self._dist(self._obs_head(name).step_raw(
                h, obs[name][t], w_h[name]))

        h, s = init_belief, init_state
        out = []
        for t in range(actions.shape[0]):
            h, prior = self._transition(h, s, nonterminals[t], a_proj[t], w_s)
            step = {"beliefs": h,
                    "prior_states": self._sample(prior, eps_prior[t]),
                    **self._stats("prior", prior)}
            if self.multimodal:
                experts = [self._dist(self.obs_encoder[PRIOR_EXPERT].raw(h))]
                experts += [expert(name, h, t) for name in names]
                post, stacked = self._fuse(experts)
                step.update(stacked)
            else:
                post = expert(names[0], h, t)
            s = self._sample(post, eps_post[t]).float()
            step.update({"posterior_states": s,
                         **self._stats("posterior", post)})
            out.append(step)
        return _stack(out)


def _stack(steps: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([step[k] for step in steps], 0) for k in steps[0]}


def expert_dict(stacked: torch.Tensor, observation_names_enc: Sequence[str]
                ) -> Dict[str, torch.Tensor]:
    """Unstack a [T, K, B, ...] expert tensor into the reference's dict
    keyed by 'prior_expert' + modality names."""
    names = (PRIOR_EXPERT, *observation_names_enc)
    return {name: stacked[:, i] for i, name in enumerate(names)}
