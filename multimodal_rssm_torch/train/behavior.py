"""Dreamer-style behavior learning: actor-critic trained in imagination.

Port of the JAX package's ``train/behavior.py``.  Given a trained world
model, it trains the reference's policy heads (``models/policy.py``) on
latent trajectories imagined with the model's own prior rollout (Dreamer,
Hafner et al. 2020):

1. the posterior states of a replay batch are the imagination starts (no
   gradient: behavior learning never updates the world model);
2. the actor acts in latent space for ``horizon`` steps through the
   transition prior (``WorldModel.rollout_prior``, one step at a time);
3. rewards come from the world model's reward head, values from the value
   head; TD(lambda) returns over the imagined trajectory;
4. actor loss = -mean(discounted returns), its gradient taken through the
   learned dynamics (the GRU, the prior head, the reward head) into the
   actor's parameters only; value loss = the value head's negative log
   likelihood of the returns (scale-1 Gaussian, or the DreamerV3 two-hot
   cross-entropy), its gradient into the value head's parameters only,
   from the detached trajectory and targets.

Each loss is differentiated with ``torch.autograd.grad`` over its own
head's parameters, so the world model's parameters get no ``.grad`` and
the actor loss reaches the value head not at all.  The world model runs in
``eval()`` mode (its norms read their running stats and update none) in
its compute dtype, and is put back in the mode it was found in; the
heads compute in float32.  A step leaves every world-model parameter and
running stat as it was.

DreamerV3 options (``ops/returns.py``), off by default:
``behavior.value_head=twohot_symlog`` and ``behavior.return_norm=true``
(the actor objective divided by max(1, S), S an EMA of the 5-95th
percentile return range, ``BehaviorState.return_scale``).

Randomness comes from a ``torch.Generator``; ``BehaviorNoise`` hands a
step the noise the JAX package draws from its key splits instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_rssm_torch.models.policy import (
    ActorModel, TwoHotValueModel, ValueModel)
from multimodal_rssm_torch.models.world_model import (
    WorldModel, effective_state_size, init_parameters)
from multimodal_rssm_torch.ops import gaussian
from multimodal_rssm_torch.ops import returns as rt
from multimodal_rssm_torch.train import trainer as tr

BEHAVIOR_DEFAULTS = {
    # imagination horizon H (Dreamer: 15)
    "horizon": 15,
    # imagination starts per step: None = every posterior state of the
    # batch's rollout ((L - 1) * B = 2450 at the reference scale); an int
    # takes that many, uniformly without replacement
    "imag_batch": None,
    "discount": 0.99,
    # TD(lambda) mixing for the value targets (Dreamer: 0.95)
    "disclam": 0.95,
    "actor_learning_rate": 8.0e-5,
    "value_learning_rate": 8.0e-5,
    "adam_epsilon": 1.0e-7,
    "grad_clip_norm": 100.0,
    "train_iteration": 2000,
    "checkpoint_interval": 500,
    "log_interval": 10,
    # value head: "gaussian" (the reference's scale-1 critic) or
    # "twohot_symlog" (DreamerV3 discrete regression over symlog bins)
    "value_head": "gaussian",
    "twohot_bins": 255,
    # actor objective divided by an EMA of the 5-95th percentile imagined
    # return range, clipped below 1 (DreamerV3 eq. 11)
    "return_norm": False,
    "return_norm_decay": 0.99,
    "return_norm_percentile": 5.0,
}
VALUE_HEADS = ("gaussian", "twohot_symlog")


def behavior_cfg(cfg):
    """Inject the ``cfg.behavior`` defaults (dotted overrides on top; the
    saved run config records them)."""
    section = dict(BEHAVIOR_DEFAULTS)
    section.update(dict(cfg.get("behavior", {}) or {}))
    cfg["behavior"] = section
    return cfg


@dataclasses.dataclass
class BehaviorState:
    """The behavior learner's state: the two heads, their optimizers, the
    step count and ``return_scale`` (DreamerV3's S, carried whether or
    not ``return_norm`` is on, so the checkpoint does not depend on it)."""

    actor: ActorModel
    value: nn.Module
    actor_opt: torch.optim.Optimizer
    value_opt: torch.optim.Optimizer
    step: int = 0
    return_scale: Optional[torch.Tensor] = None


@dataclasses.dataclass
class BehaviorNoise:
    """A step's noise as tensors, in place of draws from its generator:
    the posterior rollout's (prior, posterior) state noise [L - 1, B, S]
    each, the imagination starts taken (indices, or None for all), and the
    imagination's action noise [H, N, A] and state noise [H, N, S]."""

    posterior: Tuple[torch.Tensor, torch.Tensor]
    starts: Optional[torch.Tensor]
    actions: torch.Tensor
    states: torch.Tensor


def build_policy_models(cfg) -> Tuple[ActorModel, nn.Module]:
    """The reference's policy heads at the reference's sizes (hidden =
    ``rssm.hidden_size``, the action size from ``env``, activation
    ``rssm.activation_function.dense``); ``behavior.value_head`` picks the
    critic and raises ``ValueError`` on anything else."""
    H, S = int(cfg.rssm.belief_size), effective_state_size(cfg)
    hidden = int(cfg.rssm.hidden_size)
    act = cfg.rssm.activation_function["dense"]
    actor = ActorModel(H, S, hidden, int(cfg.env.action_size),
                       activation_function=act)
    head = str(cfg.behavior.value_head)
    if head == "twohot_symlog":
        value = TwoHotValueModel(H, S, hidden, int(cfg.behavior.twohot_bins),
                                 activation_function=act)
    elif head == "gaussian":
        value = ValueModel(H, S, hidden, activation_function=act)
    else:
        raise ValueError(f"behavior.value_head={head!r} not in {VALUE_HEADS}")
    return actor, value


def build_behavior_optimizers(cfg, actor: nn.Module, value: nn.Module):
    """Adam at the behavior learning rates and epsilon for each head; each
    step clips its head's gradients by global norm first (optax's rule,
    ``trainer.clip_by_global_norm_``), as the JAX package's chain does."""
    b = cfg.behavior
    eps = float(b.adam_epsilon)
    return (torch.optim.Adam(actor.parameters(),
                             lr=float(b.actor_learning_rate), eps=eps),
            torch.optim.Adam(value.parameters(),
                             lr=float(b.value_learning_rate), eps=eps))


def init_behavior_state(cfg, device: torch.device, seed: int = 0
                        ) -> BehaviorState:
    """Fresh heads (parameters drawn from a generator seeded ``seed``) on
    ``device``, their optimizers, step 0 and ``return_scale`` 1."""
    actor, value = build_policy_models(cfg)
    generator = torch.Generator().manual_seed(seed)
    init_parameters(actor, generator)
    init_parameters(value, generator)
    actor.to(device)
    value.to(device)
    actor_opt, value_opt = build_behavior_optimizers(cfg, actor, value)
    return BehaviorState(actor, value, actor_opt, value_opt, 0,
                         torch.ones((), device=device))


def lambda_returns(rewards: torch.Tensor, values: torch.Tensor,
                   bootstrap: torch.Tensor, discount: float, lam: float
                   ) -> torch.Tensor:
    """TD(lambda) returns over an imagined trajectory (Dreamer eq. 6):
    rewards / values [H, N] for steps 1..H, bootstrap [N] the value after
    H; R_t = r_t + discount ((1 - lam) V_{t+1} + lam R_{t+1}), R_{H+1} =
    bootstrap, by a reverse recursion."""
    next_values = torch.cat([values[1:], bootstrap[None]], 0)
    inputs = rewards + discount * (1.0 - lam) * next_values
    ret, out = bootstrap, []
    for t in reversed(range(rewards.shape[0])):
        ret = inputs[t] + discount * lam * ret
        out.append(ret)
    return torch.stack(out[::-1], 0)


def imagine_policy(model: WorldModel, actor: ActorModel, h0: torch.Tensor,
                   s0: torch.Tensor, horizon: int,
                   generator: Optional[torch.Generator] = None,
                   det_action: bool = False,
                   action_eps: Optional[torch.Tensor] = None,
                   state_eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Roll the actor through the latent dynamics for ``horizon`` steps
    from the starts (h0, s0) [N, .]: [H, N, .] beliefs, states and
    actions.  Differentiable: gradients reach the actor through the
    dynamics.  Each step's action noise and state noise come from
    ``action_eps`` [H, ...] and ``state_eps`` [H, N, ...] when given, else
    from ``generator`` (action first); ``det_action`` takes the
    mode-seeking action and the prior's mean.  The world model runs in its
    compute dtype."""
    h, s = h0, s0
    hs, ss, acts = [], [], []
    for t in range(horizon):
        a = actor(h, s, generator, det_action,
                  None if action_eps is None else action_eps[t])
        out = model.rollout_prior(
            h, s, a[None], None, None if det_action else generator,
            None if det_action or state_eps is None else state_eps[t][None])
        h, s = out["beliefs"][0], out["prior_states"][0]
        hs.append(h)
        ss.append(s)
        acts.append(a)
    return {"beliefs": torch.stack(hs), "states": torch.stack(ss),
            "actions": torch.stack(acts)}


def _apply(params, grads, optimizer, max_norm: float) -> torch.Tensor:
    """Clip ``grads`` by global norm, hand them to ``params`` and take one
    optimizer step; returns the norm before clipping."""
    norm = tr.global_norm(grads)
    tr.clip_by_global_norm_(grads, norm, max_norm)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None
    return norm


class BehaviorStep:
    """One behavior update (the JAX package's ``make_behavior_step``) over
    raw replay batches, in the world-model trainer's (observations,
    actions, rewards, nonterminals) layout, so it shares the replay and its
    feeds.  ``step(bstate, raw_batch, draws, generator)`` prepares the raw
    batch as the world-model train step does, its normalise always through
    K1's wrapper (on a CPU tensor the wrapper runs its plain version),
    then ``update``s; both update ``bstate`` in place and return the
    metrics (0-d tensors; nothing synchronises)."""

    def __init__(self, model: WorldModel, cfg, aug_spec: tr.AugSpec,
                 device: torch.device):
        b = cfg.behavior
        self.model, self.aug_spec, self.device = model, aug_spec, device
        self.horizon = int(b.horizon)
        self.discount, self.lam = float(b.discount), float(b.disclam)
        self.imag_batch = None if b.imag_batch is None else int(b.imag_batch)
        self.max_norm = float(b.grad_clip_norm)
        self.bit_depth = int(cfg.env.bit_depth)
        self.twohot = str(b.value_head) == "twohot_symlog"
        self.bins = rt.bin_centers(int(b.twohot_bins), device=device)
        self.return_norm = bool(b.return_norm)
        self.rn_decay = float(b.return_norm_decay)
        self.rn_pct = float(b.return_norm_percentile)

    def __call__(self, bstate: BehaviorState, raw_batch, draws,
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        observations, actions, rewards, nonterminals = raw_batch
        observations = tr.prepare_observations(
            observations, self.aug_spec, draws, self.bit_depth, generator,
            kernel_normalize=True)
        return self.update(bstate, (observations, actions, rewards,
                                    nonterminals), generator)

    def starts(self, batch, generator, noise: Optional[BehaviorNoise]):
        """The imagination starts (h0, s0) [N, .]: the posterior states of
        the prepared batch, in eval mode, without gradient."""
        observations, actions, _, nonterminals = batch
        model = self.model
        with torch.no_grad():
            states = model.estimate_state(
                {k: v[1:] for k, v in observations.items()}, actions[:-1],
                nonterminals[:-1], generator,
                eps=None if noise is None else noise.posterior)
        h0 = states["beliefs"].reshape(-1, model.belief_size).float()
        s0 = states["posterior_states"].reshape(-1, model.state_size).float()
        n = h0.shape[0]
        if self.imag_batch is not None and self.imag_batch < n:
            idx = (noise.starts if noise is not None else torch.randperm(
                n, generator=generator, device=generator.device
            )[:self.imag_batch]).to(h0.device)
            h0, s0 = h0[idx], s0[idx]
        return h0, s0

    def update(self, bstate: BehaviorState, batch,
               generator: Optional[torch.Generator] = None,
               noise: Optional[BehaviorNoise] = None
               ) -> Dict[str, torch.Tensor]:
        """The update from a prepared batch (observations, actions,
        rewards, nonterminals), its randomness from ``generator`` or
        ``noise``."""
        model, actor, value = self.model, bstate.actor, bstate.value
        was_training = model.training
        model.eval()
        try:
            h0, s0 = self.starts(batch, generator, noise)
            traj = imagine_policy(
                model, actor, h0, s0, self.horizon, generator,
                action_eps=None if noise is None else noise.actions,
                state_eps=None if noise is None else noise.states)
            hs, ss = traj["beliefs"], traj["states"]
            rewards = model.reward(hs, ss)["loc"]                 # [H, N]
        finally:
            model.train(was_training)
        vals = value(hs, ss)["loc"]
        returns = lambda_returns(rewards[:-1], vals[:-1], vals[-1],
                                 self.discount, self.lam)        # [H-1, N]
        # step t of the imagined trajectory is t model steps ahead (no
        # terminal predictor: discount ** t)
        weights = self.discount ** torch.arange(
            self.horizon - 1, dtype=torch.float32, device=hs.device)
        if self.return_norm:
            new_scale = rt.update_return_scale(
                bstate.return_scale, returns, self.rn_decay, self.rn_pct,
                step=bstate.step)
            objective = rt.normalize_returns(returns, new_scale)
        else:
            new_scale = bstate.return_scale
            objective = returns
        actor_loss = -torch.mean(weights[:, None] * objective)
        actor_params = list(actor.parameters())
        actor_grads = list(torch.autograd.grad(actor_loss, actor_params))

        targets = returns.detach()
        out = value(hs[:-1].detach(), ss[:-1].detach())
        if self.twohot:
            target_probs = rt.twohot(rt.symlog(targets), self.bins)
            logp = torch.sum(target_probs
                             * torch.log_softmax(out["logits"], -1), -1)
        else:
            logp = gaussian.log_prob(out["loc"], out["scale"], targets)
        value_loss = -torch.mean(weights[:, None] * logp)
        value_params = list(value.parameters())
        value_grads = list(torch.autograd.grad(value_loss, value_params))

        actor_norm = _apply(actor_params, actor_grads, bstate.actor_opt,
                            self.max_norm)
        value_norm = _apply(value_params, value_grads, bstate.value_opt,
                            self.max_norm)
        bstate.step += 1
        bstate.return_scale = new_scale.detach()
        metrics = {"actor_loss": actor_loss, "value_loss": value_loss,
                   "imag_return": returns.mean(), "imag_reward": rewards.mean(),
                   "imag_value": vals.mean(), "value_pred": out["loc"].mean(),
                   "actor_grad_norm": actor_norm, "value_grad_norm": value_norm}
        if self.return_norm:
            metrics["return_scale"] = new_scale
        return {k: v.detach() for k, v in metrics.items()}

