"""ELBO terms as float32 functions over the rollout outputs (reference
algos/MRSSM/base/algo.py:75-232, MRSSM_MoPoE/algo.py:110-137).

- reconstruction: mean over (T, B), sum over feature dims;
- reward: NLL or MSE mean;
- balanced KL ``alpha * KL(sg(q) || p) + (1 - alpha) * KL(q || sg(p))``,
  summed over the state, max with free nats, mean over (T, B);
- MoPoE KL: the plain free-nats KL averaged over every expert-subset PoE;
- global KL against N(0, I).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from multimodal_rssm_torch.ops import fusion, gaussian


def observation_losses(per_elem: Mapping[str, torch.Tensor], negate: bool
                       ) -> Dict[str, torch.Tensor]:
    """Mean over (T, B), sum over features; ``negate`` for log-probs."""
    out = {}
    for name, v in per_elem.items():
        red = v.float().mean(dim=(0, 1)).sum()
        out[name] = -red if negate else red
    return out


def reward_loss(pred_loc: torch.Tensor, pred_scale: torch.Tensor,
                rewards: torch.Tensor, use_log_prob: bool) -> torch.Tensor:
    """Reward NLL or MSE over [T, B] (``rewards`` already aligned)."""
    if use_log_prob:
        return -gaussian.log_prob(pred_loc, pred_scale, rewards).mean()
    return torch.square(pred_loc - rewards).mean()


def kl_balanced(post_mean, post_std, prior_mean, prior_std,
                alpha: Optional[float], free_nats: float) -> torch.Tensor:
    """KL balancing with free nats; ``alpha=None`` -> plain KL."""
    if alpha is None:
        div = gaussian.kl_normal(post_mean, post_std, prior_mean,
                                 prior_std).sum(-1)
    else:
        kl1 = gaussian.kl_normal(post_mean.detach(), post_std.detach(),
                                 prior_mean, prior_std).sum(-1)
        kl2 = gaussian.kl_normal(post_mean, post_std, prior_mean.detach(),
                                 prior_std.detach()).sum(-1)
        div = alpha * kl1 + (1.0 - alpha) * kl2
    return torch.clamp(div, min=free_nats).mean()


def mopoe_kl(expert_means: torch.Tensor, expert_stds: torch.Tensor,
             prior_mean: torch.Tensor, prior_std: torch.Tensor,
             free_nats: float) -> torch.Tensor:
    """Mean over subset PoEs of the free-nats KL against the prior; the
    experts are stacked [T, K, B, S]."""
    means, stds = fusion.subset_poe_states(expert_means.movedim(1, 0),
                                           expert_stds.movedim(1, 0))
    losses = [torch.clamp(gaussian.kl_normal(m, sd, prior_mean, prior_std)
                          .sum(-1), min=free_nats).mean()
              for m, sd in zip(means, stds)]
    return torch.stack(losses).mean()


def global_kl(post_mean: torch.Tensor, post_std: torch.Tensor) -> torch.Tensor:
    """KL against N(0, I), summed over the state, mean over (T, B)."""
    return gaussian.kl_standard_normal(post_mean, post_std).sum(-1).mean()
