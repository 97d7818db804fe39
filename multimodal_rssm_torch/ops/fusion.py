"""Multimodal posterior fusion over stacked Gaussian experts.

Experts are stacked ``mean/std: [K, ..., S]`` with a fixed order: index 0
is the prior expert p(s|h), the rest follow the configured modalities.

The reference's ``poe`` (utils/models/encoder.py:50-55) weights experts by
1/std, not 1/var, and returns 1/sum(1/std) as a standard deviation; the
port keeps that convention exactly.
"""

from __future__ import annotations

import itertools
from typing import List, Tuple

import torch


def poe(means: torch.Tensor, stds: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Product of experts over the leading axis, 1/std precision weights:
    mean = sum(mu_i / std_i) / sum(1 / std_i), std = 1 / sum(1 / std_i)."""
    precision = 1.0 / stds
    denom = precision.sum(0)
    return (means * precision).sum(0) / denom, 1.0 / denom


def enumerate_subsets(num_modalities: int) -> List[Tuple[int, ...]]:
    """Every combination of modality experts (sizes 0..M, in
    itertools.combinations order), each with the prior expert prepended:
    for M=2 ``[(0,), (0, 1), (0, 2), (0, 1, 2)]``."""
    subsets: List[Tuple[int, ...]] = []
    ids = list(range(1, num_modalities + 1))
    for n in range(len(ids) + 1):
        for combo in itertools.combinations(ids, n):
            subsets.append((0, *combo))
    return subsets


def subset_poe_states(expert_means: torch.Tensor, expert_stds: torch.Tensor
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """PoE posterior for every expert subset (always with the prior)."""
    means, stds = [], []
    for subset in enumerate_subsets(expert_means.shape[0] - 1):
        idx = list(subset)
        m, s = poe(expert_means[idx], expert_stds[idx])
        means.append(m)
        stds.append(s)
    return means, stds


def mopoe_partition(state_size: int, num_components: int
                    ) -> List[Tuple[int, int]]:
    """Equal ``floor(S/K)`` latent slices, the last absorbing the rest."""
    bounds = []
    start = 0
    width = state_size // num_components
    for k in range(num_components):
        end = state_size if k == num_components - 1 else start + width
        bounds.append((start, end))
        start = end
    return bounds


def mopoe_posterior(expert_means: torch.Tensor, expert_stds: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoPoE posterior: concatenated latent slices of the subset PoEs."""
    means, stds = subset_poe_states(expert_means, expert_stds)
    bounds = mopoe_partition(expert_means.shape[-1], len(means))
    mean = torch.cat([m[..., s:e] for m, (s, e) in zip(means, bounds)], -1)
    std = torch.cat([sd[..., s:e] for sd, (s, e) in zip(stds, bounds)], -1)
    return mean, std


def poe_posterior(expert_means: torch.Tensor, expert_stds: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-product posterior over all experts (the reference's
    ``get_poe_state`` without the sample)."""
    return poe(expert_means, expert_stds)


def fuse(method: str, expert_means: torch.Tensor, expert_stds: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """"MoPoE" -> MoPoE; anything else ("PoE", "NN") -> PoE over all
    experts (the reference's transition-model routing), so "NN" equals
    "PoE" at the posterior."""
    if method == "MoPoE":
        return mopoe_posterior(expert_means, expert_stds)
    return poe_posterior(expert_means, expert_stds)
