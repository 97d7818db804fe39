"""Categorical (discrete) latent primitives, the DreamerV2-style variant.

The stochastic state is V independent categorical variables of K classes,
sampled as one-hot vectors with straight-through gradients, optionally
mixed with a uniform distribution ("unimix", DreamerV3).

- ``logits`` are shaped [..., V, K] and always normalised (log p), so
  adding experts' logits is their product up to the renormalisation that
  ``poe_logits`` applies;
- a flattened state (what the GRU and the decoders read) is [..., V*K];
- the math is float32 whatever the model's compute dtype.

Fusion mirrors ``ops/fusion.py``: the product of experts is a sum of
logits, and MoPoE partitions the V variables (not the latent dimensions)
over the subset products.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from multimodal_rssm_torch.ops.fusion import enumerate_subsets, mopoe_partition


def normalize_logits(raw: torch.Tensor, unimix: float = 0.0) -> torch.Tensor:
    """log_softmax over the class axis; with ``unimix`` u > 0 the log of
    ``(1 - u) softmax(raw) + u / K``."""
    logp = torch.log_softmax(raw.float(), dim=-1)
    if unimix and unimix > 0.0:
        K = raw.shape[-1]
        logp = torch.log((1.0 - unimix) * torch.exp(logp) + unimix / K)
    return logp


def gumbel_noise(generator: torch.Generator, shape: Tuple[int, ...]
                 ) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u), u uniform in [tiny, 1), on the
    generator's device: ``argmax(logits + g)`` is a categorical sample and
    zero noise gives the mode."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def st_sample(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Straight-through one-hot of ``argmax(logits + noise)``, shaped like
    ``logits``; its gradient flows through the probabilities (sample + p -
    sg(p))."""
    probs = torch.exp(logits)
    idx = torch.argmax(logits + noise, dim=-1)
    onehot = torch.nn.functional.one_hot(idx, logits.shape[-1]).float()
    return onehot + probs - probs.detach()


def flatten_state(x: torch.Tensor) -> torch.Tensor:
    """[..., V, K] -> [..., V*K]."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def unflatten_state(x: torch.Tensor, variables: int, classes: int
                    ) -> torch.Tensor:
    """[..., V*K] -> [..., V, K]."""
    return x.reshape(*x.shape[:-1], variables, classes)


def kl_categorical(logits_q: torch.Tensor, logits_p: torch.Tensor
                   ) -> torch.Tensor:
    """KL(q || p) per variable, summed over the class axis -> [..., V]."""
    return torch.sum(torch.exp(logits_q) * (logits_q - logits_p), dim=-1)


def kl_uniform(logits_q: torch.Tensor) -> torch.Tensor:
    """KL(q || Uniform(K)) per variable = log K - H(q) -> [..., V]."""
    K = logits_q.shape[-1]
    return torch.sum(torch.exp(logits_q) * logits_q, dim=-1) + math.log(K)


def poe_logits(expert_logits: torch.Tensor) -> torch.Tensor:
    """Product of the experts on the leading axis: [E, ..., V, K] ->
    normalised [..., V, K]."""
    return torch.log_softmax(expert_logits.sum(0), dim=-1)


def subset_poe_logits(expert_logits: torch.Tensor) -> List[torch.Tensor]:
    """The product for every expert subset (the prior expert, index 0,
    always in), in ``enumerate_subsets`` order."""
    return [poe_logits(expert_logits[list(subset)])
            for subset in enumerate_subsets(expert_logits.shape[0] - 1)]


def mopoe_logits(expert_logits: torch.Tensor) -> torch.Tensor:
    """MoPoE posterior: the V variables split equally over the subset
    products, each slice taken from its product."""
    subsets = subset_poe_logits(expert_logits)
    bounds = mopoe_partition(expert_logits.shape[-2], len(subsets))
    return torch.cat([lg[..., s:e, :] for lg, (s, e) in zip(subsets, bounds)],
                     dim=-2)


def fuse_logits(method: str, expert_logits: torch.Tensor) -> torch.Tensor:
    """"MoPoE" -> ``mopoe_logits``; anything else ("PoE", "NN") -> the
    product of all experts, as ``fusion.fuse``."""
    if method == "MoPoE":
        return mopoe_logits(expert_logits)
    return poe_logits(expert_logits)
