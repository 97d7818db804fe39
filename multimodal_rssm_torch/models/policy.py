"""Actor and value networks (Dreamer-style policy heads).

Port of the JAX package's ``models/policy.py`` (reference
utils/models/policy.py):

- ``ValueModel``: V(h, s), a 4-layer MLP to a unit-scale Gaussian (ref
  :11-43);
- ``TwoHotValueModel``: the DreamerV3 critic, a categorical over fixed
  symlog-spaced bins (``behavior.value_head=twohot_symlog``);
- ``Pie``: the tanh-normal policy head pi(a | h, s) (ref :46-101);
- ``ActorModel``: tanh-squashed samples, or the reference's 100-sample
  mode-seeking action (ref :103-138);
- ``PieEmb`` / ``ActorModelEnc``: the encoder-conditioned variants (ref
  :140-240), which no entry point reaches (as in the JAX package).

Submodule names follow the JAX package's parameter paths (``fc1`` ...,
``pie.fc1`` ...), the bridge's keys (``io/jax_weights.py``).

The heads compute in float32, as the JAX package builds them without a
dtype while the world model runs in the compute dtype: every forward here
takes float32 inputs and runs with autocast off, so a caller's autocast
does not reach them (the port itself enables none).

Randomness: a sampling call takes its standard-normal noise ``eps`` as a
tensor, or draws it from ``generator``, where the JAX package draws it
from a key.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rssm_torch.models.encoders import (
    build_encoder, modality_embedding_size)
from multimodal_rssm_torch.models.layers import act_fn
from multimodal_rssm_torch.ops import gaussian
from multimodal_rssm_torch.ops import returns as rt

MODE_SAMPLES = 100   # samples of the reference's mode-seeking action


def _float32(forward):
    """Run ``forward`` with autocast off, on float32 inputs."""
    @functools.wraps(forward)
    def wrapped(self, *args):
        x = next(a for a in args if isinstance(a, torch.Tensor))
        with torch.autocast(x.device.type, enabled=False):
            return forward(self, *(a.float() if isinstance(a, torch.Tensor)
                                   else a for a in args))
    return wrapped


def _add_linears(module: nn.Module, sizes: Sequence[int]) -> None:
    """``module.fc1`` ... ``fcN`` for consecutive widths."""
    for i, (a, b) in enumerate(zip(sizes, sizes[1:])):
        setattr(module, f"fc{i + 1}", nn.Linear(a, b))


def _normal(eps: Optional[torch.Tensor], shape, generator, like: torch.Tensor
            ) -> torch.Tensor:
    """``eps`` (checked against ``shape``), or a standard-normal draw of
    ``shape`` from ``generator``."""
    if eps is None:
        return torch.randn(shape, generator=generator, device=like.device)
    if tuple(eps.shape) != tuple(shape):
        raise ValueError(f"noise of shape {tuple(eps.shape)}, expected "
                         f"{tuple(shape)}")
    return eps.to(like.device, torch.float32)


class ValueModel(nn.Module):
    """V(h, s): three hidden layers, a scalar Gaussian of scale 1 (ref
    policy.py:11-43).  Inputs [..., H] and [..., S], output [...]."""

    def __init__(self, belief_size: int, state_size: int, hidden_size: int,
                 activation_function: str = "relu"):
        super().__init__()
        _add_linears(self, [belief_size + state_size, hidden_size,
                            hidden_size, hidden_size, 1])
        self.act = act_fn(activation_function)

    def trunk(self, h: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        x = torch.cat([h, s], -1)
        for fc in (self.fc1, self.fc2, self.fc3):
            x = self.act(fc(x))
        return self.fc4(x)

    @_float32
    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        loc = self.trunk(h, s)[..., 0]
        return {"loc": loc, "scale": torch.ones_like(loc)}

    def get_log_prob(self, h, s, r):
        out = self(h, s)
        return gaussian.log_prob(out["loc"], out["scale"], r)


class TwoHotValueModel(ValueModel):
    """The DreamerV3 critic: ``ValueModel``'s trunk to ``num_bins`` logits
    over fixed symlog bins; ``loc`` is the decoded value
    symexp(E_softmax[bins]), so every consumer of ``ValueModel`` works
    unchanged.  Trained by cross-entropy against the two-hot encoding of
    symlog(target) (``train/behavior.py``)."""

    def __init__(self, belief_size: int, state_size: int, hidden_size: int,
                 num_bins: int = 255, activation_function: str = "relu"):
        super().__init__(belief_size, state_size, hidden_size,
                         activation_function)
        self.fc4 = nn.Linear(hidden_size, num_bins)
        self.num_bins = num_bins

    @_float32
    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        logits = self.trunk(h, s)
        bins = rt.bin_centers(self.num_bins, device=logits.device)
        value = rt.symexp(rt.twohot_decode(torch.softmax(logits, -1), bins))
        return {"loc": value, "logits": logits,
                "scale": torch.ones_like(value)}


def policy_dist(raw: torch.Tensor, mean_scale: float, init_std: float,
                min_std: float) -> Dict[str, torch.Tensor]:
    """(loc, scale) of the policy heads from fc5's output (ref :87-92)."""
    raw_init_std = math.log(math.exp(init_std) - 1.0)
    mean, raw_std = raw.chunk(2, dim=-1)
    mean = mean_scale * torch.tanh(mean / mean_scale)
    std = F.softplus(raw_std + raw_init_std) + min_std
    return {"loc": mean, "scale": std}


class _PolicyHead(nn.Module):
    """Four hidden layers and fc5 to the tanh-normal's (loc, scale)."""

    def __init__(self, in_size: int, hidden_size: int, action_size: int,
                 activation_function: str = "elu", min_std: float = 1e-4,
                 init_std: float = 5.0, mean_scale: float = 5.0):
        super().__init__()
        _add_linears(self, [in_size] + [hidden_size] * 4 + [2 * action_size])
        self.act = act_fn(activation_function)
        self.min_std, self.init_std = min_std, init_std
        self.mean_scale = mean_scale

    def dist(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        for fc in (self.fc1, self.fc2, self.fc3, self.fc4):
            x = self.act(fc(x))
        return policy_dist(self.fc5(x), self.mean_scale,
                           self.init_std, self.min_std)

    def sample_dist(self, d, eps=None, generator=None,
                    sample_shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """loc + scale * eps, eps of shape sample_shape + loc's."""
        eps = _normal(eps, (*sample_shape, *d["loc"].shape), generator,
                      d["loc"])
        return d["loc"] + d["scale"] * eps


class Pie(_PolicyHead):
    """tanh-normal policy head pi(a | h, s) (ref :46-101)."""

    def __init__(self, belief_size: int, state_size: int, hidden_size: int,
                 action_size: int, **kwargs):
        super().__init__(belief_size + state_size, hidden_size, action_size,
                         **kwargs)

    @_float32
    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        return self.dist(torch.cat([h, s], -1))

    def sample(self, h, s, eps=None, generator=None, sample_shape=()):
        return self.sample_dist(self(h, s), eps, generator, sample_shape)

    def get_log_prob(self, h, s, a):
        d = self(h, s)
        return gaussian.log_prob(d["loc"], d["scale"], a)


def mode_seeking_action(d: Mapping[str, torch.Tensor], raw: torch.Tensor
                        ) -> torch.Tensor:
    """The reference's deterministic action (ref :119-133): of the N
    samples ``raw`` [N, B, A] of the tanh-normal ``d``, the tanh-squashed
    one with the highest squash-corrected log density, per batch row."""
    actions = torch.tanh(raw)
    logprob = gaussian.log_prob(d["loc"], d["scale"], raw)
    logprob = logprob - torch.log(1.0 - actions * actions + 1e-6)
    idx = torch.argmax(logprob.sum(-1), dim=0)                  # [B]
    return torch.gather(actions, 0, idx[None, :, None].expand(
        1, *actions.shape[1:]))[0]


def _act(head: _PolicyHead, d, det: bool, eps, generator) -> torch.Tensor:
    if det:
        return mode_seeking_action(d, head.sample_dist(
            d, eps, generator, (MODE_SAMPLES,)))
    return torch.tanh(head.sample_dist(d, eps, generator))


class ActorModel(nn.Module):
    """tanh-squashed actor (ref :103-138): ``forward(h, s, generator, det,
    eps)`` -> an action [B, A] in [-1, 1].  ``eps`` is the head's noise,
    [B, A] for a sample, [100, B, A] for the mode-seeking action
    (``det=True``)."""

    def __init__(self, belief_size: int, state_size: int, hidden_size: int,
                 action_size: int, activation_function: str = "elu",
                 min_std: float = 1e-4, init_std: float = 5.0,
                 mean_scale: float = 5.0):
        super().__init__()
        self.action_size = action_size
        self.pie = Pie(belief_size, state_size, hidden_size, action_size,
                       activation_function=activation_function,
                       min_std=min_std, init_std=init_std,
                       mean_scale=mean_scale)

    def forward(self, h: torch.Tensor, s: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                det: bool = False, eps: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return _act(self.pie, self.pie(h, s), det, eps, generator)


class PieEmb(_PolicyHead):
    """Embedding-conditioned policy head (ref :140-195)."""

    @_float32
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.dist(x)

    def sample(self, x, eps=None, generator=None, sample_shape=()):
        return self.sample_dist(self(x), eps, generator, sample_shape)


class ActorModelEnc(nn.Module):
    """Observation-conditioned actor: the modality's encoder, then
    ``PieEmb`` (ref :197-240).  ``forward(obs, generator, det, eps)`` with
    ``obs`` [B, ...] (images NHWC); the encoder's norms follow the module's
    train / eval mode."""

    def __init__(self, name_enc: str,
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str], hidden_size: int,
                 action_size: int, normalization: Optional[str] = None):
        super().__init__()
        self.encoder = build_encoder(name_enc, observation_shapes,
                                     embedding_size, activation_function,
                                     normalization)
        self.pie = PieEmb(modality_embedding_size(name_enc, embedding_size),
                          hidden_size, action_size,
                          activation_function=activation_function["dense"])

    def forward(self, obs: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                det: bool = False, eps: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = self.encoder(obs)
        return _act(self.pie, self.pie(x), det, eps, generator)
