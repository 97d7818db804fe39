"""Observation decoders p(o_t | h_t, s_t) for the default configuration
(reference utils/models/observation_model.py:58-105, 420-472, 537-612).

Decoders take stacked [T, B, .] beliefs and states, fold (T, B) into one
batch and unfold afterwards.  Image outputs are [T, B, H, W, C] (the JAX
package's layout), sound outputs [T, B, 128, 20].

Reference quirk kept for weight compatibility: the sound decoder's input is
cat([state, belief]), the opposite of every other head.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from multimodal_rssm_torch.models.encoders import GLU, has_norm
from multimodal_rssm_torch.models.layers import (
    BatchNorm, InstanceNorm, fold_tb, unfold_tb)


def _fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([fold_tb(a), fold_tb(b)], -1)


class ImageDecoder64(nn.Module):
    """64px decoder: fc1 to a 1x1 seed (no nonlinearity), then k5/k5/k6/k6
    s2 ConvTranspose stack; every ConvT but the last is followed by the norm
    and relu (ref :58-105)."""

    layer_defs = ((128, 5, 2), (64, 5, 2), (32, 6, 2), (0, 6, 2))

    def __init__(self, belief_size: int, state_size: int,
                 embedding_size: int = 1024,
                 normalization: Optional[str] = "BatchNorm",
                 image_dim: int = 3):
        super().__init__()
        norm = has_norm(normalization)
        self.embedding_size = embedding_size
        self.fc1 = nn.Linear(belief_size + state_size, embedding_size)
        layers = []
        c = embedding_size
        for i, (features, kernel, stride) in enumerate(self.layer_defs):
            last = i == len(self.layer_defs) - 1
            out = image_dim if last else features
            layers.append(nn.ConvTranspose2d(c, out, kernel, stride,
                                             bias=last or not norm))
            if not last:
                if norm:
                    layers.append(BatchNorm(out))
                layers.append(nn.ReLU())
            c = out
        self.conv = nn.Sequential(*layers)

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        T, B = h.shape[:2]
        x = self.fc1(_fold(h, s)).reshape(T * B, self.embedding_size, 1, 1)
        x = self.conv(x).permute(0, 2, 3, 1).float()
        return {"loc": unfold_tb(x, T, B), "scale": 1.0}


class SoundDecoderV2(nn.Module):
    """GLU up-sampling sound decoder (ref :420-472): a 1x1 ``up_conversion``
    to a [2cb, 32, 4] map, three ConvT + InstanceNorm + GLU stages, and a
    7x7 single-channel ``out`` conv (the JAX package's
    ``PackedSingleChannelConv`` computes the same conv)."""

    def __init__(self, belief_size: int, state_size: int,
                 channels_base: int = 128):
        super().__init__()
        cb = channels_base
        self.seed_shape = (cb * 2, 32, 4)
        self.up_conversion = nn.Conv1d(state_size + belief_size,
                                       cb * 2 * 32 * 4, 1, bias=False)
        defs = ((cb * 2, cb * 4, (3, 4), (1, 1), (1, 1)),
                (cb * 2, cb * 2, (4, 4), (2, 2), (1, 1)),
                (cb, cb, (4, 4), (2, 2), (1, 1)))
        for i, (cin, cout, k, s, p) in enumerate(defs):
            setattr(self, f"up_sample_{i}", nn.Sequential(
                nn.ConvTranspose2d(cin, cout, k, s, p, bias=False),
                InstanceNorm(cout), GLU()))
        self.out = nn.Conv2d(cb // 2, 1, 7, 1, 3, bias=False)

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        T, B = h.shape[:2]
        x = self.up_conversion(_fold(s, h)[:, :, None])
        x = x.reshape(T * B, *self.seed_shape)
        x = self.up_sample_2(self.up_sample_1(self.up_sample_0(x)))
        x = self.out(x)[:, 0].float()
        return {"loc": unfold_tb(x, T, B), "scale": 1.0}


def build_observation_model(name: str,
                            observation_shapes: Mapping[str, Sequence[int]],
                            belief_size: int, state_size: int,
                            embedding_size: Mapping[str, int],
                            normalization: Optional[str]) -> nn.Module:
    """Name-dispatch factory (ref ``build_ObservationModel``)."""
    shape = observation_shapes[name]
    if "image" in name:
        if tuple(shape[1:]) != (64, 64):
            raise NotImplementedError(
                f"{name} {tuple(shape)}: the port runs 64px images so far")
        return ImageDecoder64(belief_size, state_size, embedding_size["image"],
                              normalization, image_dim=shape[0])
    if "sound" in name:
        return SoundDecoderV2(belief_size, state_size)
    raise NotImplementedError(
        f"{name}: the port has no decoder for symbolic modalities yet")


class MultimodalObservationModel(nn.ModuleDict):
    """Dict of decoders keyed by modality name, with per-modality MSE."""

    def __init__(self, observation_names_rec: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 belief_size: int, state_size: int,
                 embedding_size: Mapping[str, int],
                 normalization: Optional[str] = "BatchNorm"):
        super().__init__({
            name: build_observation_model(name, observation_shapes,
                                          belief_size, state_size,
                                          embedding_size, normalization)
            for name in observation_names_rec})

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: dec(h, s) for name, dec in self.items()}

    def get_mse(self, h: torch.Tensor, s: torch.Tensor,
                targets: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-element squared error of each modality's mean."""
        return {name: torch.square(dec(h, s)["loc"] - targets[name])
                for name, dec in self.items()}
