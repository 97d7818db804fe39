"""Observation encoders (reference utils/models/encoder.py:307-360,
661-810, 882-973).

- ``ImageEncoder64``: four k4 s2 convs (32 -> 256 channels), each followed
  by the configured norm and relu, flattened in NCHW order to 1024 (plus
  ``fc`` + activation when the embedding is not 1024);
- ``SoundEncoderV2``: StarGAN-VC2-style GLU down-sampling over a
  [128, 20] spectrogram.  The JAX package's ``PackedWidthConv`` and
  ``GroupedDownConversion`` are TPU reshapes of the plain convs used here;
  the parameters keep the reference's layout.

``MultimodalStochasticEncoder`` (``expert_dist="q(st|ot)"``) puts a
q(s_t | o_t) head after each modality's encoder, so the experts come out of
the encoder; its children are ``<name>`` and ``<name>_head``, the JAX
package's module paths.

Inputs follow the JAX package: images [N, H, W, C], sound [N, 128, 20].
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from multimodal_rssm_torch.models.heads import ObsEncoderNoBelief
from multimodal_rssm_torch.models.layers import (
    BatchNorm, InstanceNorm, act_fn, glu)


class GLU(nn.Module):
    """``nn.GLU(dim=1)`` with the port's ``glu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x, dim=1)


def has_norm(normalization: Optional[str]) -> bool:
    if normalization in (None, "None"):
        return False
    if normalization != "BatchNorm":
        raise NotImplementedError(
            f"normalization {normalization!r}: the port runs BatchNorm and "
            "None so far")
    return True


class ImageEncoder64(nn.Module):
    """64px image encoder (ref encoder.py:307-360)."""

    layer_defs = ((32, 4, 2), (64, 4, 2), (128, 4, 2), (256, 4, 2))

    def __init__(self, embedding_size: int = 1024,
                 activation_function: str = "relu",
                 normalization: Optional[str] = "BatchNorm",
                 in_channels: int = 3):
        super().__init__()
        norm = has_norm(normalization)
        layers = []
        c = in_channels
        for features, kernel, stride in self.layer_defs:
            layers.append(nn.Conv2d(c, features, kernel, stride, bias=not norm))
            if norm:
                layers.append(BatchNorm(features))
            layers.append(nn.ReLU())
            c = features
        self.conv = nn.Sequential(*layers)
        self.embedding_size = embedding_size
        if embedding_size != 1024:
            self.fc = nn.Linear(1024, embedding_size)
            self.act = act_fn(activation_function)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.permute(0, 3, 1, 2))
        x = x.reshape(x.shape[0], -1)  # NCHW flatten (ref .reshape(-1, 1024))
        if self.embedding_size != 1024:
            x = self.act(self.fc(x))
        return x


class SoundEncoderV2(nn.Module):
    """GLU down-sampling sound encoder (ref encoder.py:661-721):
    [N, 128, 20] -> [N, embedding_size]."""

    def __init__(self, embedding_size: int = 256, channels_base: int = 128):
        super().__init__()
        cb = channels_base
        self.embedding_size = embedding_size
        self.down_sample_1 = nn.Sequential(
            nn.Conv2d(1, cb, (3, 9), 1, (1, 4), bias=False), GLU())
        defs = ((cb // 2, cb * 2, (4, 8), (2, 2), (1, 3)),
                (cb, cb * 4, (4, 8), (2, 2), (1, 3)),
                (cb * 2, cb * 4, (3, 4), (1, 1), (1, 1)))
        for i, (cin, cout, k, s, p) in enumerate(defs, start=2):
            setattr(self, f"down_sample_{i}", nn.Sequential(
                nn.Conv2d(cin, cout, k, s, p, bias=False),
                InstanceNorm(cout), GLU()))
        # torch groups (C, H) of the [N, 2cb, 32, 4] map into the conv1d
        # channel: view(N, 2cb * 32, 4), channel c*32 + h
        self.down_conversion = nn.Sequential(
            nn.Conv1d(cb * 2 * 32, embedding_size // 2, 1, bias=False),
            InstanceNorm(embedding_size // 2, track_running_stats=False),
            GLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down_sample_1(x[:, None])
        x = self.down_sample_4(self.down_sample_3(self.down_sample_2(x)))
        N, C, H, W = x.shape
        x = self.down_conversion(x.reshape(N, C * H, W))
        return x.reshape(N, self.embedding_size)  # channel-major flatten


def modality_embedding_size(name: str, embedding_size: Mapping[str, int]
                            ) -> int:
    """The embedding width of a modality's encoder."""
    if "image" in name:
        return embedding_size["image"]
    if "sound" in name:
        return embedding_size["sound"]
    return embedding_size["other"]


def build_encoder(name: str, observation_shapes: Mapping[str, Sequence[int]],
                  embedding_size: Mapping[str, int],
                  activation_function: Mapping[str, str],
                  normalization: Optional[str]) -> nn.Module:
    """Name-dispatch factory (ref ``build_Encoder``): "image" -> image
    encoder, "sound" -> SoundEncoderV2."""
    shape = observation_shapes[name]
    if "image" in name:
        if tuple(shape[1:]) != (64, 64):
            raise NotImplementedError(
                f"{name} {tuple(shape)}: the port runs 64px images so far")
        return ImageEncoder64(embedding_size["image"],
                              activation_function["cnn"], normalization,
                              in_channels=shape[0])
    if "sound" in name:
        return SoundEncoderV2(embedding_size["sound"])
    raise NotImplementedError(
        f"{name}: the port has no encoder for symbolic modalities yet")


class MultimodalEncoder(nn.ModuleDict):
    """Dict-in/dict-out encoder, one child per modality, keyed by its name
    as in the reference's ``encoder[name]`` state dicts (ref :746-810).  It
    encodes the modalities it is given."""

    def __init__(self, observation_names_enc: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 normalization: Optional[str] = "BatchNorm"):
        super().__init__({
            name: build_encoder(name, observation_shapes, embedding_size,
                                activation_function, normalization)
            for name in observation_names_enc})

    def forward(self, observations: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return {name: self[name](x) for name, x in observations.items()}


class MultimodalStochasticEncoder(nn.ModuleDict):
    """Per-modality experts q(s_t | o_t): each modality's encoder, then its
    ``ObsEncoderNoBelief`` head (activation ``dense``), as
    ``{name: {loc, scale}}`` for the modalities it is given (ref
    :882-973)."""

    def __init__(self, observation_names_enc: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 normalization: Optional[str], state_size: int,
                 hidden_size: int, min_std_dev: float = 0.1):
        modules = {}
        for name in observation_names_enc:
            modules[name] = build_encoder(name, observation_shapes,
                                          embedding_size, activation_function,
                                          normalization)
            modules[f"{name}_head"] = ObsEncoderNoBelief(
                modality_embedding_size(name, embedding_size), hidden_size,
                state_size, activation_function["dense"], min_std_dev)
        super().__init__(modules)

    def forward(self, observations: Mapping[str, torch.Tensor]
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: self[f"{name}_head"](self[name](x))
                for name, x in observations.items()}
