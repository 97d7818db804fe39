"""Observation encoders (reference utils/models/encoder.py:282-973), every
variant the JAX package's ``models/encoders.py`` builds:

- ``SymbolicEncoder``: a 3-layer MLP for low-dimensional modalities
  (``pose_*``, ``weight_*``);
- ``ImageEncoder64 / 84 / 128 / 256``: VALID conv stacks (k4 s2, the 84 px
  one k4/k5/k5/k6), each conv followed by the configured norm (BatchNorm,
  InstanceNorm, GroupNorm or none; a conv has no bias under a norm) and
  relu, flattened in NCHW order to 1024 (plus ``fc`` + activation when the
  embedding is not 1024);
- ``SoundEncoder`` (v1): the GLU + BatchNorm conv stack; no factory builds
  it, in either package;
- ``SoundEncoderV2``: StarGAN-VC2-style GLU down-sampling over a
  [128, 20] spectrogram.  The JAX package's ``PackedWidthConv`` and
  ``GroupedDownConversion`` are TPU reshapes of the plain convs used here;
  the parameters keep the reference's layout;
- ``MultimodalEncoder`` (one child per modality) and ``Mixer`` /
  ``EncoderNN`` (concat + Linear fusion into one vector; no factory builds
  them either).

``MultimodalStochasticEncoder`` (``expert_dist="q(st|ot)"``) puts a
q(s_t | o_t) head after each modality's encoder, so the experts come out of
the encoder; its children are ``<name>`` and ``<name>_head``, the JAX
package's module paths.  Every codec is ``Rematerialised``: its forward is
checkpointed as ``rssm.remat`` says (``models/remat.py``).

Inputs follow the JAX package: images [N, H, W, C], sound [N, 128, 20].
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_rssm_torch.models.heads import ObsEncoderNoBelief
from multimodal_rssm_torch.models.layers import (
    BatchNorm, Conv1d, Conv2d, InstanceNorm, Linear, act_fn, glu, make_norm)
from multimodal_rssm_torch.models.remat import Rematerialised


class GLU(nn.Module):
    """``nn.GLU(dim=1)`` with the port's ``glu``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x, dim=1)


class SymbolicEncoder(nn.Module):
    """3-layer MLP encoder, an activation after each layer (ref
    :282-305)."""

    def __init__(self, observation_size: int, embedding_size: int,
                 activation_function: str = "relu"):
        super().__init__()
        self.fc1 = Linear(observation_size, embedding_size)
        self.fc2 = Linear(embedding_size, embedding_size)
        self.fc3 = Linear(embedding_size, embedding_size)
        self.act = act_fn(activation_function)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.fc1(x))
        return self.act(self.fc3(self.act(self.fc2(x))))


class ImageEncoder(Rematerialised):
    """VALID conv stack over ``layer_defs`` (features, kernel, stride), each
    conv followed by the norm and relu; NCHW flatten to 1024, then ``fc`` +
    activation when the embedding is not 1024 (ref :307-615)."""

    layer_defs: Tuple[Tuple[int, int, int], ...] = ()

    def __init__(self, embedding_size: int = 1024,
                 activation_function: str = "relu",
                 normalization: Optional[str] = "BatchNorm",
                 in_channels: int = 3):
        super().__init__()
        layers = []
        c = in_channels
        for features, kernel, stride in self.layer_defs:
            norm = make_norm(normalization, features)
            layers.append(Conv2d(c, features, kernel, stride,
                                    bias=norm is None))
            if norm is not None:
                layers.append(norm)
            layers.append(nn.ReLU())
            c = features
        self.conv = nn.Sequential(*layers)
        self.embedding_size = embedding_size
        if embedding_size != 1024:
            self.fc = Linear(1024, embedding_size)
            self.act = act_fn(activation_function)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x.permute(0, 3, 1, 2))
        x = x.reshape(x.shape[0], -1)  # NCHW flatten (ref .reshape(-1, 1024))
        if self.embedding_size != 1024:
            x = self.act(self.fc(x))
        return x


class ImageEncoder64(ImageEncoder):
    """64 px: channels 32 -> 256, k4 s2 (ref :307-360)."""

    layer_defs = ((32, 4, 2), (64, 4, 2), (128, 4, 2), (256, 4, 2))


class ImageEncoder84(ImageEncoder):
    """84 px: k4/k5/k5/k6 s2 (ref :362-413)."""

    layer_defs = ((32, 4, 2), (64, 5, 2), (128, 5, 2), (256, 6, 2))


class ImageEncoder128(ImageEncoder):
    """128 px: five k4 s2 convs, channels 16 -> 256 (ref :415-509)."""

    layer_defs = ((16, 4, 2), (32, 4, 2), (64, 4, 2), (128, 4, 2),
                  (256, 4, 2))


class ImageEncoder256(ImageEncoder):
    """256 px: six k4 s2 convs, channels 8 -> 256 (ref :511-615)."""

    layer_defs = ((8, 4, 2), (16, 4, 2), (32, 4, 2), (64, 4, 2),
                  (128, 4, 2), (256, 4, 2))


IMAGE_ENCODERS = {64: ImageEncoder64, 84: ImageEncoder84,
                  128: ImageEncoder128, 256: ImageEncoder256}


class SoundEncoder(Rematerialised):
    """v1 GLU + BatchNorm conv encoder (ref :617-658): [N, 128, 20] ->
    [N, 5, 10, 5] -> NCHW flatten to 250 (plus ``fc`` when the embedding is
    not 250)."""

    # (in, out, kernel, stride, padding); each conv is followed by
    # BatchNorm and a GLU that halves the channels
    layer_defs = ((1, 64, (3, 9), (1, 1), (1, 4)),
                  (32, 128, (4, 8), (2, 2), (1, 3)),
                  (64, 256, (4, 8), (2, 2), (1, 3)),
                  (128, 128, (3, 5), (1, 1), (1, 2)),
                  (64, 10, (5, 5), (3, 1), (1, 2)))

    def __init__(self, embedding_size: int = 250):
        super().__init__()
        layers = []
        for cin, cout, k, s, p in self.layer_defs:
            layers += [Conv2d(cin, cout, k, s, p, bias=False),
                       BatchNorm(cout), GLU()]
        self.conv = nn.Sequential(*layers)
        self.embedding_size = embedding_size
        if embedding_size != 250:
            self.fc = Linear(250, embedding_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x[:, None])
        x = x.reshape(x.shape[0], -1)
        return self.fc(x) if self.embedding_size != 250 else x


class SoundEncoderV2(Rematerialised):
    """GLU down-sampling sound encoder (ref encoder.py:661-721):
    [N, 128, 20] -> [N, embedding_size]."""

    def __init__(self, embedding_size: int = 256, channels_base: int = 128):
        super().__init__()
        cb = channels_base
        self.embedding_size = embedding_size
        self.down_sample_1 = nn.Sequential(
            Conv2d(1, cb, (3, 9), 1, (1, 4), bias=False), GLU())
        defs = ((cb // 2, cb * 2, (4, 8), (2, 2), (1, 3)),
                (cb, cb * 4, (4, 8), (2, 2), (1, 3)),
                (cb * 2, cb * 4, (3, 4), (1, 1), (1, 1)))
        for i, (cin, cout, k, s, p) in enumerate(defs, start=2):
            setattr(self, f"down_sample_{i}", nn.Sequential(
                Conv2d(cin, cout, k, s, p, bias=False),
                InstanceNorm(cout), GLU()))
        # torch groups (C, H) of the [N, 2cb, 32, 4] map into the conv1d
        # channel: view(N, 2cb * 32, 4), channel c*32 + h
        self.down_conversion = nn.Sequential(
            Conv1d(cb * 2 * 32, embedding_size // 2, 1, bias=False),
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


def build_image_encoder(observation_shape: Sequence[int], embedding_size: int,
                        activation_function: str,
                        normalization: Optional[str]) -> ImageEncoder:
    """Dispatch on the image's height (ref ``build_ImageEncoder``,
    :723-734): 64, 84, 128 or 256 px."""
    size = int(observation_shape[1])
    if size not in IMAGE_ENCODERS:
        raise ValueError(f"image size {size} not in {sorted(IMAGE_ENCODERS)}")
    return IMAGE_ENCODERS[size](embedding_size, activation_function,
                                normalization,
                                in_channels=int(observation_shape[0]))


def build_encoder(name: str, observation_shapes: Mapping[str, Sequence[int]],
                  embedding_size: Mapping[str, int],
                  activation_function: Mapping[str, str],
                  normalization: Optional[str],
                  remat_mode: Optional[str] = None) -> nn.Module:
    """Name-dispatch factory (ref ``build_Encoder``, :736-744): "image" ->
    image encoder by size, "sound" -> SoundEncoderV2, else SymbolicEncoder
    (activation ``dense``); ``remat_mode`` as ``remat.encoder_mode`` (the
    SymbolicEncoder is never rematerialised, as in the JAX package)."""
    shape = observation_shapes[name]
    if "image" in name:
        enc = build_image_encoder(shape, embedding_size["image"],
                                  activation_function["cnn"], normalization)
    elif "sound" in name:
        enc = SoundEncoderV2(embedding_size["sound"])
    else:
        return SymbolicEncoder(int(shape[0]), embedding_size["other"],
                               activation_function["dense"])
    enc.remat_mode = remat_mode
    return enc


def get_obs(observations: Mapping[str, torch.Tensor], name: str
            ) -> torch.Tensor:
    """``observations[name]``, with "observation" and "image" standing for
    each other (ref ``MultimodalEncoder.get_obs``, :764-773); a
    ``KeyError`` naming the keys there are."""
    if name in observations:
        return observations[name]
    if name == "observation" and "image" in observations:
        return observations["image"]
    if name == "image" and "observation" in observations:
        return observations["observation"]
    raise KeyError(f"{name} is missing in {list(observations.keys())}")


class MultimodalEncoder(nn.ModuleDict):
    """Dict-in/dict-out encoder, one child per modality, keyed by its name
    as in the reference's ``encoder[name]`` state dicts (ref :746-810).  It
    encodes ``names`` (default: each of its modalities), each looked up by
    ``get_obs``; other keys of the input are not read."""

    def __init__(self, observation_names_enc: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 normalization: Optional[str] = "BatchNorm",
                 remat_mode: Optional[str] = None):
        super().__init__({
            name: build_encoder(name, observation_shapes, embedding_size,
                                activation_function, normalization,
                                remat_mode)
            for name in observation_names_enc})

    def forward(self, observations: Mapping[str, torch.Tensor],
                names: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
        return {name: self[name](get_obs(observations, name))
                for name in (self.keys() if names is None else names)}


class Mixer(nn.Module):
    """Concat (in the hiddens' order) + Linear + activation (ref
    :812-828)."""

    def __init__(self, input_size: int, output_size: int,
                 activation_function: str = "relu"):
        super().__init__()
        self.fc = Linear(input_size, output_size)
        self.act = act_fn(activation_function)

    def forward(self, hiddens: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.act(self.fc(torch.cat(list(hiddens.values()), -1)))


class EncoderNN(nn.Module):
    """``MultimodalEncoder`` + ``Mixer`` into one fused embedding of width
    ``embedding_size["fusion"]`` (ref ``MultimodalEncoderNN``, :830-880, the
    JAX package's ``EncoderNN``, which repairs the reference's undefined
    attribute at :848).  Children ``multimodal_encoder`` and ``mixer``, the
    JAX package's names."""

    def __init__(self, observation_names_enc: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 normalization: Optional[str] = "BatchNorm"):
        super().__init__()
        self.multimodal_encoder = MultimodalEncoder(
            observation_names_enc, observation_shapes, embedding_size,
            activation_function, normalization)
        width = sum(modality_embedding_size(n, embedding_size)
                    for n in observation_names_enc)
        self.mixer = Mixer(width, embedding_size["fusion"],
                           activation_function["fusion"])

    def forward(self, observations: Mapping[str, torch.Tensor]
                ) -> torch.Tensor:
        return self.mixer(self.multimodal_encoder(observations))


class MultimodalStochasticEncoder(nn.ModuleDict):
    """Per-modality experts q(s_t | o_t): each modality's encoder, then its
    ``ObsEncoderNoBelief`` head (activation ``dense``), as
    ``{name: {loc, scale}}`` for ``names`` (default: each of its
    modalities), each looked up by ``get_obs`` (ref :882-973)."""

    def __init__(self, observation_names_enc: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 normalization: Optional[str], state_size: int,
                 hidden_size: int, min_std_dev: float = 0.1,
                 remat_mode: Optional[str] = None):
        modules = {}
        for name in observation_names_enc:
            modules[name] = build_encoder(name, observation_shapes,
                                          embedding_size, activation_function,
                                          normalization, remat_mode)
            modules[f"{name}_head"] = ObsEncoderNoBelief(
                modality_embedding_size(name, embedding_size), hidden_size,
                state_size, activation_function["dense"], min_std_dev)
        super().__init__(modules)
        self.observation_names_enc = tuple(observation_names_enc)

    def forward(self, observations: Mapping[str, torch.Tensor],
                names: Optional[Sequence[str]] = None
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: self[f"{name}_head"](self[name](get_obs(observations,
                                                              name)))
                for name in (self.observation_names_enc if names is None
                             else names)}
