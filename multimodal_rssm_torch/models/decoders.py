"""Observation decoders p(o_t | h_t, s_t) (reference
utils/models/observation_model.py:33-612), every decoder the JAX package's
``models/decoders.py`` builds:

- ``DenseDecoder``: a 3-layer MLP for low-dimensional modalities;
- ``ImageDecoder64 / 84 / 128 / 256``: ``fc1`` (``fc`` at 84 px, the
  reference's name) to a 1x1 seed with no activation, then a ConvTranspose
  stack; every ConvT but the last is followed by the configured norm and
  relu and has no bias under a norm;
- ``SoundDecoder`` (v1, GLU + BatchNorm ConvT stack; no factory builds it,
  in either package) and ``SoundDecoderV2`` (GLU up-sampling);
- ``Discriminator``: logits for a label modality (``draw_target``).

Decoders take stacked [T, B, .] beliefs and states, fold (T, B) into one
batch and unfold afterwards.  Image outputs are [T, B, H, W, C] (the JAX
package's layout), sound outputs [T, B, 128, 20].

Reference quirk kept for weight compatibility: the sound decoders' input is
cat([state, belief]), the opposite of every other head.

Every decoder gives per-element losses of its mean against a target:
``get_mse`` (squared error) and ``get_log_prob`` (the unit-scale Gaussian
log density, the log-prob ELBO's term; ref :9-31).  The Discriminator's
are both the soft-target cross-entropy over the class axis, the JAX
package's documented deviation (the reference's ``F.cross_entropy`` on
[T, B, C] takes B as the class axis).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rssm_torch.models.encoders import GLU
from multimodal_rssm_torch.models.layers import (
    BatchNorm, Conv1d, Conv2d, ConvTranspose2d, InstanceNorm, Linear, act_fn,
    fold_tb, make_norm, unfold_tb)
from multimodal_rssm_torch.models.remat import Rematerialised
from multimodal_rssm_torch.ops import gaussian


def _fold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([fold_tb(a), fold_tb(b)], -1)


class Decoder(Rematerialised):
    """Per-element losses of a decoder's ``{loc, scale}`` output."""

    def get_mse(self, h: torch.Tensor, s: torch.Tensor, o: torch.Tensor
                ) -> torch.Tensor:
        return torch.square(self(h, s)["loc"] - o)

    def get_log_prob(self, h: torch.Tensor, s: torch.Tensor, o: torch.Tensor
                     ) -> torch.Tensor:
        out = self(h, s)
        scale = torch.as_tensor(out["scale"], dtype=torch.float32,
                                device=o.device)
        return gaussian.log_prob(out["loc"], scale, o)


class DenseDecoder(Decoder):
    """3-layer MLP decoder, activations after the first two layers (ref
    :33-54)."""

    def __init__(self, belief_size: int, state_size: int,
                 observation_size: int, embedding_size: int,
                 activation_function: str = "elu"):
        super().__init__()
        self.fc1 = Linear(belief_size + state_size, embedding_size)
        self.fc2 = Linear(embedding_size, embedding_size)
        self.fc3 = Linear(embedding_size, observation_size)
        self.act = act_fn(activation_function)

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        T, B = h.shape[:2]
        x = self.act(self.fc2(self.act(self.fc1(_fold(h, s)))))
        return {"loc": unfold_tb(self.fc3(x).float(), T, B), "scale": 1.0}


class Discriminator(DenseDecoder):
    """Logits head for a label modality (ref :474-513): fc1, fc2 (width
    ``hidden_size``, relu), fc3 to the classes; the losses are the
    soft-target cross-entropy -o * log_softmax(logits) per class."""

    def __init__(self, belief_size: int, state_size: int, hidden_size: int,
                 output_size: int = 2, activation_function: str = "relu"):
        super().__init__(belief_size, state_size, output_size, hidden_size,
                         activation_function)

    def _ce(self, h, s, o):
        return -(o * F.log_softmax(self(h, s)["loc"], dim=-1))

    def get_mse(self, h, s, o):
        return self._ce(h, s, o)

    def get_log_prob(self, h, s, o):
        return self._ce(h, s, o)


class ImageDecoder(Decoder):
    """fc to a 1x1 seed (no activation), then ConvTranspose2d over
    ``layer_defs`` (features, kernel, stride; the last layer's features are
    the image's channels), the norm and relu after every ConvT but the
    last (ref :58-378)."""

    layer_defs: Tuple[Tuple[int, int, int], ...] = ()
    fc_name = "fc1"

    def __init__(self, belief_size: int, state_size: int,
                 embedding_size: int = 1024,
                 normalization: Optional[str] = "BatchNorm",
                 image_dim: int = 3):
        super().__init__()
        self.embedding_size = embedding_size
        setattr(self, self.fc_name,
                Linear(belief_size + state_size, embedding_size))
        layers = []
        c = embedding_size
        for i, (features, kernel, stride) in enumerate(self.layer_defs):
            last = i == len(self.layer_defs) - 1
            out = image_dim if last else features
            norm = None if last else make_norm(normalization, out)
            layers.append(ConvTranspose2d(c, out, kernel, stride,
                                             bias=last or norm is None))
            if not last:
                if norm is not None:
                    layers.append(norm)
                layers.append(nn.ReLU())
            c = out
        self.conv = nn.Sequential(*layers)

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        T, B = h.shape[:2]
        x = getattr(self, self.fc_name)(_fold(h, s))
        x = self.conv(x.reshape(T * B, self.embedding_size, 1, 1))
        return {"loc": unfold_tb(x.permute(0, 2, 3, 1).float(), T, B),
                "scale": 1.0}


class ImageDecoder64(ImageDecoder):
    """64 px: k5/k5/k6/k6 s2 (ref :58-105)."""

    layer_defs = ((128, 5, 2), (64, 5, 2), (32, 6, 2), (0, 6, 2))


class ImageDecoder84(ImageDecoder):
    """84 px: k3/k4/k4/k6/k6 s2; its Linear is ``fc`` (ref :108-160)."""

    layer_defs = ((128, 3, 2), (64, 4, 2), (32, 4, 2), (16, 6, 2), (0, 6, 2))
    fc_name = "fc"


class ImageDecoder128(ImageDecoder):
    """128 px, channel scale 2 (ref :162-229)."""

    layer_defs = ((256, 6, 2), (128, 4, 2), (64, 4, 2), (32, 4, 2),
                  (0, 6, 2))


class ImageDecoder256(ImageDecoder):
    """256 px, channel scale 2 (ref :231-378)."""

    layer_defs = ((256, 6, 2), (128, 4, 2), (64, 4, 2), (32, 4, 2),
                  (16, 4, 2), (0, 6, 2))


IMAGE_DECODERS = {64: ImageDecoder64, 84: ImageDecoder84,
                  128: ImageDecoder128, 256: ImageDecoder256}


class SoundDecoder(Decoder):
    """v1 GLU + BatchNorm ConvTranspose sound decoder (ref :380-416):
    ``fc1`` (Linear, tanh, Linear) to 250 = a (5, 10, 5) NCHW seed, four
    ConvT + BatchNorm + GLU stages and a last (3, 9) ConvT to one
    channel."""

    # (in, out, kernel, stride, padding); GLU halves the channels
    layer_defs = ((5, 64, (5, 5), (3, 1), (1, 2)),
                  (32, 128, (5, 5), (1, 1), (1, 2)),
                  (64, 64, (4, 8), (2, 2), (1, 3)),
                  (32, 32, (4, 8), (2, 2), (1, 3)))

    def __init__(self, belief_size: int, state_size: int):
        super().__init__()
        self.fc1 = nn.Sequential(Linear(state_size + belief_size, 250),
                                 nn.Tanh(), Linear(250, 250))
        layers = []
        for cin, cout, k, s, p in self.layer_defs:
            layers += [ConvTranspose2d(cin, cout, k, s, p, bias=False),
                       BatchNorm(cout), GLU()]
        layers.append(ConvTranspose2d(16, 1, (3, 9), 1, (1, 4), bias=False))
        self.conv = nn.Sequential(*layers)

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        T, B = h.shape[:2]
        x = self.fc1(_fold(s, h)).reshape(T * B, 5, 10, 5)
        x = self.conv(x)[:, 0].float()
        return {"loc": unfold_tb(x, T, B), "scale": 1.0}


class SoundDecoderV2(Decoder):
    """GLU up-sampling sound decoder (ref :420-472): a 1x1 ``up_conversion``
    to a [2cb, 32, 4] map, three ConvT + InstanceNorm + GLU stages, and a
    7x7 single-channel ``out`` conv (the JAX package's
    ``PackedSingleChannelConv`` computes the same conv)."""

    def __init__(self, belief_size: int, state_size: int,
                 channels_base: int = 128):
        super().__init__()
        cb = channels_base
        self.seed_shape = (cb * 2, 32, 4)
        self.up_conversion = Conv1d(state_size + belief_size,
                                       cb * 2 * 32 * 4, 1, bias=False)
        defs = ((cb * 2, cb * 4, (3, 4), (1, 1), (1, 1)),
                (cb * 2, cb * 2, (4, 4), (2, 2), (1, 1)),
                (cb, cb, (4, 4), (2, 2), (1, 1)))
        for i, (cin, cout, k, s, p) in enumerate(defs):
            setattr(self, f"up_sample_{i}", nn.Sequential(
                ConvTranspose2d(cin, cout, k, s, p, bias=False),
                InstanceNorm(cout), GLU()))
        self.out = Conv2d(cb // 2, 1, 7, 1, 3, bias=False)

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
                            hidden_size: int,
                            embedding_size: Mapping[str, int],
                            activation_function: Mapping[str, str],
                            normalization: Optional[str],
                            remat_mode: Optional[str] = None) -> Decoder:
    """Name-dispatch factory (ref ``build_ObservationModel``, :515-533):
    "image" -> image decoder by size, "sound" -> SoundDecoderV2,
    "draw_target" -> Discriminator (width ``hidden_size``), else
    DenseDecoder (activation ``dense``); ``remat_mode`` as
    ``remat.decoder_mode`` (the Discriminator and DenseDecoder are never
    rematerialised, as in the JAX package)."""
    shape = observation_shapes[name]
    if "image" in name:
        size = int(shape[1])
        if size not in IMAGE_DECODERS:
            raise ValueError(f"image size {size} not in "
                             f"{sorted(IMAGE_DECODERS)}")
        dec = IMAGE_DECODERS[size](belief_size, state_size,
                                   embedding_size["image"], normalization,
                                   image_dim=int(shape[0]))
    elif "sound" in name:
        dec = SoundDecoderV2(belief_size, state_size)
    elif name == "draw_target":
        return Discriminator(belief_size, state_size, hidden_size,
                             int(shape[0]))
    else:
        return DenseDecoder(belief_size, state_size, int(shape[0]),
                            embedding_size["other"],
                            activation_function["dense"])
    dec.remat_mode = remat_mode
    return dec


class MultimodalObservationModel(nn.ModuleDict):
    """Dict of decoders keyed by modality name, with per-modality
    per-element losses."""

    def __init__(self, observation_names_rec: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 belief_size: int, state_size: int, hidden_size: int,
                 embedding_size: Mapping[str, int],
                 activation_function: Mapping[str, str],
                 normalization: Optional[str] = "BatchNorm",
                 remat_mode: Optional[str] = None):
        super().__init__({
            name: build_observation_model(
                name, observation_shapes, belief_size, state_size,
                hidden_size, embedding_size, activation_function,
                normalization, remat_mode)
            for name in observation_names_rec})

    def forward(self, h: torch.Tensor, s: torch.Tensor
                ) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: dec(h, s) for name, dec in self.items()}

    def get_mse(self, h: torch.Tensor, s: torch.Tensor,
                targets: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-element squared error of each modality's mean."""
        return {name: dec.get_mse(h, s, targets[name])
                for name, dec in self.items()}

    def get_log_prob(self, h: torch.Tensor, s: torch.Tensor,
                     targets: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Per-element log density of each modality's target."""
        return {name: dec.get_log_prob(h, s, targets[name])
                for name, dec in self.items()}

    def get_pred(self, h: torch.Tensor, s: torch.Tensor, key: str
                 ) -> Dict[str, torch.Tensor]:
        """One modality's ``{loc, scale}`` (ref get_pred_value,
        :583-587)."""
        return self[key](h, s)
