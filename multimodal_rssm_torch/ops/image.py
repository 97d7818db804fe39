"""Bit-depth image normalisation (PlaNet preprocessing).

Quantise pixels in [0, 255] to ``bit_depth`` bits, map to [-0.5, 0.5] and
add uniform dequantisation noise (reference
utils/processing/image_processing.py:5-16); plus the inverse mapping back
to uint8.  The fused, hand-written form of ``normalize_image`` is
``ops/cuda_kernels.normalize_image``.
"""

from __future__ import annotations

import numpy as np
import torch


def normalize_image_deterministic(observation: torch.Tensor,
                                  bit_depth: int) -> torch.Tensor:
    """[0, 255] -> quantised float32 in [-0.5, 0.5), without noise."""
    observation = observation.float()
    return torch.floor(observation / 2 ** (8 - bit_depth)) / 2 ** bit_depth - 0.5


def normalize_image(observation: torch.Tensor, bit_depth: int,
                    generator: torch.Generator) -> torch.Tensor:
    """Quantised value plus uniform [0, 1/2^bit_depth) noise drawn from
    ``generator`` (the reference uses ``torch.rand_like``)."""
    obs = normalize_image_deterministic(observation, bit_depth)
    noise = torch.rand(obs.shape, generator=generator, device=obs.device,
                       dtype=obs.dtype)
    return obs + noise / 2 ** bit_depth


def reverse_normalized_image(observation: np.ndarray,
                             bit_depth: int = 5) -> np.ndarray:
    """float [-0.5, 0.5] -> uint8 [0, 255] on the host (dataset ingest)."""
    arr = (np.floor((np.asarray(observation) + 0.5) * 2 ** bit_depth)
           * 2 ** (8 - bit_depth))
    return np.clip(arr, 0, 2 ** 8 - 1).astype(np.uint8)
