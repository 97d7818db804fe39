"""Noise drawn from a key in plain tensor ops, for programs frozen by
``torch.export``.

An exported program cannot take a ``torch.Generator``; the serving
artifacts (``io/export.py``) take a key ``int64 [2]`` (two 32-bit words,
as the JAX package's ``uint32[2]`` key data) and derive every draw they
need from it inside the graph, so the artifact needs no port code where it
is loaded.  The bits are Philox4x32-10 (``ops/cuda_kernels.philox4x32_10``,
int64 arithmetic), keyed by the two words, on counters (i, stream): each
draw of a program has its own ``stream`` and so its own counter range.

- ``uniform``: ((w >> 9) + 0.5) * 2^-23 of each 32-bit word w, exact in
  float32 and inside the open interval (0, 1);
- ``normal``: Box-Muller on the uniforms of words (2i, 2i + 1),
  sqrt(-2 ln u1) (cos, sin)(2 pi u2);
- ``gumbel``: -log(-log u).

The same key gives other draws than the JAX package's threefry would: the
port holds its artifacts to its own eager functions given these draws, and
those functions to the JAX package's given JAX's draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from multimodal_rssm_torch.ops.cuda_kernels import philox4x32_10


def key_seed(key: torch.Tensor) -> torch.Tensor:
    """The int64 Philox key (lo word, hi word) of a key [2] of 32-bit words
    (int64, or uint32 widened by the caller)."""
    key = key.to(torch.int64)
    return (key[0] & 0xFFFFFFFF) | ((key[1] & 0xFFFFFFFF) << 32)


def _words(key: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """n 32-bit Philox words (int64) of counters (i, stream), i = 0, 1, ..."""
    counters = torch.arange((n + 3) // 4, dtype=torch.int64,
                            device=key.device) + (int(stream) << 32)
    return philox4x32_10(counters, key_seed(key)).reshape(-1)[:n]


def uniform(key: torch.Tensor, shape: Sequence[int], stream: int
            ) -> torch.Tensor:
    """float32 uniform draws in the open interval (0, 1)."""
    n = math.prod(shape)
    u = ((_words(key, stream, n) >> 9).to(torch.float32) + 0.5) * 2.0 ** -23
    return u.reshape(tuple(shape))


def normal(key: torch.Tensor, shape: Sequence[int], stream: int
           ) -> torch.Tensor:
    """float32 standard-normal draws (Box-Muller); a shape's first n
    draws are those of any larger shape."""
    n = math.prod(shape)
    u = uniform(key, ((n + 1) // 2, 2), stream)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0]))
    theta = (2.0 * math.pi) * u[:, 1]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
    return z.reshape(-1)[:n].reshape(tuple(shape))


def gumbel(key: torch.Tensor, shape: Sequence[int], stream: int
           ) -> torch.Tensor:
    """float32 standard-Gumbel draws."""
    return -torch.log(-torch.log(uniform(key, shape, stream)))
