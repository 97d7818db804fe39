"""Robust return / value transforms: the DreamerV3 toolkit.

Port of the JAX package's ``ops/returns.py``, used by ``train/behavior.py``
behind ``behavior.value_head=twohot_symlog`` and
``behavior.return_norm=true``:

- ``symlog`` / ``symexp``: a signed log squashing (DreamerV3 eq. 1);
- two-hot discrete regression over fixed symlog-spaced bins (eq. 9-10);
- percentile return normalisation: actor advantages divided by an EMA of
  the 5th-95th percentile return range, clipped below 1 (eq. 11).

Float32 functions on tensors.  ``jnp.percentile`` is ``torch.quantile``
with linear interpolation (both packages' default) and
``jnp.searchsorted(side="left")`` is ``torch.searchsorted(right=False)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """Inverse of symlog: sign(x) * (exp(|x|) - 1)."""
    return torch.sign(x) * torch.expm1(torch.abs(x))


def bin_centers(num_bins: int, low: float = -20.0, high: float = 20.0,
                device=None) -> torch.Tensor:
    """Fixed critic bins, linear in symlog space (DreamerV3: 255 bins over
    [-20, 20])."""
    return torch.linspace(low, high, num_bins, dtype=torch.float32,
                          device=device)


def twohot(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Two-hot encoding of ``x`` [...] onto ``bins`` [K] -> [..., K]: the
    two bins bracketing x weighted by proximity (summing to 1); values
    outside the bins clip to the end bins."""
    K = bins.shape[0]
    x = torch.clamp(x, bins[0], bins[-1])
    idx_hi = torch.clamp(torch.searchsorted(bins, x.contiguous(),
                                            right=False), 0, K - 1)
    idx_lo = torch.clamp(idx_hi - 1, 0, K - 1)
    width = bins[idx_hi] - bins[idx_lo]
    w_hi = torch.where(width > 0, (x - bins[idx_lo])
                       / torch.where(width > 0, width, torch.ones_like(width)),
                       torch.ones_like(width))
    w_hi = torch.clamp(w_hi, 0.0, 1.0)
    onehot_lo = F.one_hot(idx_lo, K).float()
    onehot_hi = F.one_hot(idx_hi, K).float()
    return onehot_lo * (1.0 - w_hi)[..., None] + onehot_hi * w_hi[..., None]


def twohot_decode(probs: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Expected bin value: [..., K] -> [...]."""
    return torch.sum(probs * bins, dim=-1)


def update_return_scale(prev_scale: torch.Tensor, returns: torch.Tensor,
                        decay: float = 0.99, percentile: float = 5.0,
                        step: Optional[int] = None) -> torch.Tensor:
    """EMA of the (100-p)th minus the p-th percentile of the returns (over
    all elements; no gradient).  At ``step`` 0 the statistic is the first
    batch's spread itself (the EMA's warm-up debias); ``step=None`` keeps
    the raw EMA."""
    r = returns.detach().float().reshape(-1)
    q = torch.tensor([1.0 - percentile / 100.0, percentile / 100.0],
                     device=r.device)
    hi, lo = torch.quantile(r, q, interpolation="linear")
    spread = hi - lo
    if step is not None and int(step) == 0:
        return spread
    return decay * prev_scale + (1.0 - decay) * spread


def normalize_returns(returns: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """returns / max(1, S): ranges below 1 are left as they are."""
    return returns / torch.clamp(scale.detach(), min=1.0)
