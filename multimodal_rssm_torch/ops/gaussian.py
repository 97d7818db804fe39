"""Diagonal-Gaussian primitives as plain functions on tensors.

Kept as small functions (not ``torch.distributions``) so the loss math is
explicit float32 arithmetic whatever the compute dtype.
"""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def rsample(mean, std, eps):
    """Reparameterised sample from pre-drawn standard-normal noise."""
    return mean + std * eps


def log_prob(mean, std, value):
    """Elementwise diagonal-Gaussian log density."""
    var = std * std
    return -((value - mean) ** 2) / (2 * var) - torch.log(std) - _LOG_SQRT_2PI


def kl_normal(mean_q, std_q, mean_p, std_p):
    """Elementwise KL( N(mean_q, std_q) || N(mean_p, std_p) )."""
    var_ratio = (std_q / std_p) ** 2
    t1 = ((mean_q - mean_p) / std_p) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


def kl_standard_normal(mean_q, std_q):
    """KL against the global prior N(0, I)."""
    return kl_normal(mean_q, std_q, torch.zeros_like(mean_q),
                     torch.ones_like(std_q))
