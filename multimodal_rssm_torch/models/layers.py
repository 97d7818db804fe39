"""Building blocks with the JAX package's semantics, as PyTorch modules.

Dense layers and convolutions are ``nn.Linear``, ``nn.Conv2d`` and
``nn.ConvTranspose2d`` with torch padding (the JAX package's ``Conv`` +
``torch_padding`` and its ``ConvTranspose`` variants are TPU lowerings of
the same math).  Image tensors are NCHW inside the modules; the world
model's public inputs and outputs keep the JAX package's NHWC layout.

The norms differ from their ``torch.nn`` namesakes on purpose:

- ``BatchNorm`` tracks the BIASED batch variance in its running stats
  (``nn.BatchNorm2d`` tracks the unbiased one);
- ``InstanceNorm`` updates its running stats in train mode from the batch
  mean of the per-instance statistics;
- ``GroupNorm`` (4 groups) is ``nn.GroupNorm``: its variance is the mean
  squared deviation, flax's E[x^2] - mean^2.

The compute dtype is explicit, as the JAX package's ``dtype=`` field:
every layer that owns parameters (``Linear``, ``Conv1d``, ``Conv2d``,
``ConvTranspose2d``, ``GRUCell`` and the norms) computes in its
``compute_dtype`` (float32 unless ``set_compute_dtype`` says otherwise)
and returns it, its parameters staying float32.  A layer casts its input,
weight and bias to that dtype on every call, as flax's ``astype`` does, so
a weight used at every step of the RSSM loop has its gradient summed in
float32, step by step, as under ``lax.scan``.  No autocast is involved:
the dtype of every layer is the same on the CPU and on CUDA.

BatchNorm and InstanceNorm compute ``var = max(E[x^2] - mean^2, 0)`` in
float32 and apply ``y = x * a + b`` in the compute dtype, as the JAX
package does; GroupNorm normalises in float32 and returns the compute
dtype, as flax's ``nn.GroupNorm(dtype=...)``.  ``make_norm`` builds the
one ``rssm.normalization`` names.  In bf16 every op rounds its output, as
eager PyTorch does and as XLA compiles the JAX package's program: XLA
rounds after every op of an elementwise chain, and skips only the
rounding of an op whose result the program converts straight to
float32.  The norms and the GLU follow the JAX program's rounding points
in the backward too, so that on the same bf16 inputs they are bit-equal
to the JAX package's (``tests/test_torch_port_precision.py``):
``_moments`` takes the mean and E[x^2] from two float32 views of ``x``
(each path's cotangent rounded on its own), ``_Affine`` rounds the direct
cotangent and sums the coefficients' cotangents over unrounded products,
and ``sigmoid`` rounds after each op of ``1 / (1 + exp(-x))`` and of its
derivative.  Elsewhere (the GRU's gates, the order in which a conv or a
matmul accumulates) the port's bf16 rounds as PyTorch's ops do.
Inside ``frozen_running_stats(module)`` no norm of ``module`` updates its
running stats (the recompute of a rematerialised codec runs the forward a
second time).

Inside ``synced_batch_stats(module, group)`` (a data-parallel step) the
batch statistics are those of the GLOBAL batch, as flax's under the JAX
package's sharded step: BatchNorm all-reduces its per-channel sum and sum
of squares over ``group`` (with their gradient) and divides by every
rank's count, then takes the same ``E[x^2] - mean^2``; InstanceNorm's
running-stat update all-reduces the sum of the per-instance moments.  Every rank then holds the same running
stats.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_rssm_torch.parallel.mesh import all_reduce_sum

_ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "gelu": F.gelu,
    "tanh": torch.tanh,
    "silu": F.silu,
    "leaky_relu": F.leaky_relu,
}


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation by name."""
    try:
        return _ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}") from e


class _Sigmoid(torch.autograd.Function):
    """The JAX package's ``jax.nn.sigmoid`` in a dtype below float32: its
    program ``1 / (1 + exp(-x))`` rounds after each op, and so does its
    derivative ``g * (s * (1 - s))`` (``torch.sigmoid`` rounds once)."""

    @staticmethod
    def forward(ctx, x):
        s = torch.exp(-x).add_(1.0).reciprocal_()
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``'s rounding in bf16 / f16 (``_Sigmoid``);
    ``torch.sigmoid`` in float32 and above."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return _Sigmoid.apply(x)
    return torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Gated linear unit over ``dim`` (torch ``nn.GLU``), with the JAX
    package's ``sigmoid``."""
    a, b = x.chunk(2, dim=dim)
    return a * sigmoid(b)


def fold_tb(x: torch.Tensor) -> torch.Tensor:
    """[T, B, ...] -> [B*T, ...], batch-major (the JAX package's fold)."""
    T, B = x.shape[:2]
    return x.transpose(0, 1).reshape(B * T, *x.shape[2:])


def unfold_tb(y: torch.Tensor, T: int, B: int) -> torch.Tensor:
    """Inverse of :func:`fold_tb`: [B*T, ...] -> [T, B, ...]."""
    return y.reshape(B, T, *y.shape[1:]).transpose(0, 1)


class ComputeDtype:
    """A layer that computes in ``compute_dtype`` (the JAX package's
    ``dtype`` field); ``set_compute_dtype`` sets it model-wide."""

    compute_dtype = torch.float32


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Every ``ComputeDtype`` layer of ``module`` computes in ``dtype``
    from now on (its parameters stay float32); returns ``module``."""
    for m in module.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype
    return module


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype
          ) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """``F.linear`` in ``dtype``, its float32 ``weight`` and ``bias`` cast
    on every call."""
    return F.linear(x.to(dtype), weight.to(dtype), _cast(bias, dtype))


class Linear(ComputeDtype, nn.Linear):
    """``nn.Linear`` in ``compute_dtype`` (the JAX package's ``Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.compute_dtype)


class Conv1d(ComputeDtype, nn.Conv1d):
    """``nn.Conv1d`` in ``compute_dtype``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d),
                                  _cast(self.bias, d))


class Conv2d(ComputeDtype, nn.Conv2d):
    """``nn.Conv2d`` in ``compute_dtype`` (the JAX package's ``Conv``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d),
                                  _cast(self.bias, d))


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in ``compute_dtype`` (the JAX package's
    ``ConvTranspose``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv_transpose2d(x.to(d), self.weight.to(d),
                                  _cast(self.bias, d), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class _Affine(torch.autograd.Function):
    """``y = x * a + b`` in ``dtype``, ``a`` and ``b`` float32 coefficients
    cast to ``dtype`` (1 on the axes they broadcast over), with the
    backward XLA compiles for the JAX package's norms: the direct
    cotangent ``dy * a`` rounded to ``dtype``; the cotangents of ``a`` and
    ``b`` summed in float32 and rounded once to ``dtype``, the products
    ``dy * x`` unrounded (XLA does not round an op whose result it
    converts straight to float32; a bf16 x bf16 product is exact in
    float32).  ``xf``: ``x`` in float32 if the caller holds it (kept for
    the backward in place of ``x`` when ``x`` is in ``dtype``)."""

    @staticmethod
    def forward(ctx, x, a, b, dtype, xf):
        x_c, a_c = x.to(dtype), a.to(dtype)
        ctx.save_for_backward(x_c if xf is None or x.dtype != dtype else xf,
                              a_c)
        ctx.dims = tuple(d for d in range(x.ndim) if a.shape[d] == 1)
        return x_c * a_c + b.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        xs, a_c = ctx.saved_tensors
        dims, dtype = ctx.dims, a_c.dtype
        da = (dy * xs.float()).sum(dims, keepdim=True).to(dtype).float()
        db = dy.sum(dims, keepdim=True).float()
        return dy * a_c, da, db, None, None


def _normalize(x, mean, var, weight, bias, eps, shape, dtype, xf=None):
    a = weight.float().reshape(shape) * torch.rsqrt(var + eps)
    b = bias.float().reshape(shape) - mean * a
    return _Affine.apply(x, a, b, dtype, xf)


def _moments(x: torch.Tensor, dims: Tuple[int, ...]):
    """(mean, biased variance, ``x`` in float32): the mean from one float32
    view of ``x`` and E[x^2] from another, as the JAX package's
    ``jnp.mean(x, dtype=f32)`` and ``jnp.square(x.astype(f32))``, so that
    each path's cotangent is rounded to ``x``'s dtype on its own."""
    mean = x.mean(dims, keepdim=True, dtype=torch.float32)
    xf = x.float()
    var = torch.clamp(xf.square().mean(dims, keepdim=True) - mean * mean,
                      min=0.0)
    return mean, var, xf


def _global_moments(x: torch.Tensor, dims: Tuple[int, ...], group):
    """``_moments`` over the rows of every rank of ``group``: the sums and
    the sums of squares all-reduced (differentiably).  The count is the
    local count times the group's size: every rank holds the same number
    of rows (``parallel/mesh.BatchShard``)."""
    xf = x.float()
    c = x.shape[1]
    sums = all_reduce_sum(torch.cat([x.sum(dims, dtype=torch.float32),
                                     xf.square().sum(dims)]), group)
    count = (x.numel() // c) * torch.distributed.get_world_size(group)
    shape = (1, c) + (1,) * (x.ndim - 2)
    mean = (sums[:c] / count).reshape(shape)
    var = torch.clamp((sums[c:] / count).reshape(shape) - mean * mean,
                      min=0.0)
    return mean, var, xf


class _Norm(ComputeDtype, nn.Module):
    """Affine norm over channel axis 1 with torch's parameter names.
    ``frozen``: train mode updates no running stats."""

    frozen = False
    group = None    # the data-parallel group of synced_batch_stats

    def __init__(self, num_features: int, track_running_stats: bool = True,
                 momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.track_running_stats = track_running_stats
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(num_features))
            self.register_buffer("running_var", torch.ones(num_features))
            self.register_buffer("num_batches_tracked",
                                 torch.tensor(0, dtype=torch.long))

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self.frozen:
            return
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * var)
        self.num_batches_tracked += 1


class BatchNorm(_Norm):
    """BatchNorm over all axes but 1 (eps 1e-5, momentum 0.1); the running
    variance is the biased batch variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.ndim))
            mean, var, xf = (_moments(x, dims) if self.group is None
                             else _global_moments(x, dims, self.group))
            self._update(mean.reshape(-1), var.reshape(-1))
        else:
            mean = self.running_mean.reshape(shape)
            var = self.running_var.reshape(shape)
            xf = None
        return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                          shape, self.compute_dtype, xf)


class InstanceNorm(_Norm):
    """Per-sample, per-channel norm over the spatial axes (torch
    ``InstanceNorm{1,2}d(affine=True)``).  With ``track_running_stats``, eval
    mode uses the running stats, and train mode updates them from the batch
    mean of the per-instance mean and (biased) variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.track_running_stats and not self.training:
            mean = self.running_mean.reshape(shape)
            var = self.running_var.reshape(shape)
            xf = None
        else:
            mean, var, xf = _moments(x, tuple(range(2, x.ndim)))
            if self.track_running_stats:
                self._update(*self._batch_mean(mean, var))
        return _normalize(x, mean, var, self.weight, self.bias, self.eps,
                          shape, self.compute_dtype, xf)

    @torch.no_grad()
    def _batch_mean(self, mean: torch.Tensor, var: torch.Tensor):
        """The per-instance moments averaged over the batch (every rank's
        rows under ``synced_batch_stats``)."""
        if self.group is None:
            return mean.mean(0).reshape(-1), var.mean(0).reshape(-1)
        c = mean.shape[1]
        sums = all_reduce_sum(torch.cat([mean.sum(0).reshape(-1),
                                         var.sum(0).reshape(-1)]),
                              self.group)
        sums /= mean.shape[0] * torch.distributed.get_world_size(self.group)
        return sums[:c], sums[c:]


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """No norm inside ``module`` updates its running stats (or
    ``num_batches_tracked``) within this block; train mode still normalises
    with batch statistics."""
    norms = [m for m in module.modules() if isinstance(m, _Norm)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


@contextlib.contextmanager
def synced_batch_stats(module: nn.Module, group):
    """Within this block the BatchNorms and InstanceNorms of ``module`` take
    their batch statistics over every rank of ``group`` (None: this
    process's rows only)."""
    norms = [m for m in module.modules() if isinstance(m, _Norm)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


class GroupNorm(ComputeDtype, nn.GroupNorm):
    """``nn.GroupNorm`` with flax's ``nn.GroupNorm(num_groups=4,
    epsilon=1e-5)`` configuration, taking ``num_features`` as the port's
    other norms do.  Flax computes the variance as E[x^2] - E[x]^2, torch
    as the mean squared deviation: they agree to float32 rounding of
    E[x^2] (the tests state the tolerance).  It normalises in float32 and
    returns ``compute_dtype``, as flax's ``nn.GroupNorm(dtype=...)``."""

    def __init__(self, num_features: int, num_groups: int = 4,
                 eps: float = 1e-5):
        super().__init__(num_groups, num_features, eps=eps)
        self.num_features = num_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


NORMALIZATIONS = ("BatchNorm", "InstanceNorm", "GroupNorm", None, "None")


def make_norm(normalization: Optional[str], num_features: int
              ) -> Optional[nn.Module]:
    """The norm ``rssm.normalization`` names for ``num_features`` channels,
    or None for ``None`` / ``"None"``; raises ``ValueError`` on a value the
    JAX package does not build.  InstanceNorm tracks running stats and
    reads them in ``eval()``, as the JAX package's
    ``use_running_average=not train``."""
    if normalization not in NORMALIZATIONS:
        raise ValueError(f"rssm.normalization={normalization!r} not in "
                         f"{NORMALIZATIONS}")
    if normalization in (None, "None"):
        return None
    return {"BatchNorm": BatchNorm, "InstanceNorm": InstanceNorm,
            "GroupNorm": GroupNorm}[normalization](num_features)


class GRUCell(ComputeDtype, nn.Module):
    """GRU cell with ``torch.nn.GRUCell``'s parameters and gate order
    (r, z, n):  n = tanh(x Wn + bn_i + r * (h Un + bn_h)),
    h' = (1 - z) * n + z * h, all in ``compute_dtype``, as the JAX
    package's cell."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(3 * hidden_size))
        bound = 1.0 / math.sqrt(hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        h = h.to(d)
        gi = linear(x, self.weight_ih, self.bias_ih, d)
        gh = linear(h, self.weight_hh, self.bias_hh, d)
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h
