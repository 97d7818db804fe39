"""The model axis: column-sharded weights over a mesh's model groups.

Port of the JAX package's ``param_spec`` / ``shard_params`` /
``shard_state`` (``parallel/mesh.py``).  The rule is the JAX package's:
a layer's weight is column-sharded (split along its output features) over
the ``model`` axis when that count divides ``model`` and leaves each shard
at least ``train.mesh.min_shard_width`` wide; everything else -- biases,
norms, the GRU cell, the running statistics -- is replicated.  The weights
the rule takes are those of ``nn.Linear``, ``nn.Conv1d`` and ``nn.Conv2d``
(output features on dim 0) and ``nn.ConvTranspose2d`` (dim 1): flax's
``kernel`` leaves.  Where the port joins two of the JAX package's Dense
layers along their inputs (``fc_embed_state_action``, an expert's ``fc1``)
both have the joined layer's output features, so the joined weight shards
exactly when they do.

``shard_model_`` keeps each sharded weight's block of output features as
the parameter (and cuts the optimizer's moments of it the same way, so
Adam steps on the shards) and turns its layer into a column-parallel one
(Megatron-style): the input enters through ``copy_to_model_group``
(identity forward; backward, the input gradients' partial sums added over
the model group), the layer computes its block of output features, and
``gather_columns`` puts the blocks together (forward: each rank writes its
block into a zeroed full-width buffer, then one ``all_reduce`` over the
group; backward: the rank's own columns of the gradient -- every rank of a
group runs the same downstream graph on the same rows, so nothing needs
reducing).  The replicated bias is added after the gather, so norms, GLU,
the Gaussian split and the decoders' reshapes see whole tensors and every
rank holds the whole gradient of every replicated parameter (the step
takes the group's first rank's, ``broadcast_replicated_grads_``, so that
the replicated weights stay bit-equal across the group).
``column_linear`` is the same for the RSSM's blocks of a layer's weight
(``rssm/core.py``, ``models/heads.py``).

The collectives are ``all_reduce`` and ``broadcast`` only, as the data
axis's, so the same code runs on NCCL between cards and on gloo between
ranks that share one.  A gathered sum is exact: each element has one
non-zero term, so a bf16 buffer goes through either backend as it is
(gloo sums bf16 CUDA tensors too).  They run inside a ``torch.profiler`` span named ``SPAN``.

``full_named`` / ``full_state_dict`` / ``full_optimizer_state_dict`` give
whole tensors back (every rank of a group calls them, in the same order):
checkpoints and histograms hold whole tensors, so a file written under a
model axis is the one a mesh-less run writes.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from multimodal_rssm_torch.models.layers import (
    Conv1d, Conv2d, ConvTranspose2d, Linear, linear)
from multimodal_rssm_torch.parallel.mesh import ModelGroup, broadcast_

MIN_SHARD_WIDTH = 128   # the JAX package's default (one lane tile)
SPAN = "model_parallel"   # the profiler span around the model axis's work


# -- the rule -----------------------------------------------------------------


def output_dim(module: nn.Module) -> Optional[int]:
    """The dim of ``module.weight`` that holds its output features, for the
    layers the rule considers (ungrouped convolutions), else None."""
    if isinstance(module, nn.Linear):
        return 0
    if isinstance(module, (nn.Conv1d, nn.Conv2d)) and module.groups == 1:
        return 0
    if isinstance(module, nn.ConvTranspose2d) and module.groups == 1:
        return 1
    return None


def param_spec(model: nn.Module, n_model: int,
               min_width: int = MIN_SHARD_WIDTH) -> Dict[str, int]:
    """``{parameter name: dim}`` of the weights ``model`` column-shards
    over a model axis of ``n_model`` (module docstring); empty for
    ``n_model`` 1.  Takes a whole (unsharded) model, on any device (the
    ``meta`` device too)."""
    spec: Dict[str, int] = {}
    if n_model <= 1:
        return spec
    for name, module in model.named_modules():
        dim = output_dim(module)
        if dim is None:
            continue
        width = module.weight.shape[dim]
        if width % n_model == 0 and width // n_model >= min_width:
            spec[f"{name}.weight" if name else "weight"] = dim
    return spec


# -- the collectives ---------------------------------------------------------


def _gather(block: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    """The blocks of every rank of ``mg`` along ``dim``, put together: a
    zeroed full-width buffer with this rank's block written in, summed
    over the group."""
    n = block.shape[dim]
    shape = list(block.shape)
    shape[dim] = n * mg.size
    full = block.new_zeros(shape)
    full.narrow(dim, mg.rank * n, n).copy_(block)
    dist.all_reduce(full, group=mg.group)
    return full


class _CopyToModelGroup(torch.autograd.Function):
    """Identity forward; backward, the input gradient's partial sums (one
    per rank's columns) added over the model group."""

    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        with record_function(SPAN):
            grad = grad.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(grad, group=ctx.mg.group)
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """Every rank's block of output features put together along ``dim``;
    backward, this rank's block of the (whole, replicated) gradient."""

    @staticmethod
    def forward(ctx, block, dim, mg):
        ctx.dim, ctx.mg, ctx.n = dim, mg, block.shape[dim]
        with record_function(SPAN):
            return _gather(block, dim, mg)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.mg.rank * ctx.n, ctx.n), None,
                None)


def copy_to_model_group(x: torch.Tensor, mg: ModelGroup) -> torch.Tensor:
    """``x`` entering a column-parallel layer (module docstring)."""
    return _CopyToModelGroup.apply(x, mg)


def gather_columns(block: torch.Tensor, dim: int, mg: ModelGroup
                   ) -> torch.Tensor:
    """Differentiable gather of the blocks of a column-parallel layer's
    output along ``dim`` (module docstring)."""
    return _GatherColumns.apply(block, dim % block.ndim, mg)


# -- column-parallel layers ---------------------------------------------------


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor], dim: int
              ) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.ndim
    shape[dim] = -1
    return y + bias.reshape(shape)


class _Column:
    """A layer whose weight holds this rank's block of output features
    (``model_group``'s ``rank`` of ``size``); its output is whole, in the
    layer's ``compute_dtype``."""

    model_group: ModelGroup
    feature_dim = 1   # of the output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        y = self._block(copy_to_model_group(x.to(d), self.model_group),
                        self.weight.to(d))
        y = gather_columns(y, self.feature_dim, self.model_group)
        return _add_bias(y, None if self.bias is None else self.bias.to(d),
                         self.feature_dim % y.ndim)


class ColumnLinear(_Column, Linear):
    feature_dim = -1

    def _block(self, x, w):
        return F.linear(x, w)


class ColumnConv1d(_Column, Conv1d):
    def _block(self, x, w):
        return self._conv_forward(x, w, None)


class ColumnConv2d(_Column, Conv2d):
    def _block(self, x, w):
        return self._conv_forward(x, w, None)


class ColumnConvTranspose2d(_Column, ConvTranspose2d):
    def _block(self, x, w):
        return F.conv_transpose2d(x, w, None, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


_COLUMN = {Linear: ColumnLinear, Conv1d: ColumnConv1d, Conv2d: ColumnConv2d,
           ConvTranspose2d: ColumnConvTranspose2d}


def column_linear(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor], layer: nn.Module
                  ) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` in ``layer``'s compute dtype, for
    ``weight`` a block of input columns of ``layer``'s weight: whole output
    features when ``layer`` is column-parallel (its rows are this rank's),
    as they are otherwise."""
    d = layer.compute_dtype
    mg = getattr(layer, "model_group", None)
    if mg is None:
        return linear(x, weight, bias, d)
    y = gather_columns(F.linear(copy_to_model_group(x.to(d), mg),
                                weight.to(d)), -1, mg)
    return y if bias is None else y + bias.to(d)


# -- placement ---------------------------------------------------------------


def _block(t: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    n = t.shape[dim] // mg.size
    return t.narrow(dim, mg.rank * n, n).clone()


@torch.no_grad()
def shard_model_(model: nn.Module, mg: ModelGroup,
                 min_width: int = MIN_SHARD_WIDTH,
                 optimizer: Optional[torch.optim.Optimizer] = None
                 ) -> Dict[str, int]:
    """Column-shard ``model`` in place over ``mg`` by ``param_spec``: each
    sharded weight keeps this rank's block (the same ``nn.Parameter``, so
    an optimizer built over the model still steps it), its moments in
    ``optimizer``'s state are cut the same way, and its layer becomes
    column-parallel.  Call it on the whole model after init, restore or
    load and the weights' broadcast (every rank holds the same weights).
    Returns the spec."""
    spec = param_spec(model, mg.size, min_width)
    modules = dict(model.named_modules())
    for name, dim in spec.items():
        layer = modules[name[:-len(".weight")]]
        weight = layer.weight
        if optimizer is not None:
            state = optimizer.state.get(weight, {})
            for key, value in state.items():
                if torch.is_tensor(value) and value.shape == weight.shape:
                    state[key] = _block(value, dim, mg)
        weight.data = _block(weight, dim, mg)
        layer.__class__ = _COLUMN[type(layer)]
        layer.model_group = mg
    return spec


def sharded(model: nn.Module) -> Dict[str, Tuple[nn.Parameter, int,
                                                  ModelGroup]]:
    """``{parameter name: (parameter, dim, model group)}`` of ``model``'s
    column-sharded weights (empty for a whole model)."""
    out = {}
    for name, layer in model.named_modules():
        if isinstance(layer, _Column):
            out[f"{name}.weight" if name else "weight"] = (
                layer.weight, output_dim(layer), layer.model_group)
    return out


def broadcast_replicated_grads_(model: nn.Module, mg: ModelGroup) -> None:
    """Every replicated parameter's gradient from the first rank of ``mg``
    (one broadcast per dtype).  The ranks of a model group compute these
    gradients from the same rows and weights; where a backward kernel is
    not deterministic (atomics in a cuDNN weight gradient) they could still
    differ in the last bits, and the replicated weights would drift apart
    step by step.  Identical gradients pass unchanged."""
    blocks = {id(p) for p, _, _ in sharded(model).values()}
    grads = [p.grad for p in model.parameters()
             if id(p) not in blocks and p.grad is not None]
    with record_function(SPAN):
        broadcast_(grads, mg.group, dist.get_global_rank(mg.group, 0))


@torch.no_grad()
def _gather_whole(block: torch.Tensor, dim: int, mg: ModelGroup
                  ) -> torch.Tensor:
    """The whole tensor of which ``block`` is this rank's block along
    ``dim`` (every rank of ``mg`` calls it)."""
    with record_function(SPAN):
        return _gather(block.detach(), dim, mg)


def full_named(tensors: Mapping[str, torch.Tensor], model: nn.Module
               ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name: the parameters, or their gradients)
    with each of ``model``'s sharded weights gathered whole."""
    shards = sharded(model)
    return {name: (_gather_whole(t, shards[name][1], shards[name][2])
                   if name in shards else t)
            for name, t in tensors.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded weight whole: what the
    same model without a model axis holds."""
    return full_named(model.state_dict(), model)


def full_optimizer_state_dict(model: nn.Module,
                              optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` with the moments of every sharded weight
    whole (the tensors of a parameter's state shaped as its block)."""
    blocks = {id(p): (dim, mg) for p, dim, mg in sharded(model).values()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    out = optimizer.state_dict()
    for index, state in out["state"].items():
        p = params[index]
        if id(p) not in blocks:
            continue
        dim, mg = blocks[id(p)]
        out["state"][index] = {
            k: (_gather_whole(v, dim, mg)
                if torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in state.items()}
    return out
