"""The dtype map of a world model's forward: what each layer computes in.

The JAX package fixes each layer's dtype by its ``dtype=`` field
(``WorldModel.from_config(cfg, dtype)``); the port by each layer's
``compute_dtype`` (``models/layers.py``).  This module reads the port's
side of that contract while a forward runs:

    with recording(model) as seen:
        loss, metrics = loss_fn(batch, None, True)      # any forward
    seen.layers    # {module name: ["bfloat16"], ...}
    seen.outputs   # {"states.beliefs": "float32", ...}

(``loss_step_map`` records one train-mode loss step and its backward.)

``layers`` holds, for every module that owns parameters and ran, the
dtypes of its outputs (a layer used by blocks of its weight, through
``parallel/tensor.column_linear``, reports each block's output: the
recording wraps that function where it is called);
``outputs`` the dtype of every leaf of ``train_forward``'s
(states, per-element reconstruction terms, reward) when the forward went
through it.  ``mismatches`` holds two maps against each other, name for
name.  The JAX package's maps, keyed by the port's module names through
the weight bridge, are committed in
``tests/torch_port_fixtures/dtype_map.json``; ``chip_smoke.py`` and the
tests hold the port's to them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Mapping, Optional

import torch
from torch import nn

from multimodal_rssm_torch.models import heads
from multimodal_rssm_torch.parallel import tensor
from multimodal_rssm_torch.rssm import core

# the forward's three outputs, as the JAX package's ``train_forward``
OUTPUT_GROUPS = ("states", "per_elem", "reward")
# the modules that call ``column_linear`` (a layer used by blocks of its
# weight, whose own forward never runs): ``recording`` wraps it there
_COLUMN_LINEAR_USERS = (core, heads)


def dtype_name(x: Any) -> str:
    """``"bfloat16"`` / ``"float32"`` ... for a tensor, else its type's
    name (a decoder's constant ``scale`` is a Python float)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return type(x).__name__


def flatten_dtypes(tree: Any, prefix: str = "") -> Dict[str, str]:
    """{dotted path: dtype name} of the leaves of nested dicts / tuples."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: dtype_name(tree)}
    out: Dict[str, str] = {}
    for k, v in items:
        out.update(flatten_dtypes(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


class DtypeMap:
    """What ``recording`` saw: ``layers`` and ``outputs``."""

    def __init__(self):
        self._layers: Dict[str, set] = {}
        self.outputs: Dict[str, str] = {}

    @property
    def layers(self) -> Dict[str, List[str]]:
        return {k: sorted(v) for k, v in sorted(self._layers.items())}

    def add(self, name: str, y: Any) -> None:
        self._layers.setdefault(name, set()).add(dtype_name(y))


@contextlib.contextmanager
def recording(model: nn.Module) -> Iterator[DtypeMap]:
    """Record the dtype map of the forwards run inside the block."""
    seen = DtypeMap()
    names = {m: n for n, m in model.named_modules()
             if next(m.parameters(recurse=False), None) is not None}
    hooks = [m.register_forward_hook(
        lambda m, args, y: seen.add(names[m], y)) for m in names]

    def column_linear(x, weight, bias, layer):
        y = tensor.column_linear(x, weight, bias, layer)
        if layer in names:
            seen.add(names[layer], y)
        return y

    for user in _COLUMN_LINEAR_USERS:
        user.column_linear = column_linear
    train_forward = getattr(model, "train_forward", None)
    if train_forward is not None:
        def traced(*args, **kwargs):
            out = train_forward(*args, **kwargs)
            seen.outputs = flatten_dtypes(dict(zip(OUTPUT_GROUPS, out)))
            return out
        model.train_forward = traced
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()
        for user in _COLUMN_LINEAR_USERS:
            user.column_linear = tensor.column_linear
        if train_forward is not None:
            del model.train_forward


def loss_step_map(model: nn.Module, cfg, batch,
                  generator: Optional[torch.Generator] = None):
    """One train-mode loss step of ``model`` on a prepared ``batch``
    (``trainer.make_loss_fn``, then its backward), recorded: (the map in
    ``as_dict`` form, the sorted dtypes of the gradients, the loss)."""
    from multimodal_rssm_torch.train import trainer as tr

    with recording(model) as seen:
        loss, _ = tr.make_loss_fn(model, cfg)(batch, generator, True)
    loss.backward()
    grads = sorted({dtype_name(p.grad) for p in model.parameters()
                    if p.grad is not None})
    return as_dict(seen), grads, float(loss.detach())


def as_dict(seen: DtypeMap) -> Dict[str, Dict]:
    """The map as the fixture stores it: {"layers": ..., "outputs": ...}."""
    return {"layers": seen.layers,
            "outputs": dict(sorted(seen.outputs.items()))}


def mismatches(got: Mapping[str, Dict], want: Mapping[str, Dict]
               ) -> List[str]:
    """Every difference between two ``as_dict`` maps, name for name: an
    entry on one side only, or other dtypes."""
    out = []
    for part in ("layers", "outputs"):
        g, w = got[part], want[part]
        for name in sorted(set(g) | set(w)):
            if g.get(name) != w.get(name):
                out.append(f"{part} {name}: port {g.get(name)}, "
                           f"want {w.get(name)}")
    return out
