"""Staged digests of a step's gradients: where two runs of the same step
part, by rank, stage, RSSM step and operand.

A digest is the SHA-1 of a tensor's bytes (16 hex digits); two tensors
with one digest are bit-equal.  Inside ``StagedDigests`` each of the first
``steps`` train steps of this process (``train/trainer.optimizer_step``,
through its ``STAGE_HOOKS``) records:

- ``stages``: every parameter's gradient (a sharded weight's: this rank's
  block) at each stage the step reaches: ``local`` (after this rank's
  backward), ``data_mean`` (after the data group's average) and
  ``broadcast`` (after the model group's broadcast of the replicated
  gradients: what the clip and the optimizer take);
- ``gru``: for every call of a ``GRUCell`` in the step's forward (one per
  RSSM step, in order), the operands of the input-to-hidden product whose
  gradient is ``weight_ih``'s contribution from that call: ``x_forward``
  (the input x as the forward multiplies it), ``x_backward`` (the same
  saved x as the backward reads it), ``d_gi`` (the cotangent of gi = x
  W_ih^T + b), ``product`` (the gradient reaching the call's cast of
  ``weight_ih``: d_gi^T x, in the compute dtype) and
  ``product_recomputed_equal`` (whether d_gi^T x, computed again after the
  backward from the recorded operands, equals ``product`` bit for bit).

The operands are copied on the device as the step runs (no host
synchronisation inside the forward or the backward) and digested at the
``local`` stage, where the backward has ended.  The instrument wraps
``GRUCell.forward`` for the whole process while it is entered; it changes
no value.  ``first_parting`` compares two runs' records.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from multimodal_rssm_torch.models.layers import GRUCell
from multimodal_rssm_torch.train import trainer as tr

STAGES = ("local", "data_mean", "broadcast")
GRU_OPERANDS = ("x_forward", "x_backward", "d_gi", "product")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(_bytes(t).cpu().numpy().tobytes()).hexdigest()[:16]


def _digests(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """One digest a tensor, read back from the device in one copy."""
    if not tensors:
        return {}
    flat = torch.cat([_bytes(t) for t in tensors.values()]).cpu().numpy()
    out, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        out[name] = hashlib.sha1(flat[offset:offset + n].tobytes()
                                 ).hexdigest()[:16]
        offset += n
    return out


class _InputProduct(TorchFunctionMode):
    """Inside a ``GRUCell`` forward: the first ``F.linear`` (gi's) with its
    operands copied as the forward and the backward use them."""

    def __init__(self, calls: List[dict]):
        super().__init__()
        self.calls = calls
        self.done = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.linear or self.done:
            return func(*args, **kwargs)
        self.done = True
        x, w = args[0], args[1]
        if not (torch.is_grad_enabled() and w.requires_grad):
            return func(*args, **kwargs)
        call = {"x_forward": x.detach().clone()}
        if w.grad_fn is None:   # the float32 weight itself: one use a call
            w = w.view_as(w)
        w.register_hook(lambda g: call.__setitem__("product", g.clone()))

        def pack(t):
            return (t is x, t)

        def unpack(saved):
            is_x, t = saved
            if is_x:
                call["x_backward"] = t.detach().clone()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            gi = func(x, w, *args[2:], **kwargs)
        gi.register_hook(lambda g: call.__setitem__("d_gi", g.clone()))
        self.calls.append(call)
        return gi


class StagedDigests:
    """The staged digests of this process's first ``steps`` train steps
    (module docstring); ``records``: one dict a step, {"stages": {stage:
    {parameter: digest}}, "gru": [{operand: digest, ...}, ...]}."""

    def __init__(self, steps: int):
        self.steps = int(steps)
        self.records: List[dict] = []
        self._calls: Optional[List[dict]] = None   # the open step's
        self._open = False
        self._forward = None

    def __enter__(self) -> "StagedDigests":
        self._forward = forward = GRUCell.forward
        owner = self

        def probed(cell, x, h):
            if owner._calls is None:
                return forward(cell, x, h)
            with _InputProduct(owner._calls):
                return forward(cell, x, h)

        GRUCell.forward = probed
        tr.STAGE_HOOKS.append(self._stage)
        return self

    def __exit__(self, *exc) -> None:
        GRUCell.forward = self._forward
        tr.STAGE_HOOKS.remove(self._stage)

    def _stage(self, stage: str, model: torch.nn.Module) -> None:
        if stage == "start":
            self._open = len(self.records) < self.steps
            if self._open:
                self._calls = []
                self.records.append({"stages": {}, "gru": []})
            return
        if not self._open:
            return
        record = self.records[-1]
        record["stages"][stage] = _digests(
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None})
        if stage == "local":
            record["gru"] = [_gru_row(c) for c in self._calls]
            self._calls = None


def _gru_row(call: dict) -> dict:
    row = {k: digest(call[k]) if k in call else None for k in GRU_OPERANDS}
    if all(k in call for k in ("x_backward", "d_gi", "product")):
        again = call["d_gi"].t().mm(call["x_backward"])
        row["product_recomputed_equal"] = torch.equal(again, call["product"])
    else:
        row["product_recomputed_equal"] = None
    return row


def first_parting(a: List[dict], b: List[dict]) -> Optional[dict]:
    """Where two runs' ``StagedDigests.records`` first part: {"step" (from
    1), "stages": {stage: [parameters whose digest differs]}, "gru": [(RSSM
    step, [operands that differ])]}, the first stage that parts and every
    stage and call of that step; or None."""
    for step, (x, y) in enumerate(zip(a, b), start=1):
        stages = {s: [n for n in x["stages"][s]
                      if x["stages"][s][n] != y["stages"].get(s, {}).get(n)]
                  for s in STAGES if s in x["stages"]}
        gru = [(t, [k for k in GRU_OPERANDS if r[k] != q[k]])
               for t, (r, q) in enumerate(zip(x["gru"], y["gru"]))]
        gru = [(t, ks) for t, ks in gru if ks]
        if any(stages.values()) or gru or len(x["gru"]) != len(y["gru"]):
            return {"step": step,
                    "first_stage": next((s for s in STAGES
                                         if stages.get(s)), None),
                    "stages": {s: ns for s, ns in stages.items() if ns},
                    "gru": gru}
    return None
