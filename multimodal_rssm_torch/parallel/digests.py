"""Staged digests of a train step: where two runs of the same step part,
by rank, stage, RSSM step and operand.

A digest is the SHA-1 of a tensor's bytes (16 hex digits); two tensors
with one digest are bit-equal.  Inside ``StagedDigests`` each of the first
``steps`` train steps of this process (``train/trainer``'s
``STAGE_HOOKS``) records, stage by stage in the order ``STAGES``:

- ``inputs``: the weights as the train loop placed them before the first
  step (``weights/{at}/...``: each parameter and buffer, and the
  concatenated parameters in ``WEIGHT_CHUNKS`` equal chunks, ``.../chunk/k``,
  which place a difference inside that buffer: ``at`` "initialised" on
  the host, "loaded" on the device, "broadcast" after the weights'
  broadcast), then the step's inputs as it receives them, before the
  forward:
  every tensor of the raw batch (``raw/...``: observations, actions,
  rewards, nonterminals), the augmentation draws (``draws/...``), the
  state of the step's generator (``generator``), the prepared batch after
  the input pipeline and K1 (``prepared/...``), and every parameter and
  buffer (``param/...``, ``buffer/...``: a sharded weight's is this rank's
  block).  A step that enters at ``optimizer_step`` (a prepared batch)
  records the prepared batch, the parameters and the buffers only;
- ``forward``: each encoder's embedding (``encoder/...``) and, at every
  RSSM step t, the GRU's input, the belief and the posterior's mean, std
  and sample (``rssm/{t}/...``);
- ``kernels`` (the first step only): the names of the
  kernels the step launched on the card, in order (on the CPU, the
  operators the calling thread ran), read from a
  ``core/profiling.ProfilerWindow`` around the step, by position
  (``"00000"``, ...);
- every parameter's gradient (a sharded weight's: this rank's block) at
  each stage the step reaches: ``local`` (after this rank's backward),
  ``data_mean`` (after the data group's average) and ``broadcast`` (after
  the model group's broadcast of the replicated gradients: what the clip
  and the optimizer take);
- ``gru``: for every call of a ``GRUCell`` in the step's forward (one per
  RSSM step, in order), the operands of the input-to-hidden product whose
  gradient is ``weight_ih``'s contribution from that call: ``x_forward``
  (the input x as the forward multiplies it), ``x_backward`` (the same
  saved x as the backward reads it), ``d_gi`` (the cotangent of gi = x
  W_ih^T + b), ``product`` (the gradient reaching the call's cast of
  ``weight_ih``: d_gi^T x, in the compute dtype) and
  ``product_recomputed_equal`` (whether d_gi^T x, computed again after the
  backward from the recorded operands, equals ``product`` bit for bit).

The inputs and the forward's tensors are copied on the device as the step
runs (no host synchronisation inside the forward or the backward) and
digested once the backward has ended.  The instrument wraps
``GRUCell.forward`` and hooks the model's encoder and transition model
while it is entered; it changes no value (the profiler window around the
first step synchronises the device, which moves only time).
``first_parting`` compares two runs' records.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from multimodal_rssm_torch.models.layers import GRUCell
from multimodal_rssm_torch.train import trainer as tr

GRADIENT_STAGES = ("local", "data_mean", "broadcast")
STAGES = ("inputs", "forward", "kernels") + GRADIENT_STAGES
GRU_OPERANDS = ("x_forward", "x_backward", "d_gi", "product")
WEIGHT_CHUNKS = 32   # the parameters' flat bytes, cut for ``weights/``
# the transition model's outputs digested at every RSSM step
RSSM_OUTPUTS = (("belief", "beliefs"), ("posterior_mean", "posterior_means"),
                ("posterior_std", "posterior_std_devs"),
                ("posterior_sample", "posterior_states"))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(_bytes(t).cpu().numpy().tobytes()).hexdigest()[:16]


def _digests(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """One digest a tensor, read back from each device in one copy."""
    out: Dict[str, str] = {}
    by_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    for name, t in tensors.items():
        by_device.setdefault(t.device, {})[name] = t
    for group in by_device.values():
        flat = torch.cat([_bytes(t) for t in group.values()]).cpu().numpy()
        offset = 0
        for name, t in group.items():
            n = t.numel() * t.element_size()
            out[name] = hashlib.sha1(flat[offset:offset + n].tobytes()
                                     ).hexdigest()[:16]
            offset += n
    return {name: out[name] for name in tensors}


def _flatten(prefix: str, tree, out: Dict[str, torch.Tensor]) -> None:
    """The tensors of a nested dict / tuple / list, by path."""
    if torch.is_tensor(tree):
        out[prefix] = tree.detach().clone()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}/{k}", v, out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten(f"{prefix}/{i}", v, out)


BATCH_FIELDS = ("observations", "actions", "rewards", "nonterminals")


def _batch(prefix: str, batch, out: Dict[str, torch.Tensor]) -> None:
    """A batch (observations, actions, rewards, nonterminals), copied."""
    for field, tree in zip(BATCH_FIELDS, batch):
        _flatten(f"{prefix}/{field}", tree, out)


def _host_digest(value) -> str:
    return hashlib.sha1(np.ascontiguousarray(value).tobytes()
                        ).hexdigest()[:16]


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


class _Step:
    """The open step's copies, hooks and profiler window."""

    def __init__(self, model: torch.nn.Module, kernels: bool):
        self.calls: List[dict] = []
        self.inputs: Dict[str, torch.Tensor] = {}
        self.host: Dict[str, str] = {}
        self.forward: Dict[str, torch.Tensor] = {}
        self.handles = []
        for name in ("encoder", "transition_model"):
            module = getattr(model, name, None)
            if module is not None:
                self.handles.append(module.register_forward_hook(
                    self._hook(name)))
        self.window = None
        if kernels:
            from multimodal_rssm_torch.core.profiling import ProfilerWindow

            device = next(model.parameters()).device
            self.window = ProfilerWindow(
                device, cpu=device.type != "cuda").open()

    def _hook(self, name: str):
        def hook(module, args, output):
            if any(k.startswith(name + "/") for k in self.forward):
                return   # a recomputation (remat): the first call counts
            if name == "encoder":
                _flatten("encoder", output, self.forward)
                return
            for key, field in RSSM_OUTPUTS:
                if field in output:
                    self.forward[f"{name}/{key}"] = (
                        output[field].detach().clone())
        return hook

    def close(self) -> List[str]:
        for handle in self.handles:
            handle.remove()
        if self.window is None:
            return []
        return self.window.close().ordered_kernels()


class StagedDigests:
    """The staged digests of this process's first ``steps`` train steps
    (module docstring); ``records``: one dict a step, {"stages": {stage:
    {name: digest, or for ``kernels`` position: kernel name}}, "gru":
    [{operand: digest, ...}, ...]}."""

    def __init__(self, steps: int):
        self.steps = int(steps)
        self.records: List[dict] = []
        self._step: Optional[_Step] = None
        self._forward = None
        self._weights: Dict[str, str] = {}   # until the first step opens

    def __enter__(self) -> "StagedDigests":
        self._forward = forward = GRUCell.forward
        owner = self

        def probed(cell, x, h):
            if owner._step is None:
                return forward(cell, x, h)
            with _InputProduct(owner._step.calls):
                return forward(cell, x, h)

        GRUCell.forward = probed
        tr.STAGE_HOOKS.append(self._stage)
        return self

    def __exit__(self, *exc) -> None:
        GRUCell.forward = self._forward
        tr.STAGE_HOOKS.remove(self._stage)
        if self._step is not None:
            self._step.close()
            self._step = None

    def _open(self, model: torch.nn.Module) -> Optional[_Step]:
        """The open step, opening one (and its record) if none is and the
        first ``steps`` are not all recorded."""
        if self._step is None and len(self.records) < self.steps:
            self.records.append({"stages": {}, "gru": []})
            self._step = _Step(model, len(self.records) == 1)
            self._step.host.update(self._weights)
            self._weights = {}
        return self._step

    def _stage(self, stage: str, model: torch.nn.Module, **data) -> None:
        if stage == "weights":
            if not self.records:
                self._weights.update(weight_digests(model, data["at"]))
            return
        if stage == "inputs":
            step = self._open(model)
            if step is not None:
                _inputs(step, data)
            return
        if stage == "start":
            step = self._open(model)
            if step is not None:
                _batch("prepared", data["batch"], step.inputs)
                for n, p in model.named_parameters():
                    step.inputs[f"param/{n}"] = p.detach().clone()
                for n, b in model.named_buffers():
                    step.inputs[f"buffer/{n}"] = b.detach().clone()
            return
        step = self._step
        if step is None:
            return
        record = self.records[-1]
        if stage == "end":
            kernels = step.close()
            if len(self.records) == 1:
                record["stages"]["kernels"] = {
                    f"{i:05d}": name for i, name in enumerate(kernels)}
            self._step = None
            record["stages"] = {s: record["stages"][s] for s in STAGES
                                if s in record["stages"]}
            return
        if stage == "local":
            record["stages"]["inputs"] = {**step.host,
                                          **_digests(step.inputs)}
            record["stages"]["forward"] = _digests(_forward_tensors(step))
            record["gru"] = [_gru_row(c) for c in step.calls]
            step.inputs, step.forward = {}, {}
        record["stages"][stage] = _digests(
            {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None})


def weight_digests(model: torch.nn.Module, at: str) -> Dict[str, str]:
    """``weights/{at}/...``: each parameter and buffer, and the float32
    parameters' concatenated bytes in ``WEIGHT_CHUNKS`` chunks (one read
    back of the parameters)."""
    params = [p for p in model.parameters() if p.dtype == torch.float32]
    flat = torch.cat([_bytes(p) for p in params]).cpu().numpy()
    out, offset = {}, 0
    by_id = {}
    for p in params:
        n = p.numel() * p.element_size()
        by_id[id(p)] = _host_digest(flat[offset:offset + n])
        offset += n
    for n, p in model.named_parameters():
        out[f"weights/{at}/{n}"] = by_id.get(id(p)) or digest(p)
    out.update(_digests({f"weights/{at}/{n}": b
                         for n, b in model.named_buffers()}))
    for k, part in enumerate(np.array_split(flat, WEIGHT_CHUNKS)):
        out[f"weights/{at}/chunk/{k:02d}"] = _host_digest(part)
    return out


def _inputs(step: _Step, data: dict) -> None:
    """``inputs``' raw batch (copied), draws and generator state (digested
    on the host)."""
    _batch("raw", data["raw"], step.inputs)
    for name, entry in sorted(data["draws"].items()):
        for key, value in sorted(entry.items()):
            step.host[f"draws/{name}/{key}"] = _host_digest(value)
    generator = data.get("generator")
    if generator is not None:
        step.host["generator"] = _host_digest(
            generator.get_state().numpy())


def _forward_tensors(step: _Step) -> Dict[str, torch.Tensor]:
    """The forward's copies by name: the encoders' embeddings, then each
    RSSM step's GRU input, belief and posterior."""
    out = {k: v for k, v in step.forward.items() if k.startswith("encoder")}
    rssm = {key: step.forward.get(f"transition_model/{key}")
            for key, _ in RSSM_OUTPUTS}
    steps = max([len(step.calls)] + [len(v) for v in rssm.values()
                                    if v is not None])
    for t in range(steps):
        if t < len(step.calls):
            out[f"rssm/{t:03d}/gru_input"] = step.calls[t]["x_forward"]
        for key, v in rssm.items():
            if v is not None and t < len(v):
                out[f"rssm/{t:03d}/{key}"] = v[t]
    return out


def _gru_row(call: dict) -> dict:
    row = {k: digest(call[k]) if k in call else None for k in GRU_OPERANDS}
    if all(k in call for k in ("x_backward", "d_gi", "product")):
        again = call["d_gi"].t().mm(call["x_backward"])
        row["product_recomputed_equal"] = torch.equal(again, call["product"])
    else:
        row["product_recomputed_equal"] = None
    return row


def _differ(x: dict, y: dict) -> List[str]:
    """The names whose entries differ (or that one side lacks), in ``x``'s
    order, then ``y``'s."""
    return ([n for n in x if x[n] != y.get(n)]
            + [n for n in y if n not in x])


def first_parting(a: List[dict], b: List[dict]) -> Optional[dict]:
    """Where two runs' ``StagedDigests.records`` first part: {"step" (from
    1), "first_stage" (in ``STAGES``' order), "first" (that stage's first
    name that differs; for ``kernels`` {"index", "a", "b"}: the first
    position whose kernel differs and each run's kernel there), "stages":
    {stage: [names that differ]} (``kernels``: [that first position]),
    "gru": [(RSSM step, [operands that differ])]}, the first step that
    parts, with every stage and call of that step; or None."""
    for step, (x, y) in enumerate(zip(a, b), start=1):
        stages = {}
        for s in STAGES:
            xs, ys = x["stages"].get(s, {}), y["stages"].get(s, {})
            names = _differ(xs, ys)
            if names and s == "kernels":
                i = min(int(n) for n in names)
                names = [{"index": i, "a": xs.get(f"{i:05d}"),
                          "b": ys.get(f"{i:05d}")}]
            if names:
                stages[s] = names
        gru = [(t, [k for k in GRU_OPERANDS if r[k] != q[k]])
               for t, (r, q) in enumerate(zip(x["gru"], y["gru"]))]
        gru = [(t, ks) for t, ks in gru if ks]
        if stages or gru or len(x["gru"]) != len(y["gru"]):
            first = next((s for s in STAGES if s in stages), None)
            return {"step": step, "first_stage": first,
                    "first": None if first is None else stages[first][0],
                    "stages": stages, "gru": gru}
    return None
