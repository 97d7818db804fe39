"""Checkpoints of a training run: atomic, asynchronous on the cadence, pruned.

A checkpoint ``models_{step}.pt`` (``torch.save``) holds the whole training
state: ``step``, the model's ``state_dict`` (its norms' running stats
included), the optimizer's and the LR scheduler's ``state_dict``s, and
``extra`` (the loop's torch generator and its NumPy generators' states).  It is written to a ``.tmp`` file
and renamed, so a run killed mid-write never leaves a truncated
checkpoint.  ``latest_checkpoint`` / ``restore_or_none`` find the newest
for ``--resume``; ``load_checkpoint`` restores strictly.

A behavior checkpoint ``behavior/models_{itr}.pt``
(``save_behavior_checkpoint`` / ``load_behavior_checkpoint``) holds a
``train/behavior.BehaviorState``: the actor's and the value head's
``state_dict``s, both optimizers', the behavior step and
``return_scale``; it is written the same atomic way.

``load_reference_checkpoint`` reads a reference ``models_{itr}.pth`` (the
nested ``model_dicts`` layout) into the port's model.
``find_model_checkpoint`` / ``load_model_weights`` give evaluation a run
dir's ``models_{itr}`` weights, from a ``.pt``, a ``.pth`` or a JAX package
``.msgpack``.

A JAX package checkpoint ``models_{step}.msgpack`` (flax's msgpack of
``{"step", "state": TrainState, "extra"}``) is read by ``io/flax_msgpack``.
Its ``params`` / ``batch_stats`` become the model's ``state_dict`` through
``io/jax_weights.state_dict_from_jax``; ``load_jax_train_state`` also
carries optax's Adam state into torch's (``mu`` / ``nu`` through the same
layout transform as the parameters, ``count`` as the step, and the warm-up
schedule's count).  A behavior checkpoint ``behavior/models_{itr}.msgpack``
(the JAX ``BehaviorState``) goes through ``policy_state_dict_from_jax``.  A
field the file lacks (one written before the field existed, as
``return_scale``) starts from the fresh state's value, with a warning, as
the JAX package's ``_fill_missing_fields`` does.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_rssm_torch.io import flax_msgpack
from multimodal_rssm_torch.io.jax_weights import (
    policy_state_dict_from_jax, state_dict_from_jax)

_NAME = re.compile(r"models_(\d+)\.(pt|msgpack)")


def _map_tensors(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``tree`` with every tensor replaced by ``fn(tensor)`` and every
    container rebuilt (so later in-place changes of the source's lists do
    not reach the copy)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _payload(step: int, model, optimizer, scheduler, extra) -> Dict[str, Any]:
    return {"step": int(step), "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": None if scheduler is None else scheduler.state_dict(),
            "extra": dict(extra or {})}


def _write(results_dir: str, step: int, payload: Dict[str, Any]) -> str:
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, f"models_{step}.pt")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)   # atomic on POSIX
    return path


def save_checkpoint(results_dir: str, step: int, model, optimizer,
                    scheduler=None, extra: Optional[Dict[str, Any]] = None
                    ) -> str:
    """Write ``models_{step}.pt`` atomically, tensors on the CPU; returns
    its path.  Blocks until the device's tensors are copied and the file
    is written."""
    payload = _map_tensors(_payload(step, model, optimizer, scheduler, extra),
                           lambda t: t.detach().cpu())
    return _write(results_dir, step, payload)


class AsyncCheckpointer:
    """Checkpoint writes off the loop's thread.

    ``save`` takes the snapshot before it returns, because the optimizer
    updates the parameters and its moments in place at the next step: CUDA
    tensors are cloned on the current stream (stream order puts the clone
    before the next step's writes; 0.78 GB at full width, at device-memory
    rate), then copied from the clones into pinned host memory on a side
    stream that the step does not wait for, behind an event; CPU tensors
    are cloned.
    A writer thread waits for the event, then does only host work:
    ``torch.save``, the rename and the pruning.  At most one write is in
    flight: ``save`` first waits for the previous one.  ``wait()`` joins the
    writer and raises its error.  The file is the one ``save_checkpoint``
    writes.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._last_path: Optional[str] = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _snapshot(self, payload) -> Tuple[Dict[str, Any], List]:
        """(the payload with every tensor a host copy, the events that
        mark the copies done).  All clones are queued before the side
        stream waits on the current one, so every copy reads a finished
        clone; ``record_stream`` keeps a clone's memory from reuse until
        the side stream has read it."""
        clones = _map_tensors(payload, lambda t: t.detach().clone())
        events = {}

        def to_host(t: torch.Tensor) -> torch.Tensor:
            if not t.is_cuda:
                return t
            if t.device not in events:
                if t.device not in self._streams:
                    self._streams[t.device] = torch.cuda.Stream(t.device)
                self._streams[t.device].wait_stream(
                    torch.cuda.current_stream(t.device))
                events[t.device] = torch.cuda.Event()
            side = self._streams[t.device]
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                host.copy_(t, non_blocking=True)
            t.record_stream(side)
            return host

        snapshot = _map_tensors(clones, to_host)
        for device, event in events.items():
            event.record(self._streams[device])
        return snapshot, list(events.values())

    def save(self, results_dir: str, step: int, model, optimizer,
             scheduler=None, extra: Optional[Dict[str, Any]] = None,
             keep: int = 0) -> None:
        self.wait()
        snapshot, events = self._snapshot(
            _payload(step, model, optimizer, scheduler, extra))

        def write():
            try:
                for event in events:
                    event.synchronize()
                self._last_path = _write(results_dir, step, snapshot)
                prune_checkpoints(results_dir, keep)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def wait(self) -> Optional[str]:
        """Join the write in flight, if any, and raise its error; returns
        the path of the last completed write."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._last_path


def save_behavior_checkpoint(results_dir: str, itr: int, bstate) -> str:
    """Write a ``BehaviorState`` as ``{results_dir}/models_{itr}.pt``
    atomically, tensors on the CPU; returns its path."""
    payload = {"step": int(itr), "behavior_step": int(bstate.step),
               "actor": bstate.actor.state_dict(),
               "value": bstate.value.state_dict(),
               "actor_optimizer": bstate.actor_opt.state_dict(),
               "value_optimizer": bstate.value_opt.state_dict(),
               "return_scale": bstate.return_scale}
    return _write(results_dir, itr, _map_tensors(
        payload, lambda t: t.detach().cpu()))


def load_behavior_checkpoint(path: str, bstate) -> int:
    """Restore a behavior checkpoint into ``bstate`` in place (the heads
    strictly, both optimizers, the step and ``return_scale`` on the actor's
    device); returns the checkpoint's ``itr``.  A JAX package ``.msgpack``
    goes through ``load_jax_behavior_checkpoint``."""
    if path.endswith(".msgpack"):
        return load_jax_behavior_checkpoint(path, bstate)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    bstate.actor.load_state_dict(payload["actor"], strict=True)
    bstate.value.load_state_dict(payload["value"], strict=True)
    bstate.actor_opt.load_state_dict(payload["actor_optimizer"])
    bstate.value_opt.load_state_dict(payload["value_optimizer"])
    bstate.step = int(payload["behavior_step"])
    device = next(bstate.actor.parameters()).device
    bstate.return_scale = payload["return_scale"].to(device)
    return int(payload["step"])


def _checkpoints(results_dir: str, suffixes: Tuple[str, ...] = (".pt",)
                 ) -> List[Tuple[int, str]]:
    """[(step, path)] of the ``models_{step}{suffix}`` files, by step (at
    one step, a suffix before the later ones of ``suffixes``)."""
    if not os.path.isdir(results_dir):
        return []
    found = []
    for name in os.listdir(results_dir):
        m = _NAME.fullmatch(name)
        if m and "." + m.group(2) in suffixes:
            found.append((int(m.group(1)), -suffixes.index("." + m.group(2)),
                          os.path.join(results_dir, name)))
    return [(step, path) for step, _, path in sorted(found)]


def prune_checkpoints(results_dir: str, keep: int) -> List[str]:
    """Delete all but the ``keep`` highest-step checkpoints (0 keeps
    every one); returns the deleted paths."""
    if keep <= 0:
        return []
    doomed = [p for _, p in _checkpoints(results_dir)[:-keep]]
    for p in doomed:
        os.remove(p)
    return doomed


def latest_checkpoint(results_dir: str,
                      suffixes: Tuple[str, ...] = (".pt", ".msgpack")
                      ) -> Optional[str]:
    """The highest-step checkpoint of a run dir, or None: a port ``.pt`` or
    a JAX package ``.msgpack`` (a ``.pt`` where both are at that step)."""
    found = _checkpoints(results_dir, suffixes)
    return found[-1][1] if found else None


def load_checkpoint(path: str, model, optimizer=None, scheduler=None
                    ) -> Tuple[int, Dict[str, Any]]:
    """Restore a checkpoint into ``model`` (strictly), and into
    ``optimizer`` and ``scheduler`` where given.  Returns (step, extra)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if (scheduler is None) != (payload["scheduler"] is None):
        raise ValueError(f"{path}: an LR schedule state in the checkpoint "
                         f"({payload['scheduler'] is not None}) and in this "
                         f"run ({scheduler is not None}) must go together")
    if scheduler is not None:
        scheduler.load_state_dict(payload["scheduler"])
    return int(payload["step"]), dict(payload["extra"])


def restore_or_none(results_dir: str, model, optimizer=None, scheduler=None
                    ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """(step, extra) restored from the run dir's latest checkpoint, or None
    when it holds none."""
    path = latest_checkpoint(results_dir, (".pt",))
    if path is None:
        return None
    return load_checkpoint(path, model, optimizer, scheduler)


def _flatten_reference(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        key = prefix if k == "main" else (f"{prefix}.{k}" if prefix else k)
        if isinstance(v, dict):
            out.update(_flatten_reference(v, key))
        else:
            out[key] = v
    return out


def load_reference_checkpoint(path: str, model) -> None:
    """Load a reference ``models_{itr}.pth`` into ``model`` (strictly).

    A multimodal file nests ``model_dicts`` by module (``transition_model:
    {main, obs_encoder: {...}}``, ``observation_model``, ``reward_model``,
    ``encoder``); ``transition_model.main.*`` flattens into
    ``transition_model.*``, the port's names, and its ``model_optimizer``
    (a fresh Adam state the reference discards on load) is dropped.  A
    unimodal file is the reference ``RSSM``'s flat ``state_dict()``, whose
    keys are the port's unimodal names already."""
    model_dicts = torch.load(path, map_location="cpu", weights_only=True)
    if "transition_model" in model_dicts:
        model_dicts = _flatten_reference(
            {k: v for k, v in model_dicts.items() if k != "model_optimizer"})
    model.load_state_dict(model_dicts, strict=True)


# the weight files a run dir may hold, in the order evaluation takes them
MODEL_SUFFIXES = (".pt", ".pth", ".msgpack")


def load_model_weights(path: str, model) -> None:
    """The model's weights (running stats included) for evaluation,
    strictly: from a port checkpoint ``.pt`` (its ``model`` entry), a
    reference ``.pth`` or a JAX package ``.msgpack`` (its ``params`` and
    ``batch_stats``)."""
    if path.endswith(".pt"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
    elif path.endswith(".pth"):
        load_reference_checkpoint(path, model)
    elif path.endswith(".msgpack"):
        state = read_jax_checkpoint(path, _TRAIN_STATE)[1]
        model.load_state_dict(state_dict_from_jax(
            state["params"], state["batch_stats"] or None), strict=True)
    else:
        raise ValueError(f"{path}: not a .pth, .pt or .msgpack file")


# -- the JAX package's checkpoints ---------------------------------------------

# the JAX TrainState's and BehaviorState's fields, with the values a fresh
# state starts from where a file lacks one (None: a required field)
_TRAIN_STATE = {"step": 0, "params": None, "batch_stats": {},
                "opt_state": None}
_BEHAVIOR_STATE = {"step": 0, "actor_params": None, "value_params": None,
                   "actor_opt_state": None, "value_opt_state": None,
                   "return_scale": np.ones((), np.float32)}


def fill_missing_fields(template, payload, path: str = "", filled=None):
    """The JAX package's ``_fill_missing_fields``: ``payload`` with every
    dict key of ``template`` it lacks taken from ``template`` (recursively;
    keys only in ``payload`` are kept).  Returns (merged, the filled key
    paths)."""
    if filled is None:
        filled = []
    if not isinstance(template, dict) or not isinstance(payload, dict):
        return payload, filled
    merged = {}
    for k, tv in template.items():
        if k in payload:
            merged[k], _ = fill_missing_fields(tv, payload[k], f"{path}/{k}",
                                               filled)
        else:
            merged[k] = tv
            filled.append(f"{path}/{k}")
    for k, v in payload.items():
        if k not in merged:
            merged[k] = v
    return merged, filled


def read_jax_checkpoint(path: str, template: Mapping[str, Any]
                        ) -> Tuple[int, Dict[str, Any]]:
    """(the file's ``step``, its ``state`` with the fields of ``template``
    it lacks filled in, with a warning) for a JAX package ``.msgpack``.
    Raises ``ValueError`` when it is not one, or lacks a required field."""
    try:
        payload = flax_msgpack.load(path)
    except ValueError as e:   # UnicodeDecodeError included
        raise ValueError(f"{path}: not a JAX package checkpoint ({e})") from e
    if not (isinstance(payload, dict) and isinstance(payload.get("state"),
                                                     dict)):
        raise ValueError(f"{path}: not a JAX package checkpoint (no state "
                         "dict)")
    state, filled = fill_missing_fields(dict(template), payload["state"])
    missing = [f"/{k}" for k, v in template.items() if v is None
               and state[k] is None]
    if missing:
        raise ValueError(f"{path}: the checkpoint lacks {', '.join(missing)}")
    if filled:
        logging.getLogger(__name__).warning(
            "checkpoint %s predates state field(s) %s; using template "
            "init values for them", path, ", ".join(filled))
    return int(payload.get("step", state["step"])), state


def _optax_states(tree, fields: set) -> List[Dict[str, Any]]:
    """Every optax state of exactly ``fields`` in an ``opt_state`` tree:
    {count, mu, nu} is a ``ScaleByAdamState``, {count} a
    ``ScaleByScheduleState``."""
    if not isinstance(tree, dict):
        return []
    if set(tree) == fields:
        return [tree]
    return [s for v in tree.values() for s in _optax_states(v, fields)]


def _load_adam(optimizer, module: torch.nn.Module, opt_state,
               moments: Callable[[Any], Dict[str, torch.Tensor]],
               path: str) -> int:
    """optax's Adam state into ``optimizer`` (a torch Adam over
    ``module.parameters()`` in one group): ``mu`` -> ``exp_avg``, ``nu`` ->
    ``exp_avg_sq``, each through ``moments`` (the parameters' layout
    transform), ``count`` -> ``step``.  Returns the count."""
    adams = _optax_states(opt_state, {"count", "mu", "nu"})
    if len(adams) != 1:
        raise ValueError(f"{path}: expected one optax Adam state in the "
                         f"optimizer state, found {len(adams)}; the "
                         "optimizer cannot be carried")
    (adam,) = adams
    count = int(adam["count"])
    mu, nu = moments(adam["mu"]), moments(adam["nu"])
    names = [n for n, _ in module.named_parameters()]
    sd = optimizer.state_dict()
    (group,) = sd["param_groups"]
    if group["params"] != list(range(len(names))):
        raise ValueError("the optimizer is not one group over the module's "
                         "parameters")
    missing = [n for n in names if n not in mu or n not in nu]
    if missing:
        raise ValueError(f"{path}: no Adam moments for {missing}")
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                   for i, n in enumerate(names)}
    optimizer.load_state_dict(sd)
    return count


def _set_schedule(scheduler, count: int) -> None:
    """Put an LR schedule at optax's schedule ``count`` (the updates taken),
    as ``count`` scheduler steps would."""
    scheduler.last_epoch = count - 1
    with warnings.catch_warnings():   # a step before the optimizer's
        warnings.simplefilter("ignore")
        scheduler.step()


def load_jax_train_state(path: str, model, optimizer, scheduler=None) -> int:
    """A JAX package ``models_{step}.msgpack``'s whole TrainState into the
    port's training state: the weights and running stats (strictly), Adam's
    moments and count, and with ``scheduler`` the warm-up's count (a file
    with a schedule state and a run without one, or the reverse, raise
    ``ValueError``).  Returns the file's TrainState ``step``."""
    step, state = read_jax_checkpoint(path, _TRAIN_STATE)
    model.load_state_dict(state_dict_from_jax(
        state["params"], state["batch_stats"] or None), strict=True)
    _load_adam(optimizer, model, state["opt_state"],
               lambda tree: state_dict_from_jax(tree, None), path)
    counts = [int(s["count"])
              for s in _optax_states(state["opt_state"], {"count"})]
    if (scheduler is None) != (not counts):
        raise ValueError(f"{path}: an LR schedule state in the checkpoint "
                         f"({bool(counts)}) and in this run "
                         f"({scheduler is not None}) must go together")
    if scheduler is not None:
        _set_schedule(scheduler, counts[0])
    return int(state["step"])


def load_jax_behavior_checkpoint(path: str, bstate) -> int:
    """A JAX package ``behavior/models_{itr}.msgpack`` into ``bstate`` in
    place: both heads (strictly), both optimizers' Adam states, the step
    and ``return_scale``; returns the file's ``itr``."""
    template = dict(_BEHAVIOR_STATE)
    template["return_scale"] = bstate.return_scale.detach().cpu().numpy()
    itr, state = read_jax_checkpoint(path, template)
    actor, value = policy_state_dict_from_jax(state["actor_params"],
                                              state["value_params"])
    bstate.actor.load_state_dict(actor, strict=True)
    bstate.value.load_state_dict(value, strict=True)
    _load_adam(bstate.actor_opt, bstate.actor, state["actor_opt_state"],
               lambda tree: policy_state_dict_from_jax(tree, {})[0], path)
    _load_adam(bstate.value_opt, bstate.value, state["value_opt_state"],
               lambda tree: policy_state_dict_from_jax({}, tree)[1], path)
    bstate.step = int(state["step"])
    device = next(bstate.actor.parameters()).device
    bstate.return_scale = torch.as_tensor(
        np.array(state["return_scale"], np.float32)).to(device)
    return itr


def find_model_checkpoint(run_dir: str, itr: int) -> str:
    """``{run_dir}/models_{itr}`` with the first suffix of
    ``MODEL_SUFFIXES`` that exists; raises ``FileNotFoundError`` if none
    does."""
    for ext in MODEL_SUFFIXES:
        path = os.path.join(run_dir, f"models_{itr}{ext}")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no models_{itr}{{{','.join(MODEL_SUFFIXES)}}} "
                            f"checkpoint in {run_dir}")
