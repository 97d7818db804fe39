"""Checkpoints of a training run: atomic, asynchronous on the cadence, pruned.

A checkpoint ``models_{step}.pt`` (``torch.save``) holds the whole training
state: ``step``, the model's ``state_dict`` (its norms' running stats
included), the optimizer's and the LR scheduler's ``state_dict``s, and
``extra`` (the loop's torch generator and its NumPy generators' states).  It is written to a ``.tmp`` file
and renamed, so a run killed mid-write never leaves a truncated
checkpoint.  ``latest_checkpoint`` / ``restore_or_none`` find the newest
for ``--resume``; ``load_checkpoint`` restores strictly.

``load_reference_checkpoint`` reads a reference ``models_{itr}.pth`` (the
nested ``model_dicts`` layout) into the port's model.
``find_model_checkpoint`` / ``load_model_weights`` give evaluation a run
dir's ``models_{itr}`` weights, from a ``.pt`` or a ``.pth``.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_NAME = re.compile(r"models_(\d+)\.pt")


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


def _checkpoints(results_dir: str) -> List[Tuple[int, str]]:
    """[(step, path)] of the ``models_{step}.pt`` files, by step."""
    if not os.path.isdir(results_dir):
        return []
    found = []
    for name in os.listdir(results_dir):
        m = _NAME.fullmatch(name)
        if m:
            found.append((int(m.group(1)), os.path.join(results_dir, name)))
    return sorted(found)


def prune_checkpoints(results_dir: str, keep: int) -> List[str]:
    """Delete all but the ``keep`` highest-step checkpoints (0 keeps
    every one); returns the deleted paths."""
    if keep <= 0:
        return []
    doomed = [p for _, p in _checkpoints(results_dir)[:-keep]]
    for p in doomed:
        os.remove(p)
    return doomed


def latest_checkpoint(results_dir: str) -> Optional[str]:
    """The highest-step checkpoint of a run dir, or None."""
    found = _checkpoints(results_dir)
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
    path = latest_checkpoint(results_dir)
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
    strictly: from a port checkpoint ``.pt`` (its ``model`` entry) or a
    reference ``.pth``.  A JAX package ``.msgpack`` raises
    ``NotImplementedError``."""
    if path.endswith(".pt"):
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
    elif path.endswith(".pth"):
        load_reference_checkpoint(path, model)
    elif path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: the JAX package's .msgpack checkpoints need flax to "
            "read; loading them waits for ROADMAP queue 1 item 10 (convert "
            "with the JAX package's bridge)")
    else:
        raise ValueError(f"{path}: not a .pth or .pt file")


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
