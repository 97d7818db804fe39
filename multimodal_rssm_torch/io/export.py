"""Serving export: frozen programs via ``torch.export``.

Port of the JAX package's ``io/export.py``.  The per-frame posterior
filter, the decoder, the filter + actor controller step and the filter +
CEM planner step are each traced once by ``torch.export.export``, in
``eval()`` mode (the norms read their running statistics) with the trained
weights baked in, and saved as one ``.pt2`` file.  Where it is loaded
(``io/serve.py``), ``torch.export.load(path).module()`` calls it with no
model code, no config tree and no checkpoint plumbing.  Shapes are static,
fixed at export time (``batch_size``); the program runs on the device it
was exported on (``cuda`` or ``cpu``), in the world model's compute dtype
(``WorldModel.compute_dtype``, written into the meta), the policy heads in
float32.  ``cli/export_model.py`` exports a float32 world model whatever
``train.use_amp`` says, as the JAX package's ``cli/export_model.py``
builds its serving model.  Every output is float32.

Input contract (the JAX package's): image modalities enter as raw uint8
[B, H, W, C] frames at the configured observation size and are bit-depth
normalised inside the program, deterministically (evaluation semantics, no
dequantisation noise: plain ops, not K1, which always adds noise);
other modalities enter as float32 [B, ...] in the dataset's units.

Calling convention:

- ``filter_step``, ``agent_step``, ``plan_step``: (h [B, H] f32, s [B, S]
  f32, action [B, A] f32, obs {name: raw frame}, nonterminal [B, 1] f32,
  key int64 [2]);
- ``filter_step`` -> the per-step state dict (beliefs, prior, posterior,
  experts where the variant has them); carry ``beliefs`` and
  ``posterior_states`` forward.  Deterministic: the key is not read;
- ``decode``: (h, s) -> {name: {"loc": [1, B, ...]}} (the leading time
  axis of 1, as the JAX package's);
- ``agent_step`` -> (belief', posterior mean', action): the actor's
  100-sample mode-seeking action, its noise from the key;
- ``plan_step`` -> (belief', posterior mean', action): CEM over the reward
  head (``cfg.planner`` baked in), its candidates' and rollouts' noise
  from the key.

The key's draws (``ops/keyed_noise.py``): the actor's [100, B, A] normals
on stream ``ACTOR_STREAM``; CEM iteration i's action noise
[H, B, J, A] on stream ``1 + 2 i`` and its state noise [H, B * J, S]
(normals; Gumbel [H, B * J, V, K] for categorical latents; none when
``planner.stochastic_rollout`` is off) on stream ``2 + 2 i``.

    art = export_filter_step(cfg, model)
    save_exported(art, "exported/filter_step.pt2")
    ...
    fn, meta = load_exported("exported/filter_step.pt2")     # no model code
    out = fn(h, s, action, obs, nonterminal, key)
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from multimodal_rssm_torch.io.serve import (  # noqa: F401  (re-exported)
    META_NAME, SUFFIX, flatten_tree, load_exported)
from multimodal_rssm_torch.models.policy import MODE_SAMPLES
from multimodal_rssm_torch.ops import keyed_noise
from multimodal_rssm_torch.ops.image import normalize_image_deterministic

STEP_ARGS = ("h", "s", "action", "obs", "nonterminal", "key")
DECODE_ARGS = ("h", "s")
ACTOR_STREAM = 0


class Exported(NamedTuple):
    """An exported program and its description (``io/serve.read_meta``)."""
    program: Any
    meta: Dict[str, Any]


def cem_streams(i: int) -> Tuple[int, int]:
    """The key streams of CEM iteration ``i``: (action noise, state noise)."""
    return 1 + 2 * i, 2 + 2 * i


def normalize_obs(obs: Dict[str, torch.Tensor], bit_depth: int
                  ) -> Dict[str, torch.Tensor]:
    """Deterministic bit-depth normalise of the image modalities (no
    dequantisation noise); the others as float32."""
    return {k: (normalize_image_deterministic(v, bit_depth) if "image" in k
                else v.float()) for k, v in obs.items()}


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_float32(v) for v in tree)
    return tree.float()


def agent_noise(key: torch.Tensor, batch_size: int, action_size: int
                ) -> torch.Tensor:
    """The actor's mode-seeking noise [100, B, A] from the key."""
    return keyed_noise.normal(key, (MODE_SAMPLES, batch_size, action_size),
                              ACTOR_STREAM)


def cem_noise(model, cfg, key: torch.Tensor, batch_size: int):
    """(action noise [iters, H, B, J, A], state noise [iters, H, B * J, ...]
    or None) of a CEM plan from the key (``train/planner.py``'s ``noise``)."""
    from multimodal_rssm_torch.train.planner import planner_cfg

    p = planner_cfg(cfg).planner
    H, iters = int(p.planning_horizon), int(p.optimisation_iters)
    J, A = int(p.candidates), int(cfg.env.action_size)
    a_eps, s_eps = [], []
    for i in range(iters):
        a_stream, s_stream = cem_streams(i)
        a_eps.append(keyed_noise.normal(key, (H, batch_size, J, A), a_stream))
        if p.stochastic_rollout:
            draw = (keyed_noise.gumbel if model.latent_dist == "categorical"
                    else keyed_noise.normal)
            s_eps.append(draw(key, model.noise_shape(H, batch_size * J),
                              s_stream))
    return (torch.stack(a_eps),
            torch.stack(s_eps) if p.stochastic_rollout else None)


class _Step(nn.Module):
    """The world model's deterministic filter on a raw frame, in the
    model's compute dtype (``filter``: the per-step state dict, float32)."""

    def __init__(self, cfg, model):
        super().__init__()
        self.model = model
        self.bit_depth = int(cfg.env.bit_depth)

    def filter(self, h, s, action, obs, nonterminal):
        obs = normalize_obs(obs, self.bit_depth)
        states = self.model.filter_step(h, s, action, obs, nonterminal)
        return _float32(states)


class FilterStep(_Step):
    def forward(self, h, s, action, obs, nonterminal, key):
        return self.filter(h, s, action, obs, nonterminal)


class Decode(_Step):
    def forward(self, h, s):
        out = self.model.decode(h[None], s[None])
        return {k: {"loc": v["loc"].float()} for k, v in out.items()}


class AgentStep(_Step):
    def __init__(self, cfg, model, actor):
        super().__init__(cfg, model)
        self.actor = actor

    def forward(self, h, s, action, obs, nonterminal, key):
        states = self.filter(h, s, action, obs, nonterminal)
        h2, s2 = states["beliefs"], states["posterior_means"]
        eps = agent_noise(key, h.shape[0], action.shape[1])
        return h2, s2, self.actor(h2, s2, None, True, eps)


class PlanStep(_Step):
    def __init__(self, cfg, model):
        from multimodal_rssm_torch.train.planner import make_cem_planner

        super().__init__(cfg, model)
        self.cfg = cfg
        self.plan = make_cem_planner(model, cfg)

    def forward(self, h, s, action, obs, nonterminal, key):
        states = self.filter(h, s, action, obs, nonterminal)
        h2, s2 = states["beliefs"], states["posterior_means"]
        noise = cem_noise(self.model, self.cfg, key, h.shape[0])
        return h2, s2, self.plan(h2, s2, noise=noise)


def step_inputs(cfg, model, batch_size: int, device) -> tuple:
    """Zero example arguments of the step artifacts (uint8 NHWC images,
    float32 otherwise, an int64 [2] key) on ``device``."""
    B = batch_size
    obs = {}
    for name in model.observation_names_enc:
        shape = tuple(int(x) for x in cfg.env.observation_shapes[name])
        if "image" in name:
            c, h, w = shape
            obs[name] = torch.zeros((B, h, w, c), dtype=torch.uint8,
                                    device=device)
        else:
            obs[name] = torch.zeros((B, *shape), device=device)
    return (torch.zeros(B, model.belief_size, device=device),
            torch.zeros(B, model.state_size, device=device),
            torch.zeros(B, int(cfg.env.action_size), device=device),
            obs, torch.ones(B, 1, device=device),
            torch.zeros(2, dtype=torch.int64, device=device))


def _signature(tree) -> Dict[str, list]:
    return {k: [str(v.dtype).replace("torch.", ""), list(v.shape)]
            for k, v in flatten_tree(tree).items()}


def _export(kind: str, module: nn.Module, args: tuple,
            arg_names: Tuple[str, ...]) -> Exported:
    """Trace ``module`` on ``args`` (eval mode, no gradient) into an
    ``Exported`` with its description."""
    module.eval()
    device = args[0].device
    t0 = time.perf_counter()
    program = torch.export.export(module, args, strict=False)
    seconds = time.perf_counter() - t0
    output = [n for n in program.graph.nodes if n.op == "output"][0]
    out_spec = [n.meta["val"] for n in output.args[0]]
    outputs = pytree.tree_unflatten(
        [torch.empty(v.shape, dtype=v.dtype) for v in out_spec],
        program.call_spec.out_spec)
    meta = {
        "kind": kind, "device": device.type,
        "compute_dtype": str(module.model.compute_dtype).replace("torch.",
                                                                 ""),
        "batch_size": int(args[0].shape[0]), "arg_names": list(arg_names),
        "inputs": _signature(dict(zip(arg_names, args))),
        "outputs": _signature(outputs),
        "export_seconds": seconds, "torch": torch.__version__,
    }
    return Exported(program, meta)


def export_filter_step(cfg, model, batch_size: int = 1) -> Exported:
    """One streaming posterior update (``WorldModel.filter_step``) with the
    model's weights baked in."""
    device = next(model.parameters()).device
    return _export("filter_step", FilterStep(cfg, model),
                   step_inputs(cfg, model, batch_size, device), STEP_ARGS)


def export_decode(cfg, model, batch_size: int = 1) -> Exported:
    """The per-modality decoder: (belief [B, H], state [B, S]) ->
    {modality: {"loc": [1, B, ...]}}."""
    device = next(model.parameters()).device
    h, s = step_inputs(cfg, model, batch_size, device)[:2]
    return _export("decode", Decode(cfg, model), (h, s), DECODE_ARGS)


def export_agent_step(cfg, model, actor, batch_size: int = 1) -> Exported:
    """The controller step: raw frame -> posterior update -> the actor's
    mode-seeking action; world-model and actor weights baked in."""
    device = next(model.parameters()).device
    return _export("agent_step", AgentStep(cfg, model, actor),
                   step_inputs(cfg, model, batch_size, device), STEP_ARGS)


def export_plan_step(cfg, model, batch_size: int = 1) -> Exported:
    """The zero-shot MPC step: raw frame -> posterior update -> the
    CEM-planned action (``train/planner.py``, every iteration inside the
    program); world-model weights only, ``cfg.planner`` baked in."""
    device = next(model.parameters()).device
    return _export("plan_step", PlanStep(cfg, model),
                   step_inputs(cfg, model, batch_size, device), STEP_ARGS)


def save_exported(exported: Exported, path: str) -> str:
    """Write an ``Exported`` to ``path`` (a ``.pt2``, its description
    inside) atomically; returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.export.save(exported.program, f,
                          extra_files={META_NAME: json.dumps(exported.meta)})
    os.replace(tmp, path)
    return path


def export_run(cfg, model, out_dir: str, batch_size: int = 1,
               actor: Optional[nn.Module] = None, plan: bool = False
               ) -> Dict[str, str]:
    """Export ``filter_step`` and ``decode``, ``agent_step`` when ``actor``
    is given and ``plan_step`` when ``plan``, into ``out_dir``; returns
    {name: path}."""
    arts = {"filter_step": lambda: export_filter_step(cfg, model, batch_size),
            "decode": lambda: export_decode(cfg, model, batch_size)}
    if actor is not None:
        arts["agent_step"] = lambda: export_agent_step(cfg, model, actor,
                                                       batch_size)
    if plan:
        arts["plan_step"] = lambda: export_plan_step(cfg, model, batch_size)
    return {name: save_exported(make(), os.path.join(out_dir, name + SUFFIX))
            for name, make in arts.items()}
