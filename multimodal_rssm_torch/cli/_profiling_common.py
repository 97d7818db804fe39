"""Shared set-up of the port's measurement tools: the synthetic replay, one
raw batch, and a train step's model, optimizer and augmentation.

The port's counterpart of the JAX package's ``scripts/_profiling_common.py``.
``cli/profile_step``, ``op_profile``, ``profile_host_feed``, ``sweep_perf``
and ``bench_scaling`` build from it, so that the done -> nonterminals and
row conventions and the step's set-up cannot drift apart between them.

Each tool composes the packaged config with ``train.pallas_normalize=auto``
ahead of the caller's overrides: on the card its steps normalise through the
hand-written kernel (K1), on the CPU through its plain version.  Each runs
on ``cuda`` unless given ``--device cpu``; without a GPU it raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

# bench.py --small's widths (the learning gate's CPU widths), which the JAX
# scripts' --small flags and the CPU tests run at
from multimodal_rssm_torch.cli.quality_gate import TINY as SMALL  # noqa: F401


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default; raises without a GPU) or cpu")


def setup_device(name: str) -> torch.device:
    """The tool's device, float32 precision pinned (TF32 off)."""
    from multimodal_rssm_torch.core.device import (
        configure_float32, resolve_device)

    device = resolve_device(name)
    configure_float32()
    return device


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def compose_config(overrides: Sequence[str] = ()):
    from multimodal_rssm_torch.core.config import compose

    return compose(overrides=["train.pallas_normalize=auto", *overrides])


def fill_synthetic_buffer(D, cfg, episodes: int = 4, ep_len: int = 120):
    """Write ``episodes`` synthetic COBOTTA-schema episodes straight into
    the host ring buffer (no filesystem round trip), as the JAX helper
    does: episode ``i`` from seed ``i``, nonterminals = 1 - done."""
    from multimodal_rssm_torch.data.synthetic import synthetic_episode

    shapes = {"image_horizon": cfg.env.observation_shapes["image_horizon"],
              "sound": cfg.env.observation_shapes["sound"]}
    for i in range(episodes):
        ep = synthetic_episode(ep_len, shapes, cfg.env.action_name,
                               int(cfg.env.action_size), seed=i)
        ep["nonterminals"] = 1.0 - np.expand_dims(ep.pop("done"), -1)
        idx = np.arange(D.idx, D.idx + ep_len)
        for name in D.observation_names:
            D.observations[name][idx] = ep[name]
        D.actions[idx] = ep[cfg.env.action_name]
        D.rewards[idx] = ep["reward"]
        D.nonterminals[idx] = ep["nonterminals"]
        D.idx += ep_len
        D.steps += ep_len
        D.episodes += 1
    return D


def synthetic_batch(cfg, L: int, B: int, device: torch.device, seed: int = 0):
    """One random raw batch, time-major: uint8 [L, B, H, W, C] images, the
    other modalities, actions and rewards standard normal, nonterminals
    1 (the JAX package's ``__graft_entry__._synthetic_batch``, in the
    modalities' sorted order)."""
    rng = np.random.default_rng(seed)
    obs = {}
    for name in sorted(set(cfg.rssm.observation_names_enc)
                       | set(cfg.rssm.observation_names_rec)):
        shape = cfg.env.observation_shapes[name]
        if "image" in name:
            c, h, w = shape
            obs[name] = rng.integers(0, 256, (L, B, h, w, c), np.uint8)
        else:
            obs[name] = rng.normal(size=(L, B, *shape)).astype(np.float32)
    A = int(cfg.env.action_size)
    rest = (rng.normal(size=(L, B, A)).astype(np.float32),
            rng.normal(size=(L, B)).astype(np.float32),
            np.ones((L, B, 1), np.float32))

    def to(a):
        return torch.from_numpy(a).to(device)

    return ({k: to(v) for k, v in obs.items()}, *map(to, rest))


def image_only_spec(raw_observations):
    """Normalise-only augmentation of each image modality (no crop, noise
    or PCA), with empty draws: the step the JAX helper profiles."""
    from multimodal_rssm_torch.train import trainer as tr

    mods = tuple(
        (name, tr.ModalityAugSpec(out_size=tuple(x.shape[2:4]),
                                  needs_crop=False, noise=False, pca=False,
                                  normalize=True))
        for name, x in raw_observations.items() if "image" in name)
    return tr.AugSpec(modalities=mods), {name: {} for name, _ in mods}


def build_model(cfg, device: torch.device, seed: int = 0):
    """The configured world model on random weights from ``seed``, its
    optimizer and schedule."""
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.train import trainer as tr

    model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer, scheduler = tr.build_optimizer(cfg, model)
    return model, optimizer, scheduler


class StepSetup(NamedTuple):
    cfg: object
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: object
    spec: object
    draws: Dict
    raw: tuple
    generator: torch.Generator
    device: torch.device
    train_step: Callable


def build_step_setup(batch_size: Optional[int], chunk_size: Optional[int],
                     overrides: Sequence[str] = (),
                     device: str = "cuda") -> StepSetup:
    """Compose the config (``batch_size`` / ``chunk_size`` None: the
    config's), then one synthetic raw batch on the device, the image-only
    augmentation and its draws, the model on random weights (seed 0), its
    optimizer, a device generator and the train step
    (``train/trainer.make_train_step``: ``train_step(raw, draws,
    generator) -> metrics``)."""
    from multimodal_rssm_torch.train import trainer as tr

    dev = setup_device(device)
    sizes = [f"train.batch_size={batch_size}"] if batch_size else []
    sizes += [f"train.chunk_size={chunk_size}"] if chunk_size else []
    cfg = compose_config([*sizes, *overrides])
    L, B = int(cfg.train.chunk_size), int(cfg.train.batch_size)
    raw = synthetic_batch(cfg, L, B, dev)
    spec, draws = image_only_spec(raw[0])
    model, optimizer, scheduler = build_model(cfg, dev)
    generator = torch.Generator(dev).manual_seed(0)
    train_step, _ = tr.make_train_step(model, cfg, optimizer, scheduler,
                                       spec, dev)
    return StepSetup(cfg, model, optimizer, scheduler, spec, draws, raw,
                     generator, dev, train_step)
