"""Offline posterior state estimation over every stored episode.

Port of the JAX package's ``eval/state_estimation.py`` (reference
utils/evaluation/estimate_states.py): per-episode inference at batch 1 over
the train set, saved as ``states_models_{itr}.npy`` next to the checkpoint,
keyed by the episode's file name.

The model runs in ``eval()`` mode (the norms read their running stats and
update none) under ``torch.no_grad``, in float32.  One seeded
``torch.Generator`` on the model's device replaces the JAX key splits: it
draws each episode's normalise noise and, unless ``det``, its state noise,
episode after episode.

Each episode goes through the training step's input pipeline
(``train/trainer.py::prepare_observations``, crop offset 0, no noise or PCA
shift), whose bit-depth normalise is always the hand-written kernel's
wrapper (K1, ``ops/cuda_kernels.normalize_image``), whatever the run was
trained with: one launch per episode and image modality on the card, its
bit-equal plain version on the CPU.  The JAX package's eval takes its
``jax.random`` path instead.  The two differ only in the random stream of
the dequantisation noise, which differs between the packages anyway; both
draw it uniform in [0, 2^-bit_depth).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from multimodal_rssm_torch.data import augment as aug
from multimodal_rssm_torch.train import trainer as tr


def episode_bounds(buffer) -> np.ndarray:
    """Episode start indices from the nonterminal == 0 markers, plus the
    end of the last episode (ref estimate_states.py:36-38)."""
    idx_done = np.where(buffer.nonterminals[: buffer.idx, 0] == 0)[0]
    return np.hstack([[0], idx_done + 1])


def fixed_draws(buffer, spec: tr.AugSpec) -> Dict[str, Dict[str, np.ndarray]]:
    """The evaluation's augmentation draws: crop index 0, no noise or PCA
    shift."""
    out = {}
    for name, mspec in spec.modalities:
        entry = {}
        if mspec.needs_crop:
            stored_hw = buffer.observations[name].shape[1:3]
            dh, dw = aug.idx_to_offsets(0, stored_hw, mspec.out_size,
                                        buffer.dh_base, buffer.dw_base)
            entry["crop"] = np.asarray([dh, dw], np.int32)
        if mspec.noise:
            entry["noise"] = np.float32(0.0)
        if mspec.pca:
            entry["pca"] = np.zeros(3, np.float32)
        out[name] = entry
    return out


def get_episode_data(buffer, epi_idx: int, spec: tr.AugSpec, draws,
                     bit_depth: int, generator: torch.Generator,
                     device: torch.device):
    """One whole episode as a batch-1 chunk on ``device``: (prepared
    observations {name: [T, 1, ...]}, actions [T, 1, A], rewards [T, 1],
    nonterminals [T, 1, 1]).  Images are normalised by K1's wrapper."""
    bounds = episode_bounds(buffer)
    lo, hi = int(bounds[epi_idx]), int(bounds[epi_idx + 1])

    def take(a):
        return torch.from_numpy(np.ascontiguousarray(a[lo:hi][:, None])
                                ).to(device)

    observations = tr.prepare_observations(
        {name: take(buffer.observations[name])
         for name in buffer.observation_names},
        spec, draws, bit_depth, generator, kernel_normalize=True)
    return (observations, take(buffer.actions), take(buffer.rewards),
            take(buffer.nonterminals))


def tensor2numpy_state(state) -> Dict:
    """State dict of tensors (expert dicts included) -> NumPy arrays on the
    host (ref estimate_states.py:12-20)."""
    return {k: (tensor2numpy_state(v) if isinstance(v, dict)
                else v.detach().cpu().numpy()) for k, v in state.items()}


@torch.no_grad()
def estimate_episode(model, buffer, epi_idx: int,
                     spec: Optional[tr.AugSpec] = None, bit_depth: int = 5,
                     generator: Optional[torch.Generator] = None,
                     det: bool = False) -> Dict:
    """Posterior inference over one episode at batch 1: T - 1 outputs from
    ``observations[1:]`` and ``actions[:-1]``.  ``generator`` (default: seed
    0 on the model's device) draws the normalise noise and, unless
    ``det``, the state noise."""
    device = next(model.parameters()).device
    spec = spec if spec is not None else tr.build_aug_spec(buffer)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    obs, actions, _, nonterminals = get_episode_data(
        buffer, epi_idx, spec, fixed_draws(buffer, spec), bit_depth,
        generator, device)
    model.eval()
    return model.estimate_state({k: v[1:] for k, v in obs.items()},
                                actions[:-1], nonterminals[:-1],
                                None if det else generator)


def get_states(model, buffer, bit_depth: int = 5, seed: int = 0
               ) -> Dict[str, Dict]:
    """Every episode -> {episode file name: NumPy state dict} (ref
    estimate_states.py:60-70), one generator seeded ``seed`` throughout."""
    spec = tr.build_aug_spec(buffer)
    generator = torch.Generator(next(model.parameters()).device
                                ).manual_seed(seed)
    states = {}
    for epi_idx in range(buffer.episodes):
        s = estimate_episode(model, buffer, epi_idx, spec, bit_depth,
                             generator)
        name = (buffer.file_names[epi_idx]
                if epi_idx < len(buffer.file_names) else f"episode_{epi_idx}")
        states[name] = tensor2numpy_state(s)
    return states


def states_file_name(model_path: str) -> str:
    """``.../models_{itr}.pt|.pth|.msgpack`` -> ``.../states_models_{itr}
    .npy``."""
    root, ext = os.path.splitext(model_path)
    if ext not in (".pt", ".pth", ".msgpack"):
        raise ValueError(f"{model_path}: not a .pt, .pth or .msgpack file")
    head, name = os.path.split(root)
    if name.startswith("models_"):
        name = "states_" + name
    return os.path.join(head, name + ".npy")


def load_eval_model(cfg, model_path: str, device: torch.device,
                    dtype: torch.dtype = torch.float32):
    """The configured model with the checkpoint's weights, on ``device``,
    in ``eval()`` mode, computing in ``dtype`` (float32, as the JAX
    package's evaluation and serving build it; the control entry points
    pass ``trainer.compute_dtype(cfg)``, as the JAX package's do)."""
    from multimodal_rssm_torch.io.checkpoint import load_model_weights
    from multimodal_rssm_torch.models.world_model import WorldModel

    model = WorldModel.from_config(cfg, dtype)
    load_model_weights(model_path, model)
    return model.to(device).eval()


def run(cfg, cwd: str, model_path: str, device: torch.device) -> str:
    """Offline evaluation (ref estimate_states.py:73-89): load the train
    set and the checkpoint, estimate every episode, save
    ``states_models_{itr}.npy``; returns its path."""
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset

    model = load_eval_model(cfg, model_path, device)
    D = build_buffer(cfg)
    load_dataset(cwd, D, cfg.train.train_data_path)
    states = get_states(model, D, bit_depth=int(cfg.env.bit_depth))
    save_file = states_file_name(model_path)
    np.save(save_file, states)
    return save_file
