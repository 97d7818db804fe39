"""Host-RAM experience replay with uniform sequence-chunk sampling
(reference utils/replay_buffer/memory.py:110-284).

A NumPy ring buffer: uint8 HWC images (oversized by the crop margin),
float32 for everything else.  ``sample(n, L)`` gathers time-major
[L, n, ...] chunks with a NumPy gather; ``to_device`` moves a batch to the
training device through pinned memory.  Augmentation and the bit-depth
normalise run on the device in the train step.

Sampling matches the reference: a uniform start index, chunks may cross
episode boundaries (nonterminal masking handles them), only the ring
write head is excluded.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from multimodal_rssm_torch.data.augment import (
    calc_params_of_pca, storage_image_shape)
from multimodal_rssm_torch.data.episodes import get_data, get_file_names


class ExperienceReplay:
    """Multimodal ring buffer + chunk sampler (host side)."""

    def __init__(self, size: int, observation_names: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 n_crop: Optional[int] = None, dh_base: Optional[int] = None,
                 dw_base: Optional[int] = None,
                 noise_scales: Optional[Sequence[float]] = None,
                 pca_scales: Optional[Sequence[float]] = None,
                 action_name: str = "action", action_size: int = 1,
                 seed: int = 0):
        self.size = int(size)
        self.observation_names = list(observation_names)
        self.action_name = action_name
        self.n_crop = n_crop
        self.dh_base = dh_base
        self.dw_base = dw_base
        self.noise_scales = list(noise_scales) if noise_scales is not None else None
        self.pca_scales = list(pca_scales) if pca_scales is not None else None
        self.rng = np.random.default_rng(seed)
        self.idx = 0
        self.full = False
        self.lambd_eigen_values: Dict[str, Optional[np.ndarray]] = {}
        self.p_eigen_vectors: Dict[str, Optional[np.ndarray]] = {}
        self.observations: Dict[str, np.ndarray] = {}
        for name in self.observation_names:
            shape = observation_shapes[name]
            if "image" in name:
                c, h, w = storage_image_shape(shape, n_crop, dw_base or 2,
                                              dh_base or 2)
                self.observations[name] = np.empty((self.size, h, w, c), np.uint8)
            else:
                self.observations[name] = np.empty((self.size, *shape), np.float32)
        self.actions = np.empty((self.size, int(action_size)), np.float32)
        self.rewards = np.empty((self.size,), np.float32)
        self.nonterminals = np.empty((self.size, 1), np.float32)

    # -- sampling ---------------------------------------------------------
    def _sample_idx(self, L: int) -> np.ndarray:
        """One valid chunk (ref memory.py:177-187)."""
        idx_max = self.size if self.full else self.idx - L
        if idx_max <= 0:
            raise ValueError(f"buffer holds {self.idx} rows, fewer than a "
                             f"chunk of {L}")
        while True:
            idx = int(self.rng.integers(0, idx_max))
            idxs = np.arange(idx, idx + L) % self.size
            if self.idx not in idxs[1:]:
                return idxs

    def sample_indices(self, n: int, L: int) -> np.ndarray:
        """[n, L] chunk indices."""
        return np.asarray([self._sample_idx(L) for _ in range(n)])

    def gather(self, idxs: np.ndarray):
        """Raw chunks, time-major: (observations {name: [L, n, ...]},
        actions [L, n, A], rewards [L, n], nonterminals [L, n, 1]); images
        stay uint8."""
        flat = idxs.T.reshape(-1)
        L, n = idxs.shape[1], idxs.shape[0]

        def take(arr):
            return arr[flat].reshape(L, n, *arr.shape[1:])

        observations = {name: take(self.observations[name])
                        for name in self.observation_names}
        return (observations, take(self.actions), take(self.rewards),
                take(self.nonterminals))

    def sample(self, n: int, L: int):
        """Uniform batch of sequence chunks (ref memory.py:212-222)."""
        return self.gather(self.sample_indices(n, L))

    # -- ingest -----------------------------------------------------------
    def _write_episode(self, data, episode_length: int) -> None:
        idx = np.arange(self.idx, self.idx + episode_length) % self.size
        for name in self.observation_names:
            self.observations[name][idx] = data[name]
        self.actions[idx] = (0.0 if self.action_name == "dummy"
                             else data[self.action_name])
        self.rewards[idx] = np.asarray(data["reward"], np.float32).reshape(-1)
        self.nonterminals[idx] = data["nonterminals"]
        self.full = self.full or (self.idx + episode_length) >= self.size
        self.idx = (self.idx + episode_length) % self.size

    def load_dataset(self, dataset_dir: str) -> None:
        """Load every episode file of a directory (ref memory.py:262-273)."""
        file_names: List[str] = get_file_names(dataset_dir)
        if not file_names:
            raise FileNotFoundError(
                f"no episode files (*.npy) in {dataset_dir} — point "
                "train.*_data_path at the episode directory itself")
        for file_name in file_names:
            self._write_episode(*get_data(file_name, self.n_crop,
                                          self.dh_base, self.dw_base))
        if self.pca_scales is not None:
            n_valid = self.size if self.full else self.idx
            for name in self.observation_names:
                if "image" in name and "bin" not in name:
                    lambd, p = calc_params_of_pca(self.observations[name][:n_valid])
                    self.lambd_eigen_values[name] = lambd
                    self.p_eigen_vectors[name] = p
                else:
                    self.lambd_eigen_values[name] = None
                    self.p_eigen_vectors[name] = None


def build_buffer(cfg, seed: int = 0) -> ExperienceReplay:
    """A buffer from a composed config (ref train.py:9-25)."""
    names = sorted(set(list(cfg.rssm.observation_names_enc)
                       + list(cfg.rssm.observation_names_rec)))
    aug = cfg.train.augmentation
    return ExperienceReplay(
        size=cfg.train.experience_size, observation_names=names,
        observation_shapes=cfg.env.observation_shapes, n_crop=aug.n_crop,
        dh_base=aug.dh_base, dw_base=aug.dw_base,
        noise_scales=aug.noise_scales, pca_scales=aug.pca_scales,
        action_name=cfg.env.action_name, action_size=cfg.env.action_size,
        seed=seed)


def load_dataset(cwd: str, buffer: ExperienceReplay, dataset_path) -> None:
    """str-or-list dataset path dispatch (ref memory.py:13-32); each path
    is an episode directory, relative to ``cwd`` unless absolute."""
    paths = [dataset_path] if isinstance(dataset_path, str) else list(dataset_path)
    for p in paths:
        full = os.path.join(cwd, p)
        if not os.path.isdir(full):
            raise FileNotFoundError(f"{full} is not an episode directory")
        buffer.load_dataset(full)


def to_device(batch, device: torch.device):
    """Host numpy batch -> tensors on ``device`` (pinned, non-blocking
    copies when the device is a GPU)."""
    observations, actions, rewards, nonterminals = batch
    pin = device.type == "cuda"

    def move(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    return ({k: move(v) for k, v in observations.items()}, move(actions),
            move(rewards), move(nonterminals))
