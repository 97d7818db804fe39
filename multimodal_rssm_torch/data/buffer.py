"""Host-RAM experience replay with uniform sequence-chunk sampling
(reference utils/replay_buffer/memory.py:110-284).

A NumPy ring buffer: uint8 HWC images (oversized by the crop margin),
float32 for everything else.  ``sample(n, L)`` gathers time-major
[L, n, ...] chunks with the native gather (``data/native.py``);
``to_device`` moves a batch to the training device through pinned memory;
``HostBatchFeed`` (the host-streamed feed) gathers straight into pinned
staging batches instead.
Augmentation and the bit-depth normalise run on the device in the train
step.  ``data/device_buffer.py`` keeps the loaded rows on the device
instead.

Sampling matches the reference: a uniform start index, chunks may cross
episode boundaries (nonterminal masking handles them), only the ring
write head is excluded.
"""

from __future__ import annotations

import collections
import functools
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from multimodal_rssm_torch.data.augment import (
    calc_params_of_pca, storage_image_shape)
from multimodal_rssm_torch.data.episodes import get_data, get_file_names
from multimodal_rssm_torch.data.native import gather_chunks


class ExperienceReplay:
    """Multimodal ring buffer + chunk sampler (host side)."""

    def __init__(self, size: int, observation_names: Sequence[str],
                 observation_shapes: Mapping[str, Sequence[int]],
                 n_crop: Optional[int] = None, dh_base: Optional[int] = None,
                 dw_base: Optional[int] = None,
                 noise_scales: Optional[Sequence[float]] = None,
                 pca_scales: Optional[Sequence[float]] = None,
                 action_name: str = "action", action_size: int = 1,
                 seed: int = 0, load_workers: int = 4):
        self.size = int(size)
        self.observation_names = list(observation_names)
        self.action_name = action_name
        self.n_crop = n_crop
        self.dh_base = dh_base
        self.dw_base = dw_base
        self.noise_scales = list(noise_scales) if noise_scales is not None else None
        self.pca_scales = list(pca_scales) if pca_scales is not None else None
        self.load_workers = int(load_workers)
        self.rng = np.random.default_rng(seed)
        self.idx = 0
        self.full = False
        self.steps = 0
        self.episodes = 0
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

    def gather(self, idxs: np.ndarray, out=None):
        """Raw chunks, time-major: (observations {name: [L, n, ...]},
        actions [L, n, A], rewards [L, n], nonterminals [L, n, 1]); images
        stay uint8.  ``out``: arrays of that layout to gather into."""
        if out is None:
            out = ({name: None for name in self.observation_names},
                   None, None, None)
        obs_out, act_out, rew_out, nt_out = out
        observations = {name: gather_chunks(self.observations[name], idxs,
                                            out=obs_out[name])
                        for name in self.observation_names}
        return (observations, gather_chunks(self.actions, idxs, out=act_out),
                gather_chunks(self.rewards, idxs, out=rew_out),
                gather_chunks(self.nonterminals, idxs, out=nt_out))

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
        self.steps += episode_length
        self.episodes += 1

    def load_dataset(self, dataset_dir: str,
                     workers: Optional[int] = None) -> None:
        """Load every episode file of a directory (ref memory.py:262-273).

        With more than one worker (default ``load_workers``), reading and
        preprocessing the files (``np.load``, the margin crop: I/O and NumPy
        that release the interpreter lock) runs on a thread pool at most
        ``workers + 2`` files ahead, while the ring writes stay in file
        order: the buffer is bit-identical to a serial load."""
        file_names: List[str] = get_file_names(dataset_dir)
        if not file_names:
            raise FileNotFoundError(
                f"no episode files (*.npy) in {dataset_dir} — point "
                "train.*_data_path at the episode directory itself")
        n = self.load_workers if workers is None else int(workers)
        read = functools.partial(get_data, n_crop=self.n_crop,
                                 dh_base=self.dh_base, dw_base=self.dw_base)
        if n > 1 and len(file_names) > 1:
            with ThreadPoolExecutor(max_workers=n) as ex:
                names = iter(file_names)
                pending = collections.deque(
                    ex.submit(read, f) for f in itertools.islice(names, n + 2))
                while pending:
                    self._write_episode(*pending.popleft().result())
                    nxt = next(names, None)
                    if nxt is not None:
                        pending.append(ex.submit(read, nxt))
        else:
            for file_name in file_names:
                self._write_episode(*read(file_name))
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
        seed=seed, load_workers=int(cfg.train.get("load_workers", 4)))


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


class HostBatchFeed:
    """The host-streamed feed's producer, for the prefetch thread: each
    call draws [n, L] chunk indices from the buffer's generator, gathers
    them with the native gather straight into one of two pinned staging
    batches and copies that to the device on the current stream.  A staging
    batch is refilled only once its previous copy has run (an event each).
    On a CPU device it returns the gathered arrays as tensors.

    Returns (the buffer generator's state after the draw, the batch): a
    checkpoint stores the state of the last batch a step took, since the
    prefetch thread has drawn ahead of the loop."""

    _SLOTS = 2

    def __init__(self, buffer: ExperienceReplay, n: int, L: int,
                 device: torch.device):
        self.buffer, self.n, self.L, self.device = buffer, int(n), int(L), device
        self._slots = []
        if device.type == "cuda":
            def pinned(a):
                return torch.empty((self.L, self.n, *a.shape[1:]),
                                   dtype=torch.from_numpy(a[:0]).dtype,
                                   pin_memory=True)

            self._slots = [
                (({k: pinned(v) for k, v in buffer.observations.items()},
                  pinned(buffer.actions), pinned(buffer.rewards),
                  pinned(buffer.nonterminals)), torch.cuda.Event())
                for _ in range(self._SLOTS)]
        self._next = 0

    def __call__(self):
        idxs = self.buffer.sample_indices(self.n, self.L)
        state = self.buffer.rng.bit_generator.state
        if not self._slots:
            return state, to_device(self.buffer.gather(idxs), self.device)
        (obs, act, rew, nt), done = self._slots[self._next]
        self._next = (self._next + 1) % self._SLOTS
        done.synchronize()
        self.buffer.gather(idxs, out=({k: v.numpy() for k, v in obs.items()},
                                      act.numpy(), rew.numpy(), nt.numpy()))

        def move(t):
            return t.to(self.device, non_blocking=True)

        batch = ({k: move(v) for k, v in obs.items()}, move(act), move(rew),
                 move(nt))
        done.record()
        return state, batch
