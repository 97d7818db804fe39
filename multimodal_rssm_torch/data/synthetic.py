"""Synthetic COBOTTA-schema episode generator.

The reference's real dataset (robot drilling demos) is not distributed with
the repo; tests and benchmarks need episodes in exactly its ``.npy`` schema
(utils/replay_buffer/memory.py:90-107, dataset/COBOTTA pick_data.ipynb
outputs): a pickled dict of per-step arrays with image / sound / pose
channels, ``done``, ``reward``, and action channels.

Generates smooth structured sequences (moving blob images, drifting
spectrogram bands) rather than white noise so that a world model can
actually reduce loss on them.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np


def synthetic_episode(
    length: int,
    observation_shapes: Mapping[str, Sequence[int]],
    action_name: str = "d_pose_quat_v2",
    action_size: int = 3,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """One episode dict matching the reference schema.  Image entries are
    uint8 HWC; sound is float [128, 20]; actions are smooth deltas."""
    rng = np.random.default_rng(seed)
    data: Dict[str, np.ndarray] = {}

    # smooth 2-d latent trajectory driving all modalities
    pos = np.zeros((length, 2), np.float32)
    vel = rng.normal(0, 0.05, 2).astype(np.float32)
    for t in range(1, length):
        vel = 0.95 * vel + rng.normal(0, 0.02, 2).astype(np.float32)
        pos[t] = np.clip(pos[t - 1] + vel, -1, 1)

    for name, shape in observation_shapes.items():
        if "image" in name:
            c, h, w = shape
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            imgs = np.zeros((length, h, w, c), np.uint8)
            for t in range(length):
                cx = (pos[t, 0] * 0.4 + 0.5) * w
                cy = (pos[t, 1] * 0.4 + 0.5) * h
                blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (0.02 * h * w)))
                frame = np.stack([blob * (0.4 + 0.2 * k) for k in range(c)], -1)
                imgs[t] = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
            data[name] = imgs
        elif "sound" in name:
            f, tt = shape
            freqs = np.linspace(0, 1, f, dtype=np.float32)[:, None]
            spec = np.zeros((length, f, tt), np.float32)
            for t in range(length):
                center = pos[t, 0] * 0.3 + 0.5
                band = np.exp(-((freqs - center) ** 2) / 0.01)
                spec[t] = band * np.linspace(0.5, 1.0, tt, dtype=np.float32)[None, :]
            data[name] = spec
        else:
            dim = shape[0]
            base = np.tile(pos[:, : min(2, dim)], (1, (dim + 1) // 2))[:, :dim]
            data[name] = base.astype(np.float32)

    actions = np.diff(pos, axis=0, prepend=pos[:1])
    actions = np.tile(actions, (1, (action_size + 1) // 2))[:, :action_size]
    data[action_name] = actions.astype(np.float32)
    data["reward"] = (1.0 - np.linalg.norm(pos, axis=1)).astype(np.float32)
    done = np.zeros(length, np.float32)
    done[-1] = 1.0
    data["done"] = done
    return data


def write_synthetic_dataset(
    out_dir: str,
    n_episodes: int,
    episode_length: int,
    observation_shapes: Mapping[str, Sequence[int]],
    action_name: str = "d_pose_quat_v2",
    action_size: int = 3,
    seed: int = 0,
) -> None:
    """Write episodes as ``.npy`` files the ingest path can load."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_episodes):
        ep = synthetic_episode(
            episode_length, observation_shapes, action_name, action_size,
            seed=seed + i,
        )
        np.save(os.path.join(out_dir, f"episode_{i:04d}.npy"), ep, allow_pickle=True)
