"""Episode ``.npy`` ingestion.

Replicates the reference's dataset schema and load-time preprocessing
(utils/replay_buffer/memory.py:13-107): each ``.npy`` file is one episode —
a pickled dict of per-step arrays keyed by modality name plus ``done``,
``reward`` and action channels.

Images are stored and fed as HWC uint8, as in the JAX package (the
reference transposes to CHW, memory.py:52-53); configured
observation_shapes remain (C, H, W).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_rssm_torch.data.augment import idx_to_offsets
from multimodal_rssm_torch.ops.image import reverse_normalized_image


def clip_episode(data: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], int]:
    """Align all modalities to the minimum episode length (ref
    memory.py:35-45; the ``seed`` key is metadata, not a sequence)."""
    lengths = [len(v) for k, v in data.items() if k != "seed"]
    episode_length = int(np.min(lengths))
    out = {k: v[:episode_length] for k, v in data.items() if k != "seed"}
    return out, episode_length


def preprocess_data(data: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], int]:
    """Normalise an episode dict for buffering (ref memory.py:48-63):

    - clip to the minimum modality length;
    - images to HWC uint8 (reference uses CHW; deviation documented above);
    - rename ``image`` -> ``image_{N}`` for non-64px images (ref :57-60);
    - ``nonterminals = 1 - done[:, None]`` (ref :62).
    """
    data, episode_length = clip_episode(data)

    for name in list(data.keys()):
        if "image" in name:
            arr = data[name]
            # CHW -> HWC when channel-first (ref detects HWC via
            # shape[1] > shape[3] and transposes the other way).
            if arr.shape[1] < arr.shape[3]:
                arr = arr.transpose(0, 2, 3, 1)
            if arr.dtype != np.uint8:
                arr = reverse_normalized_image(arr)
            data[name] = arr

    if "image" in data:
        image_hw = data["image"].shape[1]
        if image_hw != 64:
            data[f"image_{image_hw}"] = data.pop("image")

    data["nonterminals"] = 1.0 - np.expand_dims(
        np.asarray(data["done"], np.float32), -1
    )
    return data, episode_length


def crop_image_host(
    image: np.ndarray, idx: int, size: Tuple[int, int], dh_base: int, dw_base: int
) -> np.ndarray:
    """Host-side crop (ref ``crop_image``, data_augment.py:162-174) on HWC
    sequences [N, H, W, C]."""
    dh, dw = idx_to_offsets(idx, image.shape[1:3], size, dh_base, dw_base)
    return image[:, dh : size[0] + dh, dw : size[1] + dw]


def crop_image_data(
    data: Dict[str, np.ndarray],
    n_crop: Optional[int],
    dh_base: Optional[int],
    dw_base: Optional[int],
) -> Dict[str, np.ndarray]:
    """Load-time margin crop to the oversized storage shape (ref
    ``crop_image_data``, data_augment.py:214-231)."""
    if n_crop is None:
        return data
    k = int(np.sqrt(n_crop - 1))
    for name in data:
        if "image" in name:
            if "_256" in name or "high_resolution" in name:
                base = 256
            elif "_128" in name:
                base = 128
            else:
                base = 64
            data[name] = crop_image_host(
                data[name], 0, (base + k * dh_base, base + k * dw_base),
                dh_base, dw_base,
            )
    return data


def get_data(
    file_name: str,
    n_crop: Optional[int] = 1,
    dh_base: Optional[int] = 1,
    dw_base: Optional[int] = 1,
    encoding: str = "ASCII",
) -> Tuple[Dict[str, np.ndarray], int]:
    """Load one episode file (ref ``get_data``, memory.py:90-107), with the
    byte-key decode path for latin1-pickled files."""
    raw = np.load(file_name, allow_pickle=True, encoding=encoding).item()
    if encoding != "ASCII":
        raw = {
            (k.decode("utf-8") if isinstance(k, bytes) else k): v
            for k, v in raw.items()
        }
    data, episode_length = preprocess_data(raw)
    data = crop_image_data(data, n_crop, dh_base, dw_base)
    return data, episode_length


def get_file_names(dataset_dir: str) -> List[str]:
    """All episode files in a directory (ref memory.py:85-87)."""
    return sorted(glob.glob(os.path.join(dataset_dir, "*.npy")))
