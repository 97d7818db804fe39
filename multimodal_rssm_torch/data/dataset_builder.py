"""Raw recordings -> training episodes (``.npy``), without PIL.

The port of the JAX package's ``data/dataset_builder.py``, the library form
of the reference's dataset notebook (dataset/COBOTTA/SingleHoleDrilling/
pick_data.ipynb): it turns per-episode recordings (camera frames larger
than the model's, sound spectrograms, raw poses) into the training schema:

- each camera frame resized to 256 / 128 / 64 px (``image_horizon_256``,
  ``image_horizon_128``, ``image_horizon`` and its alias
  ``image_horizon_64``);
- optional adaptive-threshold binary channels (``*_bin``);
- the pose channels of ``data/pose.preprocess_pose``;
- ``reward``, ``done`` with ``done[-1] = 1``, and the train / validation
  split.

The JAX package resizes with PIL's ``Image.BILINEAR``, which the card's
machine lacks.  ``resize_images`` computes the same thing in NumPy, bit for
bit on uint8 frames: PIL's separable resample (Pillow ``Resample.c``) with
the triangle filter widened by the scale factor on a downscale, its
coefficients normalised per output pixel in float64 and rounded to 22-bit
fixed point, a horizontal pass over the rows the vertical pass reads, each
pass rounded to uint8.  Each pass is a float64 matmul with a matrix of
those integer coefficients: every product and partial sum is an
integer below 2**53, so the sums are exact in any order.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np

from multimodal_rssm_torch.data.pose import preprocess_pose

_PRECISION_BITS = 32 - 8 - 2    # Pillow's fixed point for 8-bit images
_FRAMES = 8                     # frames a resize pass holds as float64


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def resample_coefficients(in_size: int, out_size: int
                          ) -> Tuple[np.ndarray, int, int]:
    """(a float64 [in_size, out_size] matrix of PIL's fixed-point bilinear
    coefficients, the first and one past the last input index any output
    reads): Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale          # the bilinear filter's support is 1
    matrix = np.zeros((in_size, out_size), np.float64)
    first, last = in_size, 0
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = [_bilinear((x + xmin - center + 0.5) / filterscale)
                   for x in range(xmax)]
        total = 0.0
        for w in weights:                # PIL's sum, in its order
            total += w
        for x, w in enumerate(weights):
            if total != 0.0:
                w /= total
            matrix[xmin + x, xx] = (int(-0.5 + w * (1 << _PRECISION_BITS))
                                    if w < 0 else
                                    int(0.5 + w * (1 << _PRECISION_BITS)))
        first, last = min(first, xmin), max(last, xmin + xmax)
    return matrix, first, last


def _round_pass(acc: np.ndarray) -> np.ndarray:
    """PIL's ``clip8``: (acc + half) >> PRECISION_BITS, clamped to uint8."""
    out = np.floor((acc + (1 << (_PRECISION_BITS - 1)))
                   / (1 << _PRECISION_BITS))
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_images(images: np.ndarray, size: int) -> np.ndarray:
    """Resize a [T, H, W, C] uint8 sequence to [T, size, size, C] exactly as
    PIL's ``Image.resize((size, size), Image.BILINEAR)`` does frame by
    frame (C = 1 as an "L" image, C = 3 as "RGB"); ``_FRAMES`` frames at a
    time, so float64 copies of only that many input frames are held."""
    images = np.asarray(images, np.uint8)
    T, H, W, C = images.shape
    rows, first, last = resample_coefficients(H, size)
    cols = resample_coefficients(W, size)[0] if W != size else None
    if cols is not None:   # PIL's horizontal pass reads only the rows used
        if H == size:
            first, last = 0, H
        rows = rows[first:last]
    rows = np.ascontiguousarray(rows.T)      # [size, h]: a BLAS operand
    out = np.empty((T, size, size, C), np.uint8)
    for t in range(0, T, _FRAMES):
        x = images[t:t + _FRAMES]
        x = np.array(x.transpose(0, 3, 1, 2), np.float64, order="C")
        if cols is not None:
            x = _round_pass(x[:, :, first:last] @ cols).astype(np.float64)
        if H != size:
            x = _round_pass(rows @ x)
        out[t:t + _FRAMES] = x.transpose(0, 2, 3, 1)
    return out


def adaptive_threshold(
    images: np.ndarray, block_size: int = 11, offset: float = 2.0
) -> np.ndarray:
    """Per-frame adaptive mean thresholding -> binary uint8 {0, 255}
    channel (the notebook uses cv2.adaptiveThreshold; this is the same
    local-mean variant via a uniform filter)."""
    from scipy.ndimage import uniform_filter

    gray = images.astype(np.float32)
    if gray.shape[-1] == 3:
        gray = gray @ np.asarray([0.299, 0.587, 0.114], np.float32)
    else:
        gray = gray[..., 0]
    out = np.empty((*gray.shape, 1), np.uint8)
    for t in range(gray.shape[0]):
        local_mean = uniform_filter(gray[t], size=block_size)
        out[t, ..., 0] = ((gray[t] > local_mean - offset) * 255).astype(np.uint8)
    return out


def build_episode(
    raw: Mapping[str, np.ndarray],
    image_key: str = "image",
    image_sizes: Sequence[int] = (64, 128, 256),
    binary: bool = False,
    camera_prefix: str = "image_horizon",
) -> Dict[str, np.ndarray]:
    """One raw recording -> training episode dict.

    ``raw`` must contain an image sequence (HWC uint8), optionally
    ``sound`` [T, 128, 20], ``pose_quat`` [T, >=3], ``servo_value``,
    ``reward``, ``done``.
    """
    episode: Dict[str, np.ndarray] = {}
    images = np.asarray(raw[image_key])
    if images.dtype != np.uint8:
        images = np.clip(images, 0, 255).astype(np.uint8)
    T = images.shape[0]

    for size in image_sizes:
        resized = resize_images(images, size)
        key = camera_prefix if size == 64 else f"{camera_prefix}_{size}"
        episode[key] = resized
        if size == 64:
            episode[f"{camera_prefix}_64"] = resized
        if binary:
            episode[f"{camera_prefix}_{size}_bin"] = adaptive_threshold(resized)

    if "sound" in raw:
        episode["sound"] = np.asarray(raw["sound"], np.float32)

    pose_data = {k: np.asarray(v, np.float32) for k, v in raw.items()
                 if k.startswith("pose") or k == "servo_value"}
    if pose_data:
        episode.update(preprocess_pose(pose_data))

    episode["reward"] = np.asarray(
        raw.get("reward", np.zeros(T)), np.float32
    )
    done = np.asarray(raw.get("done", np.zeros(T)), np.float32).copy()
    done[-1] = 1.0
    episode["done"] = done
    return episode


def build_dataset(
    raw_episodes: Iterable[Mapping[str, np.ndarray]],
    out_dir: str,
    validation_fraction: float = 0.2,
    **episode_kwargs,
) -> None:
    """Raw recordings -> ``{out_dir}/{train,validation}/episode_*.npy``."""
    episodes = [build_episode(r, **episode_kwargs) for r in raw_episodes]
    n_val = max(1, int(len(episodes) * validation_fraction)) if len(episodes) > 1 else 0
    splits = {"train": episodes[: len(episodes) - n_val],
              "validation": episodes[len(episodes) - n_val :]}
    for split, eps in splits.items():
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        for i, ep in enumerate(eps):
            np.save(os.path.join(d, f"episode_{i:04d}.npy"), ep,
                    allow_pickle=True)
