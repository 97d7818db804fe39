"""Host-side augmentation helpers (numpy): the reference's spiral crop
offsets, storage shapes with the crop margin, and the PCA colour fit
(utils/replay_buffer/data_augment.py).  The device half (crop, noise, PCA
shift, clip) runs in ``train/trainer.prepare_observations``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


# -- crop-offset spiral (host) -------------------------------------------


def get_dx(idx: int) -> int:
    """x-offset of the idx-th crop in the reference's outward spiral
    (ref :93-118).  Pure integer iteration, bit-exact."""
    num = 0
    count = 0
    next_num = 1
    for _ in range(idx):
        if num != next_num:
            num += 1 if next_num > 0 else -1
        else:
            if next_num > 0:
                if count < num * 2 - 1:
                    count += 1
                else:
                    next_num = -next_num
                    count = 0
                    num -= 1
            else:
                if count < (-num) * 2 + 1 - 1:
                    count += 1
                else:
                    next_num = -next_num + 1
                    count = 0
                    num += 1
    return -num


def get_dy(idx: int) -> int:
    """y-offset of the idx-th crop (ref :120-145)."""
    num = 0
    count = 0
    next_num = 0
    for _ in range(idx):
        if num != next_num:
            num += 1 if next_num > 0 else -1
        else:
            if next_num >= 0:
                if count < (num + 1) * 2 - 1:
                    count += 1
                else:
                    next_num = -next_num - 1
                    count = 0
                    num -= 1
            else:
                if count < (-num - 1) * 2 + 2:
                    count += 1
                else:
                    next_num = -next_num
                    count = 0
                    num += 1
    return num


def idx_to_offsets(
    idx: int,
    image_shape: Sequence[int],
    size: Sequence[int],
    dh_base: int,
    dw_base: int,
) -> Tuple[int, int]:
    """Crop index -> (dh, dw) pixel offsets (ref ``idx_to_idx_w_h`` +
    ``crop_image`` offset math, :147-174)."""
    dx = get_dx(idx)
    dy = get_dy(idx)
    xy_center = (np.array(image_shape[-2:]) - np.array(size)) / (dh_base, dw_base)
    x, y = np.floor(xy_center / 2)
    idx_w = int(x + dx)
    idx_h = int(y + dy)
    return dh_base * idx_h, dw_base * idx_w


def crop_size_for(name: str) -> Tuple[int, int]:
    """Target crop size by modality name (ref :183-194)."""
    if "_256" in name or "high_resolution" in name:
        return (256, 256)
    if "_128" in name:
        return (128, 128)
    return (64, 64)


def storage_image_shape(
    shape: Sequence[int], n_crop: Optional[int], dh_base=2, dw_base=2
) -> Tuple[int, ...]:
    """Image shape stored in the buffer: oversized by the crop margin
    (ref ``calc_image_shape``, memory.py:66-72).  Shape is (C, H, W)."""
    if n_crop is None:
        return tuple(shape)
    d, h, w = shape
    k = int(np.sqrt(n_crop - 1))
    return (d, int(h + k * dh_base), int(w + k * dw_base))


# -- PCA colour augmentation (host fit, device apply) ---------------------


def calc_params_of_pca(images: np.ndarray, dt: int = 100):
    """Eigen-decomposition of the pixel-channel covariance over every
    dt-th stored frame (ref data_augment.py:53-62).  ``images``: uint8
    [N, H, W, C] (HWC storage).  Returns (eigenvalues [C], eigenvectors
    [C, C]) as float32.
    """
    sub = images[::dt].astype(np.float32)
    flat = sub.reshape(-1, sub.shape[-1]).T  # [C, P]
    # torch.std is unbiased (ddof=1) — match the reference normalisation
    flat = (flat.T - flat.mean(axis=1)) / flat.std(axis=1, ddof=1)
    cov = np.cov(flat, rowvar=False)
    lambd, p = np.linalg.eigh(cov)
    return lambd.astype(np.float32), p.astype(np.float32)


def pca_delta(p_eigen_vectors, lambd_eigen_values, rand):
    """Colour shift delta broadcast over H, W (ref ``calc_delta``, :64-68)."""
    delta = p_eigen_vectors @ (rand * lambd_eigen_values)
    return delta * 255.0  # [C], broadcasts over [..., H, W, C]
