"""Analysis helpers: latent PCA and image de-normalisation.

Port of the JAX package's ``eval/visualize.py`` (reference
utils/evaluation/visualize_utils.py:7-40, check_model.ipynb cells 25-29).
The PCA is the port's own (centre, NumPy SVD, the leading right singular
vectors) with the attributes of ``sklearn.decomposition.PCA`` that the
analysis reads, so that nothing here needs scikit-learn.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

from multimodal_rssm_torch.ops.image import reverse_normalized_image


def reverse_image_observation(images, bit_depth: int = 5) -> np.ndarray:
    """Normalised float image -> uint8 (ref visualize_utils.py:19-21)."""
    if hasattr(images, "detach"):
        images = images.detach().cpu().numpy()
    return reverse_normalized_image(np.asarray(images), bit_depth)


class PCA:
    """Principal components of [N, D] features: ``components_`` [k, D]
    (unit rows, by decreasing variance), ``mean_`` [D],
    ``explained_variance_`` [k] (variance along each, over N - 1), and
    ``transform``.  A component's sign is the SVD's."""

    def __init__(self, n_components: int = 2):
        self.n_components = int(n_components)

    def fit(self, feat) -> "PCA":
        x = np.asarray(feat, np.float64)
        if x.ndim != 2 or not 1 <= self.n_components <= min(x.shape):
            raise ValueError(f"{self.n_components} components of features "
                             f"{x.shape}")
        self.mean_ = x.mean(0)
        _, sv, vt = np.linalg.svd(x - self.mean_, full_matrices=False)
        k = self.n_components
        self.components_ = vt[:k]
        self.explained_variance_ = sv[:k] ** 2 / max(x.shape[0] - 1, 1)
        return self

    def transform(self, feat) -> np.ndarray:
        return (np.asarray(feat, np.float64) - self.mean_) @ self.components_.T


def get_pca_model(feat, n_components: int = 2) -> PCA:
    """PCA fitted on [N, D] latent features (ref :34-40)."""
    return PCA(n_components).fit(feat)


def pca_trajectories(states_per_episode: Iterable, n_components: int = 2
                     ) -> Tuple[PCA, List[np.ndarray]]:
    """One PCA over every episode's latents, then each episode projected:
    the notebook's latent-trajectory plot data."""
    episodes = [np.asarray(s) for s in states_per_episode]
    stacked = np.concatenate([s.reshape(-1, s.shape[-1]) for s in episodes], 0)
    pca = get_pca_model(stacked, n_components)
    return pca, [pca.transform(s.reshape(-1, stacked.shape[-1]))
                 for s in episodes]
