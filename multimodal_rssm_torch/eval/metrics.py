"""Image / video quality metrics: PSNR and SSIM.

Port of the JAX package's ``eval/metrics.py``.  Inputs are normalised
observations in the training range (the bit-depth normalise maps images to
[-0.5, 0.5]), so the dynamic range is 1.0.  Arrays are [..., H, W, C];
leading axes (time, batch) are averaged.  float32, on the inputs' device.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F


def psnr(pred, target, max_val: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole array (0-d)."""
    pred, target = torch.as_tensor(pred), torch.as_tensor(target)
    mse = torch.mean(torch.square(pred.float() - target.float()))
    return 10.0 * torch.log10((max_val * max_val) / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, win: int) -> torch.Tensor:
    """VALID ``win`` x ``win`` mean over the spatial axes of [N, C, H, W]."""
    return F.avg_pool2d(x, win, stride=1)


def ssim(pred, target, max_val: float = 1.0, win: int = 7, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean structural similarity (Wang et al. 2004) with a uniform
    ``win`` x ``win`` window, over all windows, channels and frames (0-d).

    pred / target: [..., H, W, C] in the zero-centred training range
    [-max_val / 2, max_val / 2].  They are shifted to [0, max_val] first:
    the luminance term assumes data anchored at 0 (tf.image.ssim takes only
    non-negative inputs), and the shift leaves the variances and the
    covariance unchanged."""
    p = torch.as_tensor(pred).float() + max_val / 2.0
    t = torch.as_tensor(target).float() + max_val / 2.0
    H, W, C = p.shape[-3:]
    if min(H, W) < win:
        raise ValueError(f"image {H}x{W} smaller than SSIM window {win}")
    p = p.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    t = t.reshape(-1, H, W, C).permute(0, 3, 1, 2)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_p = _uniform_filter(p, win)
    mu_t = _uniform_filter(t, win)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    # biased (uniform-window) moments, as tf.image.ssim
    var_p = _uniform_filter(p * p, win) - mu_pp
    var_t = _uniform_filter(t * t, win) - mu_tt
    cov = _uniform_filter(p * t, win) - mu_pt
    num = (2.0 * mu_pt + c1) * (2.0 * cov + c2)
    den = (mu_pp + mu_tt + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def video_prediction_metrics(
        preds: Mapping[str, Mapping[str, torch.Tensor]],
        targets: Mapping[str, torch.Tensor], t_start: int, horizon: int
) -> Dict[str, Dict[str, float]]:
    """Per-modality {mse, psnr[, ssim]} of the imagined means against the
    targets of the imagination window.  SSIM only for image-shaped
    [T, B, H, W, C] modalities with 1 or 3 channels and sides >= 7."""
    out: Dict[str, Dict[str, float]] = {}
    for name, pred in preds.items():
        gt = targets[name][t_start + 1: t_start + 1 + horizon]
        p = pred["loc"]
        row = {"mse": float(torch.mean(torch.square(p - gt))),
               "psnr": float(psnr(p, gt))}
        if p.ndim == 5 and p.shape[-1] in (1, 3) and min(p.shape[-3:-1]) >= 7:
            row["ssim"] = float(ssim(p, gt))
        out[name] = row
    return out
