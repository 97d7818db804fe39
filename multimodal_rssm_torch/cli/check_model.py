"""Model analysis artifacts of a trained run, on the GPU (the reference's
``check_model.ipynb`` as a command):

- one episode's posterior reconstruction against its observations (image
  grids; notebook cells 33-36);
- PCA trajectories of every episode's beliefs and posterior means (cells
  25-29);
- per-expert posterior distributions and every expert subset's PoE (cells
  39-48): means and std devs of a Gaussian latent, logits of a categorical
  one; none for the unimodal RSSM, which has no experts;
- open-loop imagination from ``--t-start`` over ``--horizon`` steps, with
  its MSE, PSNR and SSIM against the observations (cells 55-58).

    python -m multimodal_rssm_torch.cli.check_model --run RUN_DIR --itr N \\
        [--episode 0] [--t-start 20] [--horizon 20] [--cwd .] \\
        [--device cuda|cpu]

``RUN_DIR`` is a run of the port's train CLI (``hydra_config.yaml`` and
``models_{N}.pt``, or a reference ``models_{N}.pth``, or a JAX package
``models_{N}.msgpack``).  Outputs go to
``RUN_DIR/analysis/``: ``reconstruction_<image>`` and ``imagination_<image>``
grids (``.png`` with PIL, else ``.npy``), ``pca_beliefs.npy``,
``pca_posterior_means.npy``, ``expert_distributions.npy``,
``imagination_mse.json``, and with matplotlib ``pca_latents.png`` and
``expert_distributions.png``.  Runs on the GPU unless ``--device cpu``;
without a GPU it raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Write the artifacts; returns the analysis dir, the imagination
    window and its metrics, and the files written."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run", required=True)
    parser.add_argument("--itr", type=int, default=10_000)
    parser.add_argument("--episode", type=int, default=0)
    parser.add_argument("--t-start", type=int, default=20)
    parser.add_argument("--horizon", type=int, default=20)
    parser.add_argument("--cwd", default=".",
                        help="base of the run's relative data paths")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.core.device import (configure_float32,
                                                   resolve_device)
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.eval import imagination, visualize
    from multimodal_rssm_torch.eval import metrics as metrics_lib
    from multimodal_rssm_torch.eval import state_estimation as se
    from multimodal_rssm_torch.io.checkpoint import find_model_checkpoint
    from multimodal_rssm_torch.train import trainer as tr

    dev = resolve_device(args.device)
    configure_float32()
    cfg = load_run_config(args.run)
    model = se.load_eval_model(cfg, find_model_checkpoint(args.run, args.itr),
                               dev)
    out_dir = os.path.join(args.run, "analysis")
    os.makedirs(out_dir, exist_ok=True)
    D = build_buffer(cfg)
    load_dataset(args.cwd, D, cfg.train.train_data_path)
    spec = tr.build_aug_spec(D)
    bit_depth = int(cfg.env.bit_depth)
    generator = torch.Generator(dev).manual_seed(0)

    # -- one episode's det posterior ------------------------------------
    obs, actions, _, nonterm = se.get_episode_data(
        D, args.episode, spec, se.fixed_draws(D, spec), bit_depth, generator,
        dev)
    obs_target = {k: v[1:] for k, v in obs.items()}
    actions_in = actions[:-1]
    with torch.no_grad():
        states = model.estimate_state(obs_target, actions_in, nonterm[:-1])

    # -- reconstruction grid --------------------------------------------
    recon = imagination.reconstruct(model, states)
    _save_image_grids(out_dir, "reconstruction", recon, obs_target, bit_depth)

    # -- PCA of every episode's latents (one basis over all of them) -----
    epi_beliefs, epi_post = [], []
    for epi in range(D.episodes):
        s_e = (states if epi == args.episode else se.estimate_episode(
            model, D, epi, spec, bit_depth, generator, det=True))
        epi_beliefs.append(s_e["beliefs"][:, 0].cpu().numpy())
        epi_post.append(s_e["posterior_means"][:, 0].cpu().numpy())
    n_comp = 3 if epi_beliefs[0].shape[0] >= 3 else 2
    _, proj_b = visualize.pca_trajectories(epi_beliefs, n_comp)
    _, proj_s = visualize.pca_trajectories(epi_post, n_comp)
    for name, proj in (("pca_beliefs", proj_b), ("pca_posterior_means", proj_s)):
        blob = np.empty(len(proj), dtype=object)
        blob[:] = proj
        np.save(os.path.join(out_dir, f"{name}.npy"), blob, allow_pickle=True)
    _plot_pca(out_dir, proj_b, proj_s)

    # -- expert distributions ---------------------------------------------
    if model.multimodal:
        _save_expert_artifacts(out_dir, states)

    # -- open-loop imagination --------------------------------------------
    t_start = min(args.t_start, actions_in.shape[0] - 2)
    horizon = min(args.horizon, actions_in.shape[0] - t_start - 1)
    _, preds = imagination.imagine(model, states, actions_in, t_start, horizon,
                                   det=True)
    mse = imagination.video_prediction_mse(preds, obs_target, t_start, horizon)
    quality = metrics_lib.video_prediction_metrics(preds, obs_target, t_start,
                                                   horizon)
    with open(os.path.join(out_dir, "imagination_mse.json"), "w") as f:
        json.dump({"t_start": t_start, "horizon": horizon, "mse": mse,
                   "metrics": quality}, f, indent=2)
    gt_window = {k: v[t_start + 1: t_start + 1 + horizon]
                 for k, v in obs_target.items()}
    _save_image_grids(out_dir, "imagination", preds, gt_window, bit_depth)
    print(f"analysis artifacts in {out_dir}; imagination MSE: {mse}; "
          f"metrics: {quality}")
    return {"out_dir": out_dir, "t_start": t_start, "horizon": horizon,
            "mse": mse, "metrics": quality,
            "files": sorted(os.listdir(out_dir))}


def _save_image_grids(out_dir: str, tag: str, preds, targets, bit_depth: int,
                      max_frames: int = 8) -> None:
    """Per image modality: up to ``max_frames`` frames of batch entry 0,
    observations above predictions, as uint8 ``{tag}_{name}.png`` (PIL) or
    ``.npy``."""
    from multimodal_rssm_torch.eval.visualize import reverse_image_observation

    for name, pred in preds.items():
        if "image" not in name:
            continue
        loc = pred["loc"][:, 0]     # [T, H, W, C]
        gt = targets[name][:, 0]
        step = max(1, loc.shape[0] // max_frames)
        sel = slice(0, max_frames * step, step)
        row_pred = np.concatenate(
            list(reverse_image_observation(loc[sel], bit_depth)), axis=1)
        row_gt = np.concatenate(
            list(reverse_image_observation(gt[sel], bit_depth)), axis=1)
        grid = np.concatenate([row_gt, row_pred], axis=0)
        try:
            from PIL import Image
        except ImportError:
            np.save(os.path.join(out_dir, f"{tag}_{name}.npy"), grid)
            continue
        if grid.shape[-1] == 1:
            grid = grid[..., 0]
        Image.fromarray(grid).save(os.path.join(out_dir, f"{tag}_{name}.png"))


def _plot_pca(out_dir: str, proj_beliefs, proj_states) -> None:
    """Per-episode latent trajectories in the shared PCA basis (one line
    per episode, 3-D when there are 3 components); skipped without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    three_d = proj_beliefs[0].shape[1] >= 3
    fig = plt.figure(figsize=(12, 6))
    for i, (projs, title) in enumerate(((proj_beliefs, "beliefs"),
                                        (proj_states, "posterior means"))):
        ax = fig.add_subplot(1, 2, i + 1, projection="3d" if three_d else None)
        for proj in projs:
            ax.plot(*(proj[:, d] for d in range(3 if three_d else 2)),
                    alpha=0.4)
        ax.set_title(f"PCA of {title} ({len(projs)} episodes)")
    fig.savefig(os.path.join(out_dir, "pca_latents.png"), dpi=120)
    plt.close(fig)


def _save_expert_artifacts(out_dir: str, states) -> None:
    """Per-expert posterior (mean, std) series of batch entry 0 and every
    expert subset's PoE, to ``expert_distributions.npy``; with matplotlib
    also mean +- std bands of the first four state dimensions.  For a
    categorical latent: the experts' and the subset products' logits
    [T, V, K]."""
    from multimodal_rssm_torch.ops import categorical, fusion

    def host(x):
        return torch.as_tensor(x)[:, 0].cpu().numpy()

    if "expert_logits" in states:
        subsets = categorical.subset_poe_logits(   # experts first
            torch.as_tensor(states["expert_logits_stacked"]).movedim(1, 0))
        np.save(os.path.join(out_dir, "expert_distributions.npy"),
                {"expert_logits": {k: host(v) for k, v in
                                   states["expert_logits"].items()},
                 "subset_logits": [host(lg) for lg in subsets]},
                allow_pickle=True)
        return
    expert_means = {k: host(v) for k, v in states["expert_means"].items()}
    expert_stds = {k: host(v) for k, v in states["expert_std_devs"].items()}
    sub_m, sub_s = fusion.subset_poe_states(   # experts first: [K, T, B, S]
        torch.as_tensor(states["expert_means_stacked"]).movedim(1, 0),
        torch.as_tensor(states["expert_std_devs_stacked"]).movedim(1, 0))
    np.save(os.path.join(out_dir, "expert_distributions.npy"),
            {"expert_means": expert_means, "expert_std_devs": expert_stds,
             "subset_means": [host(m) for m in sub_m],
             "subset_std_devs": [host(s) for s in sub_s]},
            allow_pickle=True)
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dims = min(4, next(iter(expert_means.values())).shape[-1])
    fig, axes = plt.subplots(dims, 1, figsize=(10, 2.5 * dims), squeeze=False)
    for d in range(dims):
        ax = axes[d][0]
        for name in expert_means:
            m, s = expert_means[name][:, d], expert_stds[name][:, d]
            t = np.arange(len(m))
            (line,) = ax.plot(t, m, label=name)
            ax.fill_between(t, m - s, m + s, alpha=0.15,
                            color=line.get_color())
        ax.set_ylabel(f"s[{d}]")
    axes[0][0].legend(loc="upper right", fontsize=8)
    axes[-1][0].set_xlabel("t")
    fig.suptitle("per-expert posterior mean ± std")
    fig.savefig(os.path.join(out_dir, "expert_distributions.png"), dpi=120)
    plt.close(fig)


if __name__ == "__main__":
    main()
