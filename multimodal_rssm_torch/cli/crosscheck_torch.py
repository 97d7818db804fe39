"""Cross-check a run against the PyTorch reference implementation.

    python -m multimodal_rssm_torch.cli.crosscheck_torch --run-dir RUN_DIR \\
        [--itr 10000] [--episode 0] [--t-start 20] [--horizon 20] \\
        [--reference PATH] [--device cuda|cpu]

The port of the JAX package's ``crosscheck_torch`` CLI:

1. load the run's ``models_{itr}`` (a port ``.pt``, a reference ``.pth``
   or a JAX package ``.msgpack``) into the port's model;
2. export it to ``RUN_DIR/torch_export/models_{itr}.pth`` unless the run has
   one (``io/torch_export.py``);
3. build the reference's own algo (``build_RSSM``, algos/MRSSM/MRSSM/
   algo.py:6-18) from the checkout at ``--reference`` and load the ``.pth``
   through its ``load_model`` (base/algo.py:51-54);
4. feed both the same prepared episode (the port's deterministic eval
   pipeline, copied to the reference on the CPU);
5. compare the deterministic posterior (beliefs, posterior means: max
   |diff|), open-loop imagination (per-modality MSE between the two
   models' frames) and each model's imagination MSE against the episode.

It writes ``RUN_DIR/analysis/crosscheck_torch.json`` and exits 1 when the
two disagree beyond ``--latent-tol`` / ``--frame-tol``.  It needs the
reference checkout, which is not part of this repository: without it, it
exits with the JAX CLI's message.  The port's side runs on the GPU unless
``--device cpu``; the reference's on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from multimodal_rssm_torch.cli import command


def require_reference(path: str) -> None:
    """Put the reference checkout on ``sys.path``; exit with the JAX CLI's
    message when it is absent.  Its algo modules import wandb at module
    scope (base/algo.py:9), which a run with ``main.wandb`` false never
    uses: an empty module stands in where wandb is not installed."""
    if not os.path.isdir(path):
        raise SystemExit(f"reference checkout not found at {path} "
                         "(--reference)")
    if path not in sys.path:
        sys.path.insert(0, path)
    if "wandb" not in sys.modules:
        sys.modules["wandb"] = types.ModuleType("wandb")


def to_channels_first(arr: np.ndarray) -> np.ndarray:
    """[T, B, H, W, C] -> [T, B, C, H, W] (the reference's image layout);
    other arrays as they are."""
    return arr.transpose(0, 1, 4, 2, 3) if arr.ndim == 5 else arr


def compare(ours_states: Mapping[str, np.ndarray],
            ref_states: Mapping[str, np.ndarray],
            ours_preds: Mapping[str, np.ndarray],
            ref_preds: Mapping[str, np.ndarray],
            targets: Mapping[str, np.ndarray], t_start: int, horizon: int,
            ours_mse: Mapping[str, float]) -> Dict:
    """The comparison the JAX CLI writes: max |ours - reference| of the
    beliefs and posterior means; per modality the reference's imagination
    MSE against the episode's frames t_start + 1 ... t_start + horizon and
    the MSE between the two models' imagined frames.  Predictions and
    targets are channels-last; the reference's are channels-first."""
    result = {
        "latent_max_abs_diff": {
            k: float(np.max(np.abs(np.asarray(ours_states[k])
                                   - np.asarray(ref_states[k]))))
            for k in ("beliefs", "posterior_means")},
        "imagination_mse_vs_gt": {"ours": dict(ours_mse), "torch": {}},
        "imagination_cross_framework_mse": {},
    }
    for name, loc in ref_preds.items():
        loc = np.asarray(loc)
        gt = to_channels_first(np.asarray(
            targets[name][t_start + 1:t_start + 1 + horizon]))
        ours = to_channels_first(np.asarray(ours_preds[name]))
        result["imagination_mse_vs_gt"]["torch"][name] = float(
            np.mean(np.square(loc - gt)))
        result["imagination_cross_framework_mse"][name] = float(
            np.mean(np.square(loc - ours)))
    return result


def verdict(result: Mapping, latent_tol: float, frame_tol: float
            ) -> Tuple[bool, str]:
    """(within both tolerances, a one-line summary)."""
    worst_latent = max(result["latent_max_abs_diff"].values())
    worst_frame = max(result["imagination_cross_framework_mse"].values())
    ok = worst_latent <= latent_tol and worst_frame <= frame_tol
    return ok, (f"{'crosscheck OK' if ok else 'MISMATCH'}: latent "
                f"{worst_latent:.2e} (tol {latent_tol}) / frame MSE "
                f"{worst_frame:.2e} (tol {frame_tol})")


@command
def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--itr", type=int, default=10_000)
    parser.add_argument("--episode", type=int, default=0)
    parser.add_argument("--t-start", type=int, default=20)
    parser.add_argument("--horizon", type=int, default=20)
    parser.add_argument("--cwd", default=".")
    parser.add_argument("--reference", default="reference",
                        help="the reference implementation's checkout")
    parser.add_argument("--latent-tol", type=float, default=5e-3,
                        help="max |ours - torch| over beliefs / posterior "
                             "means")
    parser.add_argument("--frame-tol", type=float, default=1e-4,
                        help="max per-modality MSE between the two models' "
                             "imagined frames")
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)

    import copy

    import torch

    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.core.device import configure_float32, resolve_device
    from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
    from multimodal_rssm_torch.eval import imagination
    from multimodal_rssm_torch.eval import state_estimation as se
    from multimodal_rssm_torch.io.checkpoint import find_model_checkpoint
    from multimodal_rssm_torch.io.torch_export import save_reference_checkpoint
    from multimodal_rssm_torch.train import trainer as tr

    dev = resolve_device(args.device)
    configure_float32()
    cfg = load_run_config(args.run_dir)
    cfg.main.wandb = False
    model = se.load_eval_model(
        cfg, find_model_checkpoint(args.run_dir, args.itr), dev)
    D = build_buffer(cfg)
    load_dataset(args.cwd, D, cfg.train.train_data_path)
    spec = tr.build_aug_spec(D)
    generator = torch.Generator(dev).manual_seed(0)

    # -- the shared inputs: the port's deterministic eval preprocessing ---
    obs, actions, rewards, nonterm = se.get_episode_data(
        D, args.episode, spec, se.fixed_draws(D, spec), int(cfg.env.bit_depth),
        generator, dev)
    obs_target = {k: v[1:] for k, v in obs.items()}
    actions_in, nonterm_in = actions[:-1], nonterm[:-1]
    T = actions_in.shape[0]
    t_start = min(args.t_start, T - 2)
    horizon = min(args.horizon, T - t_start - 1)

    # -- ours ---------------------------------------------------------------
    with torch.no_grad():
        states = model.estimate_state(obs_target, actions_in, nonterm_in)
        _, preds = imagination.imagine(model, states, actions_in, t_start,
                                       horizon, det=True)
    ours_mse = imagination.video_prediction_mse(preds, obs_target, t_start,
                                                horizon)

    # -- export (the run's torch_export if present) --------------------------
    pth = os.path.join(args.run_dir, "torch_export", f"models_{args.itr}.pth")
    if not os.path.exists(pth):
        os.makedirs(os.path.dirname(pth), exist_ok=True)
        lr = (0.0 if int(cfg.rssm.learning_rate_schedule or 0) != 0
              else float(cfg.rssm.model_learning_rate))
        save_reference_checkpoint(pth, model, lr=lr,
                                  eps=float(cfg.rssm.adam_epsilon))
        print(f"exported {pth}", file=sys.stderr)

    # -- the reference --------------------------------------------------------
    require_reference(args.reference)
    from algos.MRSSM.MRSSM.algo import build_RSSM

    ref_cfg = copy.deepcopy(cfg)
    ref_cfg.main.device = "cpu"
    ref_cfg.train.use_amp = False
    torch.manual_seed(0)
    ref = build_RSSM(ref_cfg, torch.device("cpu"))
    ref.load_model(pth)
    ref.eval()

    def host(v):
        return torch.tensor(to_channels_first(v.detach().cpu().numpy()))

    with torch.no_grad():
        ref_states = ref.estimate_state(
            {k: host(v) for k, v in obs_target.items()}, host(actions_in),
            host(rewards), host(nonterm_in), det=True)
        # open-loop imagination with eval/imagination.imagine's indexing
        h = ref_states["beliefs"][t_start]
        s = ref_states["posterior_means"][t_start]
        hs, ss = [], []
        for t in range(horizon):
            a = host(actions_in[t_start + 1 + t]).unsqueeze(0)
            outs = ref.transition_model(s, a, h, det=True)
            h, s = outs[0].squeeze(0), outs[2].squeeze(0)
            hs.append(h)
            ss.append(s)
        ref_preds = ref.observation_model(h_t=torch.stack(hs),
                                          s_t=torch.stack(ss))
    if not bool(cfg.rssm.multimodal):
        # the unimodal reference's one decoder returns {"loc": ...}
        ref_preds = {str(cfg.rssm.observation_names_rec[0]): ref_preds}

    result = {"run_dir": args.run_dir, "itr": args.itr,
              "episode": args.episode, "t_start": t_start,
              "horizon": horizon,
              **compare({k: states[k].cpu().numpy()
                         for k in ("beliefs", "posterior_means")},
                        {k: ref_states[k].numpy()
                         for k in ("beliefs", "posterior_means")},
                        {k: v["loc"].cpu().numpy() for k, v in preds.items()},
                        {k: v["loc"].numpy() for k, v in ref_preds.items()},
                        {k: v.cpu().numpy() for k, v in obs_target.items()},
                        t_start, horizon, ours_mse)}
    out_dir = os.path.join(args.run_dir, "analysis")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "crosscheck_torch.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    ok, line = verdict(result, args.latent_tol, args.frame_tol)
    print(f"{line} -> {out_path}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
