"""Export a trained run to frozen ``torch.export`` serving artifacts.

    python -m multimodal_rssm_torch.cli.export_model --run-dir RUN_DIR \\
        [--out DIR] [--batch-size 1] [--plan] [--device cuda|cpu] \\
        [dotted.overrides ...]

The port's copy of the JAX package's ``export_model`` CLI: self-contained
``.pt2`` artifacts with the weights baked in (``io/export.py``), which
``cli/serve.py`` serves with no model code:

- ``filter_step.pt2``: raw frame -> posterior update (streaming state
  estimation for a controller / logger);
- ``decode.pt2``: (belief, state) -> per-modality reconstructions;
- ``agent_step.pt2``: raw frame -> posterior update -> the actor's
  mode-seeking action, when ``RUN_DIR/behavior/`` holds a checkpoint
  (``cli/train_behavior.py`` or ``cli/train_online.py``);
- ``plan_step.pt2`` (``--plan``): raw frame -> posterior update -> the
  CEM-planned action (``train/planner.py``; world-model weights only,
  ``planner.*`` overrides baked in).  Refused (``ValueError``) unless the
  run trained its reward head (``rssm.predict_reward``; pass
  ``rssm.predict_reward=true`` to override).

The world model's weights come from the run's newest ``models_*.pt``,
``.pth`` (the reference's) or ``.msgpack`` (the JAX package's).  The
artifacts run on the device they were exported on, ``--device`` (default
``cuda``; without a GPU it raises).  The world model computes in float32
whatever ``train.use_amp`` says, as the JAX package's ``export_model``
builds it (``WorldModel.from_config(cfg)``, no dtype); the meta says
``"compute_dtype": "float32"``.  Prints one JSON line {name: {path,
bytes}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

from multimodal_rssm_torch.cli import command


@command
def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--out", default=None,
                        help="output dir (default: <run-dir>/exported)")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--plan", action="store_true",
                        help="also export plan_step (CEM planning "
                             "controller; no behavior checkpoint needed)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.core.config import (
        apply_overrides, load_run_config)
    from multimodal_rssm_torch.core.device import (
        configure_float32, resolve_device)
    from multimodal_rssm_torch.eval.state_estimation import load_eval_model
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.io import export as ex
    from multimodal_rssm_torch.train import behavior as bh
    from multimodal_rssm_torch.train.planner import check_reward_head_trained

    dev = resolve_device(args.device)
    configure_float32()
    cfg = apply_overrides(load_run_config(args.run_dir), args.overrides)
    if args.plan:
        check_reward_head_trained(cfg, "--plan (plan_step export)")
    wm_path = ckpt.latest_checkpoint(args.run_dir, ckpt.MODEL_SUFFIXES)
    if wm_path is None:
        raise FileNotFoundError(
            f"no models_*.pt, .pth or .msgpack in {args.run_dir}")
    print(f"world model: {wm_path}", file=sys.stderr)
    model = load_eval_model(cfg, wm_path, dev)    # float32, as the JAX CLI

    actor = None
    bh_path = ckpt.latest_checkpoint(os.path.join(args.run_dir, "behavior"))
    if bh_path is not None:
        print(f"actor/value: {bh_path}", file=sys.stderr)
        bh.behavior_cfg(cfg)
        bstate = bh.init_behavior_state(cfg, dev)
        ckpt.load_behavior_checkpoint(bh_path, bstate)
        actor = bstate.actor
    else:
        print("no behavior/ checkpoint: skipping agent_step export",
              file=sys.stderr)

    out_dir = args.out or os.path.join(args.run_dir, "exported")
    written = ex.export_run(cfg, model, out_dir, args.batch_size, actor,
                            args.plan)
    result = {k: {"path": v, "bytes": os.path.getsize(v)}
              for k, v in written.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
