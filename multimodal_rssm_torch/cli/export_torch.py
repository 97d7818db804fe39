"""Export a trained run to a PyTorch reference checkpoint.

    python -m multimodal_rssm_torch.cli.export_torch --run-dir RUN_DIR \\
        [--itr 10000] [--out models_10000.pth] [dotted overrides ...]

The port of the JAX package's ``export_torch`` CLI, with its arguments: it
reads a run's ``models_{itr}`` checkpoint, a port ``models_{itr}.pt``, a
reference ``.pth`` or a JAX package ``models_{itr}.msgpack`` (``--itr``;
default the newest ``.pt`` or ``.msgpack``), and writes the reference's
saved state-dict schema (``io/torch_export.py``) to ``--out`` (default
``RUN_DIR/torch_export/models_{itr}.pth``), which the reference's own
tooling and ``train.model_path`` load.  Multimodal runs get the nested
schema with a fresh ``model_optimizer`` entry at the run's
``rssm.adam_epsilon`` and learning rate (0 under a warm-up schedule, as the
reference's optimizer is built); unimodal runs the flat schema.  A layout
transform on the host: it touches no device.
"""

import argparse
import os
import sys

from multimodal_rssm_torch.cli import command


@command
def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--run-dir", required=True)
    parser.add_argument("--itr", type=int, default=None,
                        help="checkpoint iteration (default: latest)")
    parser.add_argument("--out", default=None,
                        help="output .pth path (default: "
                             "<run-dir>/torch_export/models_{itr}.pth)")
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.core.config import apply_overrides, load_run_config
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.io.torch_export import save_reference_checkpoint
    from multimodal_rssm_torch.models.world_model import WorldModel

    cfg = apply_overrides(load_run_config(args.run_dir), args.overrides)
    if args.itr is not None:
        path = ckpt.find_model_checkpoint(args.run_dir, args.itr)
    else:
        path = ckpt.latest_checkpoint(args.run_dir)
        if path is None:
            raise FileNotFoundError(
                f"no models_*.pt or .msgpack in {args.run_dir}")
    print(f"checkpoint: {path}", file=sys.stderr)

    model = WorldModel.from_config(cfg)
    ckpt.load_model_weights(path, model)
    itr = os.path.basename(path).split(".")[0][len("models_"):]
    out = args.out
    if out is None:
        out_dir = os.path.join(args.run_dir, "torch_export")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"models_{itr}.pth")
    lr = (0.0 if int(cfg.rssm.learning_rate_schedule or 0) != 0
          else float(cfg.rssm.model_learning_rate))
    save_reference_checkpoint(out, model, lr=lr,
                              eps=float(cfg.rssm.adam_epsilon))
    print(out)
    return out


if __name__ == "__main__":
    main()
