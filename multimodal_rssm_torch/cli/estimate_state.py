"""Offline state estimation over saved runs, on the GPU.

    python -m multimodal_rssm_torch.cli.estimate_state --targets DIR \\
        --itr N [--cwd .] [--device cuda|cpu]

Scans ``DIR`` for run folders (those holding ``hydra_config.yaml``, as the
port's train CLI writes them), loads each run's ``models_{N}`` checkpoint
(``.pt`` from the port's train CLI, else a reference ``.pth``, else a JAX
package ``.msgpack``), estimates the posterior
states of every episode of the run's train set and saves them as
``states_models_{N}.npy`` beside the checkpoint, keyed by episode file.
Runs on the GPU unless ``--device cpu``; without a GPU it raises.  Data
paths in the runs' configs are relative to ``--cwd``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence


def multi_run(targets_dir: str, itr: int, device: Optional[str] = None,
              cwd: str = ".") -> List[str]:
    """Estimate every run under ``targets_dir`` that has a ``models_{itr}``
    checkpoint; returns the saved files.  A run without one is skipped."""
    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.core.device import (configure_float32,
                                                   resolve_device)
    from multimodal_rssm_torch.eval.state_estimation import run
    from multimodal_rssm_torch.io.checkpoint import find_model_checkpoint

    dev = resolve_device(device)
    configure_float32()
    saved = []
    for folder in sorted(os.listdir(targets_dir)):
        run_dir = os.path.join(targets_dir, folder)
        if not os.path.isfile(os.path.join(run_dir, "hydra_config.yaml")):
            continue
        try:
            model_path = find_model_checkpoint(run_dir, itr)
        except FileNotFoundError as e:
            print(f"skip {run_dir}: {e}")
            continue
        cfg = load_run_config(run_dir)
        saved.append(run(cfg, cwd, model_path, dev))
        print(f"saved {saved[-1]}")
    return saved


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--targets", default="eval_targets",
                        help="directory of run folders")
    parser.add_argument("--itr", type=int, default=10_000)
    parser.add_argument("--cwd", default=".",
                        help="base of the runs' relative data paths")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    return multi_run(args.targets, args.itr, args.device, args.cwd)


if __name__ == "__main__":
    main()
