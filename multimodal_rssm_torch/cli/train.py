"""World-model training entry point of the PyTorch port.

    python -m multimodal_rssm_torch.cli.train [dotted.overrides ...] \\
        [--device cuda|cpu] [--cwd DIR]

Composes the config from the package's ``configs/`` (hydra-style dotted
overrides, e.g. ``train.batch_size=32 train.pallas_normalize=true``) and
trains on the GPU; ``--device cpu`` runs on the CPU instead.  Without a
GPU and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from multimodal_rssm_torch.core.config import compose


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    parser.add_argument("--config-dir", default=None,
                        help="config tree (default: the packaged configs/)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cwd", default=".",
                        help="base of relative data paths and of results/")
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.train.loop import run

    cfg = compose(args.config_dir, overrides=args.overrides)
    result = run(cfg, cwd=args.cwd, device=args.device)
    print(f"run dir: {result['results_dir']}")
    return result


if __name__ == "__main__":
    main()
