"""Write a synthetic COBOTTA-schema dataset for smoke runs and tests.

    python -m multimodal_rssm_torch.cli.make_synthetic_dataset \
        --out dataset/synthetic --episodes 20 --length 200

The port's copy of the JAX package's ``make_synthetic_dataset`` CLI, over
the port's ``data/synthetic.py``: the same ``--seed`` writes the same files
(``{out}/train``: ``--episodes`` episodes from ``--seed``;
``{out}/validation``: max(1, episodes // 5) from ``--seed`` + 10,000).
Host-side only: it touches no device.
"""

import argparse
import os

from multimodal_rssm_torch.cli import command
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

SHAPES = {
    "image_horizon": [3, 64, 64], "image_horizon_128": [3, 128, 128],
    "image_horizon_256": [3, 256, 256], "sound": [128, 20],
    "pose_quat_v2": [3],
}


@command
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True)
    parser.add_argument("--episodes", type=int, default=10)
    parser.add_argument("--length", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--modalities", default="image_horizon,sound",
        help="comma-separated modality names")
    args = parser.parse_args(argv)

    shapes = {n: SHAPES.get(n, [3]) for n in args.modalities.split(",")}
    for d in ("train", "validation"):
        write_synthetic_dataset(
            os.path.join(args.out, d),
            args.episodes if d == "train" else max(1, args.episodes // 5),
            args.length, shapes, seed=args.seed + (0 if d == "train" else 10_000),
        )
    print(f"wrote synthetic dataset to {args.out}")


if __name__ == "__main__":
    main()
