"""Multi-seed, multi-config calibration of the port's quality windows
(``configs/quality_windows.json``).

    python -m multimodal_rssm_torch.cli.calibrate_quality_windows \\
        --seeds 0 1 2 --configs default categorical chunk200 \\
        [--device cuda|cpu] [--jobs 3] [--write]

The port's copy of the JAX package's ``scripts/calibrate_quality_windows.py``:
runs the quality gate's train + eval chain (``cli/quality_gate.py``) for
every (config, seed) cell, then derives windows that contain every seed
with margin and stay tight enough to catch a real regression.  The
per-seed values are recorded under ``_calibration`` so that the bands can
be audited.  ``--jobs`` runs that many cells at once (each in its own run
dir; the datasets are written first, one at a time): the cells are
independent, and each is bound by its host thread.

Band rules (from the seeds' min / max), the JAX package's:
  losses / MSE:            [0.65 * min, 1.5 * max]
  imagination_psnr_*:      [min - 3, max + 6]
  imagination_ssim_*:      [min - 0.1, max + 0.15]
  val_rows_finite:         [1, 1]

Runs on the GPU unless ``--device cpu``; without a GPU it raises.  The
windows' key is ``<device><config suffix>``; ``--write`` merges them into
the JSON (the ``tpu*`` blocks are the JAX package's and are never
written here).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

from multimodal_rssm_torch.cli import quality_gate as qg


def derive_windows(per_seed: Dict) -> Dict:
    """per_seed: {seed: {metric: value}} -> {metric: [lo, hi]} plus the
    ``_calibration`` record."""
    metrics = sorted({m for vals in per_seed.values() for m in vals})
    block = {}
    for name in metrics:
        vals = [per_seed[s][name] for s in per_seed if name in per_seed[s]]
        lo_v, hi_v = min(vals), max(vals)
        if name == "val_rows_finite":
            block[name] = [1.0, 1.0]
        elif name.startswith("imagination_ssim"):
            block[name] = [round(lo_v - 0.1, 4), round(hi_v + 0.15, 4)]
        elif name.startswith("imagination_psnr"):
            block[name] = [round(lo_v - 3.0, 2), round(hi_v + 6.0, 2)]
        else:
            block[name] = [round(lo_v * 0.65, 6), round(hi_v * 1.5, 6)]
    block["_calibration"] = {
        "seeds": sorted(per_seed),
        "values": {name: {str(s): per_seed[s].get(name)
                          for s in sorted(per_seed)}
                   for name in metrics},
    }
    return block


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--configs", nargs="+", default=["default"],
                    choices=sorted(qg.CONFIGS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--workdir", default=qg.DEFAULT_WORKDIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once")
    ap.add_argument("--write", action="store_true",
                    help="merge the derived blocks into quality_windows.json")
    args = ap.parse_args(argv)

    from multimodal_rssm_torch.core.device import resolve_device

    resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    print(f"# calibration device: {args.device}", flush=True)
    for config in args.configs:
        for seed in args.seeds:
            qg.build_dataset(args.workdir, seed, qg.CONFIGS[config][2])

    def cell(config_seed):
        config, seed = config_seed
        ns = argparse.Namespace(device=args.device, iters=args.iters,
                                seed=seed, workdir=args.workdir,
                                config=config)
        values = qg.collect_metrics(qg.train_and_eval(ns))
        print(f"# {config} seed {seed}: {json.dumps(values)}", flush=True)
        return values

    cells = [(c, s) for c in args.configs for s in args.seeds]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        values = dict(zip(cells, pool.map(cell, cells)))
    out = {args.device + qg.CONFIGS[c][1]:
           derive_windows({s: values[(c, s)] for s in args.seeds})
           for c in args.configs}

    print(json.dumps(out, indent=2))
    if args.write:
        windows = {}
        if os.path.exists(qg.WINDOWS_PATH):
            windows = qg.load_windows()
        windows.update(out)
        with open(qg.WINDOWS_PATH, "w") as f:
            json.dump(windows, f, indent=2)
            f.write("\n")
        print(f"# wrote {qg.WINDOWS_PATH}")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
