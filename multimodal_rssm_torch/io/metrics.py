"""Run directories and metric logging (JSONL).

``results/{experiment}/{date}/run_{k}`` with collision bumping and the
composed config saved as ``hydra_config.yaml`` (reference utils/logger.py),
and an append-only ``metrics.jsonl`` whose keys follow the reference's
``{name}/{suffix}`` convention.
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import time
from typing import Mapping, Optional

from multimodal_rssm_torch.core.config import save_config


def make_run_dir(cfg, cwd: str = ".", resume_dir: Optional[str] = None
                 ) -> str:
    """Create ``{cwd}/results/{experiment}/{date}/run_{k}``, or reuse
    ``resume_dir`` (which must exist), and snapshot the config into it."""
    if resume_dir is not None:
        if not os.path.isdir(resume_dir):
            raise FileNotFoundError(f"resume dir {resume_dir} does not exist")
        run_dir = resume_dir
    else:
        base = os.path.join(cwd, "results", str(cfg.main.experiment_name),
                            str(datetime.date.today()))
        k = 0
        while os.path.exists(os.path.join(base, f"run_{k}")):
            k += 1
        run_dir = os.path.join(base, f"run_{k}")
        os.makedirs(run_dir)
    cfg.main.log_dir = run_dir
    save_config(cfg, os.path.join(run_dir, "hydra_config.yaml"))
    return run_dir


def find_latest_run(cwd: str, experiment_name: str) -> str:
    """The most recently modified ``results/{experiment}/*/run_*`` dir (for
    ``--resume latest``)."""
    runs = [d for d in glob.glob(os.path.join(
        cwd, "results", str(experiment_name), "*", "run_*"))
        if os.path.isdir(d)]
    if not runs:
        raise FileNotFoundError(
            f"no runs under {cwd}/results/{experiment_name} to resume")
    return max(runs, key=os.path.getmtime)


class MetricLogger:
    """Scalars as JSON lines under ``{name}/{suffix}`` keys."""

    def __init__(self, results_dir: str):
        self.path = os.path.join(results_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def log(self, metrics: Mapping[str, float], step: int,
            suffix: str = "train") -> None:
        rec = {f"{k}/{suffix}": float(v) for k, v in metrics.items()}
        rec["step"] = int(step)
        rec["time"] = time.time()
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
