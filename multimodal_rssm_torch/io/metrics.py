"""Run directories and metric logging (JSONL).

``results/{experiment}/{date}/run_{k}`` with collision bumping and the
composed config saved as ``hydra_config.yaml`` (reference utils/logger.py),
and an append-only ``metrics.jsonl`` whose keys follow the reference's
``{name}/{suffix}`` convention.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Mapping

from multimodal_rssm_torch.core.config import save_config


def make_run_dir(cfg, cwd: str = ".") -> str:
    """Create ``{cwd}/results/{experiment}/{date}/run_{k}`` and snapshot
    the config into it."""
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
