"""Run directories and metric logging (JSONL).

``results/{experiment}/{date}/run_{k}`` with collision bumping and the
composed config saved as ``hydra_config.yaml`` with ``main.git_hash`` set
(reference utils/logger.py), and an append-only ``metrics.jsonl`` whose
keys follow the reference's ``{name}/{suffix}`` convention, plus
per-module histogram lines (``MetricLogger.log_histograms``).
"""

from __future__ import annotations

import datetime
import glob
import json
import os
import subprocess
import time
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from multimodal_rssm_torch.core.config import save_config

HIST_BINS = 16


def get_git_hash(path: Optional[str] = None) -> Optional[str]:
    """``git rev-parse --short HEAD`` of the checkout holding ``path``
    (default: this package), or None outside a checkout."""
    path = path or os.path.dirname(os.path.abspath(__file__))
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"], cwd=path,
            stderr=subprocess.DEVNULL).strip().decode()
    except (OSError, subprocess.CalledProcessError):   # no git, no checkout
        return None


def make_run_dir(cfg, cwd: str = ".", resume_dir: Optional[str] = None
                 ) -> str:
    """Create ``{cwd}/results/{experiment}/{date}/run_{k}``, or reuse
    ``resume_dir`` (which must exist), and snapshot the config into it with
    ``main.git_hash`` (null outside a git checkout)."""
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
    cfg.main.git_hash = get_git_hash()
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


def histogram_record(values: torch.Tensor) -> Dict[str, object]:
    """count, nonfinite, min, max, mean, std (float32) and the 16-bin
    ``np.histogram`` of the finite values, computed where ``values`` lies
    (one read back of the statistics and the counts); values with none
    finite record only the counts.  The bins are NumPy's exactly: its edges
    (``np.histogram_bin_edges`` of the min and max in float32) and its
    rule, x in bin i when edge[i] <= x < edge[i + 1], the last bin closed."""
    flat = values.detach().reshape(-1).float()
    finite = flat[torch.isfinite(flat)]
    rec: Dict[str, object] = {"count": int(flat.numel()),
                              "nonfinite": int(flat.numel() - finite.numel())}
    if finite.numel() == 0:
        return rec
    lo, hi, mean, std = torch.stack([
        finite.min(), finite.max(), finite.mean(),
        finite.std(correction=0)]).tolist()
    edges = np.histogram_bin_edges(np.asarray([lo, hi], np.float32),
                                   bins=HIST_BINS)
    index = torch.bucketize(finite, torch.from_numpy(edges[1:-1]).to(
        finite.device), right=True)
    counts = torch.bincount(index, minlength=HIST_BINS)
    rec.update({"min": lo, "max": hi, "mean": mean, "std": std,
                "bin_counts": counts.tolist(),
                "bin_edges": [float(e) for e in edges]})
    return rec


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

    def log_histograms(self, groups: Mapping[str, Iterable[torch.Tensor]],
                       step: int, prefix: str = "params") -> None:
        """One line of ``{prefix}_{module}/hist`` records
        (``histogram_record`` of the module's tensors, concatenated), one
        per top-level module of ``groups`` (module name -> its tensors), as
        the JAX package's ``log_histograms`` writes them (the reference's
        ``wandb.watch`` analogue).  A module with no tensors is skipped; one
        with no finite value is recorded, not raised."""
        rec: Dict[str, object] = {"step": int(step), "time": time.time()}
        for mod, leaves in groups.items():
            leaves = [x.detach().reshape(-1).float() for x in leaves]
            if leaves:
                rec[f"{prefix}_{mod}/hist"] = histogram_record(
                    torch.cat(leaves))
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
