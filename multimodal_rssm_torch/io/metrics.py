"""Run directories and metric logging (JSONL, and wandb when asked).

``results/{experiment}/{date}/run_{k}`` with collision bumping and the
composed config saved as ``hydra_config.yaml`` with ``main.git_hash`` set
(reference utils/logger.py), and an append-only ``metrics.jsonl`` whose
keys follow the reference's ``{name}/{suffix}`` convention, plus
per-module histogram lines (``MetricLogger.log_histograms``) and ``frame``
counters (``MetricLogger.log_frame_count``).  With ``use_wandb`` (the
config's ``main.wandb``) every record is mirrored to wandb as the JAX
package's logger mirrors it; ``wandb`` is imported only then, and a run
whose import or ``wandb.init`` fails keeps its JSONL alone.

In a data-parallel world, rank 0 alone creates the run dir (and bumps
``run_{k}``) and writes its files; the other ranks receive its path
(``make_run_dir``) and log to a ``NullLogger``.
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
from multimodal_rssm_torch.parallel.mesh import broadcast_object, is_main

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
    ``main.git_hash`` (null outside a git checkout).  In a world of ranks,
    rank 0 does it and every rank returns its path."""
    run_dir = git_hash = error = None
    if is_main():
        try:
            if resume_dir is not None:
                if not os.path.isdir(resume_dir):
                    raise FileNotFoundError(
                        f"resume dir {resume_dir} does not exist")
                run_dir = resume_dir
            else:
                base = os.path.join(cwd, "results",
                                    str(cfg.main.experiment_name),
                                    str(datetime.date.today()))
                k = 0
                while os.path.exists(os.path.join(base, f"run_{k}")):
                    k += 1
                run_dir = os.path.join(base, f"run_{k}")
                os.makedirs(run_dir)
            git_hash = get_git_hash()
            cfg.main.git_hash = git_hash
            cfg.main.log_dir = run_dir
            save_config(cfg, os.path.join(run_dir, "hydra_config.yaml"))
        except OSError as e:   # every rank raises, none waits on rank 0
            error = e
    run_dir, git_hash, error = broadcast_object((run_dir, git_hash, error))
    if error is not None:
        raise error
    cfg.main.git_hash = git_hash
    cfg.main.log_dir = run_dir
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


def wandb_kwargs(cfg, cwd: str, run_dir: str) -> Dict[str, object]:
    """``wandb.init``'s arguments for a run, as the JAX package's
    ``setup_experiment`` builds them: the run's path under
    ``{cwd}/results`` as its name (a run dir elsewhere: its base name), the
    environment's name as the project, the whole config, its tags, and the
    run dir as wandb's own directory."""
    rel = os.path.relpath(run_dir, os.path.join(cwd, "results"))
    return {"name": rel if not rel.startswith("..")
            else os.path.basename(run_dir),
            "project": cfg.env.env_config.env_name,
            "config": cfg.to_dict(), "tags": cfg.main.tags, "dir": run_dir}


class NullLogger:
    """``MetricLogger``'s interface, writing nothing (ranks other than 0)."""

    def log(self, *args, **kwargs) -> None:
        pass

    def log_histograms(self, *args, **kwargs) -> None:
        pass

    def log_frame_count(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MetricLogger:
    """Scalars as JSON lines under ``{name}/{suffix}`` keys in
    ``{results_dir}/metrics.jsonl`` (the dir made if absent); with
    ``use_wandb``, each record mirrored to wandb, ``wandb.init`` taking
    ``wandb_kwargs``."""

    def __init__(self, results_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[Mapping[str, object]] = None):
        os.makedirs(results_dir, exist_ok=True)
        self.path = os.path.join(results_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception as e:   # no package, no network: JSONL alone
                print(f"wandb unavailable ({e!r}); logging to {self.path} "
                      "only")

    def log(self, metrics: Mapping[str, float], step: int,
            suffix: str = "train") -> None:
        rec = {f"{k}/{suffix}": float(v) for k, v in metrics.items()}
        rec["step"] = int(step)
        rec["time"] = time.time()
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items()
                             if k not in ("step", "time")}, step=int(step))

    def log_histograms(self, groups: Mapping[str, Iterable[torch.Tensor]],
                       step: int, prefix: str = "params") -> None:
        """One line of ``{prefix}_{module}/hist`` records
        (``histogram_record`` of the module's tensors, concatenated), one
        per top-level module of ``groups`` (module name -> its tensors), as
        the JAX package's ``log_histograms`` writes them (the reference's
        ``wandb.watch`` analogue).  A module with no tensors is skipped; one
        with no finite value is recorded, not raised."""
        rec: Dict[str, object] = {"step": int(step), "time": time.time()}
        mirrored = {}
        for mod, leaves in groups.items():
            leaves = [x.detach().reshape(-1).float() for x in leaves]
            if leaves:
                key = f"{prefix}_{mod}/hist"
                rec[key] = hist = histogram_record(torch.cat(leaves))
                if self._wandb is not None and "bin_counts" in hist:
                    mirrored[key] = self._wandb.Histogram(np_histogram=(
                        np.asarray(hist["bin_counts"], np.int64),
                        np.asarray(hist["bin_edges"], np.float32)))
        self._f.write(json.dumps(rec) + "\n")
        if mirrored:
            self._wandb.log(mirrored, step=int(step))

    def log_frame_count(self, step: int, batch_size: int,
                        chunk_size: int) -> None:
        """``{"frame": step * batch_size * chunk_size, "step", "time"}``,
        the frames trained on so far (ref base/algo.py:265-266); the JAX
        package writes it to the JSONL only."""
        self._f.write(json.dumps({
            "frame": int(step * batch_size * chunk_size),
            "step": int(step), "time": time.time()}) + "\n")

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
