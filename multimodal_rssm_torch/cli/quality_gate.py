"""Quality regression gate: a short fixed-seed train and the deterministic
eval chain, FAILING when any metric leaves its committed window.

    python -m multimodal_rssm_torch.cli.quality_gate [--device cuda|cpu] \\
        [--config default|categorical|chunk200] [--seed 0] [--iters 300] \\
        [--workdir DIR] [--calibrate] [key=value ...]

The port's copy of the JAX package's ``scripts/quality_gate.py``, over the
port's own CLIs, each in its own process:

1. ``cli.make_synthetic_dataset``: the fixed-seed synthetic COBOTTA set
   (4 episodes of 80 steps, 300 for ``chunk200``; cached per seed and
   length under ``--workdir``);
2. ``cli.train``: ``--iters`` iterations (300) at batch 8 x chunk 20 with
   the default model plus the config's overrides, validation every 50,
   one checkpoint at the end; trailing ``key=value`` overrides go to this
   run after the config's (e.g. ``train.use_amp=false``: the windows stay
   the config's, so the run is read against the shipped precision's);
3. ``cli.check_model --t-start 10 --horizon 10`` on that checkpoint:
   posterior estimation, reconstruction, open-loop imagination;
4. every metric (``collect_metrics``) inside the committed windows of
   ``configs/quality_windows.json`` under the key ``<device><suffix>``
   (``cuda``, ``cuda_categorical``, ``cuda_chunk200``; ``cpu`` runs the
   tiny widths of ``TINY``).  The reading against the JAX package's
   ``tpu<suffix>`` windows (bf16 as the card's runs are) is printed beside
   it and gates nothing.

Runs on the GPU unless ``--device cpu``; without a GPU it raises.  Exit 0:
inside every window; 1: a metric missing or outside its window (each
printed); 2: no committed windows for the key.  The last line of its
output is one JSON object: config, seed, device, metrics, failures and the
``tpu`` reading.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)
WINDOWS_PATH = os.path.join(PKG, "configs", "quality_windows.json")
DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "mrssm_torch_qgate")

# Tiny-model overrides for the CPU variant (full width takes seconds a step
# there; the gate stays a smoke-scale check on the CPU).
TINY = [
    "rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
    "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
    "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
    "train.use_amp=False",
]

# The gate's config matrix, the JAX package's: (extra overrides, windows-key
# suffix, episode length).  The chunk-200 row needs episodes longer than
# the chunk.
CONFIGS = {
    "default": ([], "", 80),
    "categorical": (["rssm.latent_dist=categorical"], "_categorical", 80),
    "chunk200": (["train.batch_size=2", "train.chunk_size=200"],
                 "_chunk200", 300),
}


def run(cmd: Sequence[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    subprocess.run(list(cmd), check=True, env=env, cwd=REPO)


def _module(name: str) -> List[str]:
    return [sys.executable, "-m", f"multimodal_rssm_torch.cli.{name}"]


def build_dataset(root: str, seed: int, length: int = 80) -> str:
    """The gate's synthetic set for ``seed`` (written once per seed and
    episode length under ``root``); returns its dir."""
    suffix = "" if length == 80 else f"_len{length}"
    ds = os.path.join(root, f"qgate_ds_seed{seed}{suffix}")
    if not os.path.isdir(os.path.join(ds, "train")):
        run(_module("make_synthetic_dataset") + [
            "--out", ds, "--episodes", "4", "--length", str(length),
            "--seed", str(seed)])
    return ds


def train_and_eval(args) -> str:
    """Train and evaluate one (config, seed) cell; returns its run dir."""
    ds = build_dataset(args.workdir, args.seed, CONFIGS[args.config][2])
    run_root = os.path.join(args.workdir,
                            f"qgate_run_{args.config}_seed{args.seed}")
    overrides = [
        f"train.train_data_path=[{ds}/train]",
        f"train.validation_data_path=[{ds}/validation]",
        "train.batch_size=8", "train.chunk_size=20",
        f"train.train_iteration={args.iters}",
        "train.validation_interval=50",
        f"train.checkpoint_interval={args.iters}",
        f"main.seed={args.seed}",
        "main.experiment_name=qgate",
    ]
    overrides += CONFIGS[args.config][0]
    if args.device == "cpu":
        overrides += TINY
    overrides += list(getattr(args, "overrides", ()))
    run(_module("train") + overrides + ["--cwd", run_root,
                                        "--device", args.device])

    # newest run dir under results/qgate/<date>/run_*
    exp = os.path.join(run_root, "results", "qgate")
    runs = [os.path.join(d, r)
            for d in (os.path.join(exp, x) for x in os.listdir(exp))
            for r in os.listdir(d)]
    run_dir = max(runs, key=os.path.getmtime)
    run(_module("check_model") + [
        "--run", run_dir, "--itr", str(args.iters), "--t-start", "10",
        "--horizon", "10", "--cwd", args.workdir, "--device", args.device])
    return run_dir


def collect_metrics(run_dir: str) -> Dict[str, float]:
    """The gate's observables from a run's artifacts; a truncated
    ``metrics.jsonl`` or a missing analysis leaves keys out (which
    ``check_windows`` reports as missing), never raises."""
    out = {}
    train_loss, val_rows = [], []
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "loss/train" in rec:
                train_loss.append((rec["step"], rec["loss/train"]))
            if "loss/validation" in rec:
                val_rows.append(rec["loss/validation"])
    if train_loss:
        out["train_loss_first"] = train_loss[0][1]
        out["train_loss_final"] = train_loss[-1][1]
    if val_rows:
        out["val_loss_final"] = val_rows[-1]
        out["val_rows_finite"] = float(all(math.isfinite(r) for r in val_rows))

    analysis = os.path.join(run_dir, "analysis", "imagination_mse.json")
    if not os.path.exists(analysis):
        return out
    with open(analysis) as f:
        imag = json.load(f)
    for mod, v in imag["mse"].items():
        out[f"imagination_mse_{mod}"] = v
    for mod, qm in imag.get("metrics", {}).items():
        for name, v in qm.items():
            if name != "mse":
                out[f"imagination_{name}_{mod}"] = v
    return out


def check_windows(metrics: Dict[str, float], windows: Dict) -> List[str]:
    """One failure line per window whose metric is missing, NaN or outside
    [lo, hi]; ``_``-keys (calibration records) are not windows."""
    failures = []
    for name, bounds in windows.items():
        if name.startswith("_"):
            continue
        lo, hi = bounds
        v = metrics.get(name)
        if v is None:
            failures.append(f"{name}: metric missing from run artifacts")
        elif not (v == v) or not (lo <= v <= hi):
            failures.append(f"{name}: {v!r} outside [{lo}, {hi}]")
    return failures


def load_windows() -> Dict:
    with open(WINDOWS_PATH) as f:
        return json.load(f)


def proposed_windows(metrics: Dict[str, float]) -> Dict[str, List[float]]:
    """``--calibrate``'s single-run block: +-40% on losses / MSE, fixed
    bands for the bounded metrics (hand-tighten before committing)."""
    block = {}
    for name, v in metrics.items():
        if name == "val_rows_finite":
            block[name] = [1.0, 1.0]
        elif name.startswith("imagination_ssim"):
            block[name] = [round(v - 0.1, 4), 1.0]
        elif name.startswith("imagination_psnr"):
            block[name] = [round(v - 3.0, 2), round(v + 6.0, 2)]
        else:
            block[name] = [round(v * 0.6, 6), round(v * 1.4, 6)]
    return block


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--calibrate", action="store_true",
                    help="print a quality_windows.json block instead of "
                         "gating")
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS),
                    help="gate config matrix entry: 'categorical' = "
                         "rssm.latent_dist=categorical (32x32), 'chunk200' "
                         "= batch 2 x chunk 200")
    ap.add_argument("overrides", nargs="*",
                    help="key=value config overrides of the train run")
    return ap.parse_args(argv)


def gate(args: argparse.Namespace) -> Dict:
    """Run one gate cell and read it: the summary main prints last, with
    ``rc`` its exit code (``failures`` None without committed windows)."""
    from multimodal_rssm_torch.core.device import resolve_device

    resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    print(f"# gate device: {args.device}, config: {args.config}", flush=True)
    run_dir = train_and_eval(args)
    metrics = collect_metrics(run_dir)
    print(json.dumps(metrics, indent=2))

    suffix = CONFIGS[args.config][1]
    key = args.device + suffix
    summary = {"config": args.config, "seed": args.seed,
               "device": args.device, "key": key, "run_dir": run_dir,
               "overrides": list(args.overrides), "metrics": metrics}
    if args.calibrate:
        print(f"\n--calibrate: proposed windows for '{key}':")
        print(json.dumps({key: proposed_windows(metrics)}, indent=2))
        return {**summary, "failures": None, "rc": 0}

    windows = load_windows()
    tpu = windows.get("tpu" + suffix)
    summary["tpu_key"] = "tpu" + suffix
    summary["tpu_failures"] = check_windows(metrics, tpu) if tpu else None
    print(f"\nreading against the JAX package's 'tpu{suffix}' windows "
          f"(gates nothing): {summary['tpu_failures'] or 'inside all'}")
    if key not in windows:
        print(f"no committed windows for '{key}' in {WINDOWS_PATH}; run "
              "with --calibrate first", file=sys.stderr)
        return {**summary, "failures": None, "rc": 2}
    failures = check_windows(metrics, windows[key])
    if failures:
        print("\nQUALITY GATE FAILED:", file=sys.stderr)
        for f_ in failures:
            print("  -", f_, file=sys.stderr)
    else:
        n = sum(1 for k in windows[key] if not k.startswith("_"))
        print(f"\nquality gate OK: {n} metrics inside windows")
    return {**summary, "failures": failures, "rc": 1 if failures else 0}


def main(argv: Optional[Sequence[str]] = None) -> int:
    summary = gate(parse_args(argv))
    print(json.dumps(summary), flush=True)
    return summary["rc"]


if __name__ == "__main__":
    sys.exit(main())
