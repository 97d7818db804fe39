"""The online peg-insertion learning table: three policies in the MuJoCo peg
env (``envs/peg.py``), one markdown table and one JSON artifact.

    python -m multimodal_rssm_torch.cli.online_peg_table --seeds 0 1 \\
        --train-episodes 30 --eval-episodes 10 [--out docs/peg_online_table_torch.md] \\
        [--device cuda|cpu]

The port's counterpart of the JAX package's ``scripts/online_peg_table.py``
(same flags, ``SUCCESS_THRESHOLD``, ``summarize`` fields, table and JSON):

- **random**: uniform actions in [-1, 1]^3 (the online loop's seed policy);
- **scripted**: the demonstration controller (``env.scripted_action``, the
  data-collection policy, an informed upper baseline);
- **learned**: a Dreamer agent trained online per seed through the port's
  ``cli/train_online`` and evaluated greedily through ``cli/eval_policy``
  (both in this process, on ``--device``).

Success proxy: ``best_reward > -0.08``: the peg tip entered the hole mouth
(reward = -tip-to-hole distance; the hole's half-width is 0.06 and its
mouth sits ~0.1 above it).  Needs MuJoCo.  The default ``--out`` is
``docs/peg_online_table_torch.md`` (and ``.json``), beside the JAX
script's ``docs/peg_online_table.md``, which it leaves alone.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SUCCESS_THRESHOLD = -0.08


def rollout_baseline(policy: str, episodes: int, length: int, seed: int):
    """Random / scripted rollouts, no model; the statistics of
    ``eval/policy.evaluate_policy``."""
    from multimodal_rssm_torch.envs import make_env

    env = make_env("peg", length=length)
    rng = np.random.default_rng(seed)
    returns, finals, bests = [], [], []
    for ep in range(episodes):
        env.reset(seed=seed * 10_000 + ep)
        total, done = 0.0, False
        last_r, best_r = 0.0, -np.inf
        while not done:
            if policy == "random":
                action = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
            else:
                action = env.scripted_action(rng)
            _, reward, done = env.step(action)
            total += float(reward)
            last_r = float(reward)
            best_r = max(best_r, last_r)
        returns.append(total)
        finals.append(last_r)
        bests.append(best_r)
    return {"returns": returns, "final_rewards": finals,
            "best_rewards": bests}


def summarize(name, seeds, stats):
    rets = [r for s in stats for r in s["returns"]]
    bests = [b for s in stats for b in s["best_rewards"]]
    finals = [f for s in stats for f in s["final_rewards"]]
    succ = float(np.mean([b > SUCCESS_THRESHOLD for b in bests]))
    return {
        "policy": name, "seeds": seeds, "episodes": len(rets),
        "mean_return": float(np.mean(rets)),
        "std_return": float(np.std(rets)),
        "mean_final_distance": float(-np.mean(finals)),
        "mean_best_distance": float(-np.mean(bests)),
        "success_rate": succ,
    }


def train_and_eval_seed(seed: int, args, workdir: str):
    """Train one seed's agent online, evaluate it greedily; returns the
    evaluation's statistics and the run dir."""
    from multimodal_rssm_torch.cli import eval_policy, train_online

    run_root = os.path.join(workdir, f"peg_seed{seed}")
    argv = ["--env", "peg", "--env-length", str(args.length),
            "--cwd", run_root, "--device", args.device,
            f"main.seed={seed}", "main.experiment_name=peg_online",
            f"online.episodes={args.train_episodes}",
            f"online.collect_interval={args.collect_interval}",
            "train.batch_size=16", "train.chunk_size=25",
            "train.experience_size=20000", *args.override]
    print("+ train_online", " ".join(argv), flush=True)
    run_dir = train_online.main(argv)["results_dir"]

    argv = ["--run-dir", run_dir, "--env", "peg",
            "--env-length", str(args.length),
            "--episodes", str(args.eval_episodes), "--device", args.device]
    print("+ eval_policy", " ".join(argv), flush=True)
    rec = eval_policy.main(argv)
    with open(os.path.join(run_root, "eval.json"), "w") as f:
        json.dump(rec, f)
    return rec, run_dir


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parse ``argv``, roll the policies, write and print the table;
    returns its rows."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--train-episodes", type=int, default=30)
    ap.add_argument("--collect-interval", type=int, default=100)
    ap.add_argument("--eval-episodes", type=int, default=10)
    ap.add_argument("--length", type=int, default=100)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "mrssm_peg_table"))
    ap.add_argument("--out", default=os.path.join(
        REPO, "docs", "peg_online_table_torch.md"))
    ap.add_argument("--skip-train", action="store_true",
                    help="baselines only (no model, no training)")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the learned policy's device (default cuda; "
                         "raises without a GPU)")
    args = ap.parse_args(argv)
    if not args.skip_train:
        from multimodal_rssm_torch.core.device import resolve_device

        resolve_device(args.device)   # raises without a GPU, before rollouts
    os.makedirs(args.workdir, exist_ok=True)

    rows = []
    rand = [rollout_baseline("random", args.eval_episodes, args.length, s)
            for s in args.seeds]
    rows.append(summarize("random", args.seeds, rand))
    scripted = [rollout_baseline("scripted", args.eval_episodes, args.length,
                                 s) for s in args.seeds]
    rows.append(summarize("scripted (demo controller)", args.seeds, scripted))

    run_dirs = []
    if not args.skip_train:
        learned = []
        for s in args.seeds:
            rec, run_dir = train_and_eval_seed(s, args, args.workdir)
            learned.append(rec)
            run_dirs.append(run_dir)
        rows.append(summarize(
            f"learned (online Dreamer, {args.train_episodes} ep/seed)",
            args.seeds, learned))

    lines = [
        "# Online peg-insertion learning table",
        "",
        f"Env: envs/peg.py MuJoCo peg insertion, episode length "
        f"{args.length}; reward = -tip-to-hole distance.  "
        f"Success = any step with distance < {-SUCCESS_THRESHOLD} m "
        f"(tip inside the hole mouth).  {args.eval_episodes} greedy eval "
        f"episodes per seed, seeds {args.seeds}.",
        "",
        "| policy | mean return | std | mean final dist (m) | "
        "mean best dist (m) | success rate |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['policy']} | {r['mean_return']:.2f} | "
            f"{r['std_return']:.2f} | {r['mean_final_distance']:.3f} | "
            f"{r['mean_best_distance']:.3f} | {r['success_rate']:.2f} |")
    if run_dirs:
        lines += ["", "Run dirs: " + ", ".join(run_dirs)]
    table = "\n".join(lines) + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(table)
    with open(os.path.splitext(args.out)[0] + ".json", "w") as f:
        json.dump(rows, f, indent=2)
    print(table)
    return rows


if __name__ == "__main__":
    main()
