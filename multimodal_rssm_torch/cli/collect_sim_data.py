"""Collect episodes from a simulated environment in the COBOTTA schema.

    python -m multimodal_rssm_torch.cli.collect_sim_data --out dataset/sim \
        --episodes 8 --length 100 [--env peg|synthetic|gym:<id>|...]

The port of the JAX package's ``collect_sim_data`` CLI over the port's
``envs/``: the peg-insertion task's scripted descent (MuJoCo), or any env of
``envs.make_env`` (``synthetic``; ``gym:`` / ``dmc:`` / ``robosuite:``
specs) under a uniform random policy unless the env defines
``scripted_action``.  It writes ``{out}/train`` (``--episodes`` episodes
from ``--seed``) and ``{out}/validation`` (max(1, episodes // 4) from
``--seed`` + 10,000), one ``episode_{i:04d}.npy`` each, that the train CLI
loads unchanged: the env's observations (``image_horizon`` uint8 HWC,
``sound``, ``pose_quat_v2`` for peg), the actions as ``d_pose_quat_v2``,
``reward`` and ``done``.

Two deliberate differences from the JAX CLI: an episode ends at the env's
``done`` (the JAX collector steps on past it, writing rows of a finished
env), and each split builds one env, resets it with each episode's seed
and closes it at the end (the JAX CLI builds an env per episode and never
closes it).  On an env that runs its whole ``--length`` the files are the
JAX CLI's.  Host-side only: it touches no device.
"""

import argparse
import os

import numpy as np


def collect_episode(length, seed, substeps=10, render_size=64, env=None):
    """One episode in the COBOTTA episode schema: at most ``length`` steps,
    ending at the env's ``done``.

    Row t = (o_t, a_t, r_t, done_t), a_t taken from o_t (the COBOTTA
    ``d_pose`` channels are forward differences: the (actions[:-1],
    obs[1:]) pairing the trainer scans); the terminal observation is
    dropped.  ``env``: an env to collect from (reset with ``seed``);
    None builds the peg env."""
    if env is None:
        from multimodal_rssm_torch.envs.peg import PegInsertionEnv

        env = PegInsertionEnv(length=length, substeps=substeps,
                              render_size=render_size, seed=seed)
    rng = np.random.default_rng(seed)

    obs = env.reset(seed=seed)
    obs_lists = {name: [] for name in env.observation_names}
    acts, rewards, dones = [], [], []
    for _ in range(length):
        if hasattr(env, "scripted_action"):
            action = env.scripted_action(rng)
        else:
            action = rng.uniform(-1.0, 1.0, env.action_size).astype(
                np.float32)
        for name in env.observation_names:
            obs_lists[name].append(obs[name])
        obs, reward, done = env.step(action)
        acts.append(action)
        rewards.append(reward)
        dones.append(float(done))
        if done:
            break

    out = {name: np.stack(v) for name, v in obs_lists.items()}
    out["d_pose_quat_v2"] = np.stack(acts)
    out["reward"] = np.asarray(rewards, np.float32)
    out["done"] = np.asarray(dones, np.float32)
    return out


def close_env(env) -> None:
    """Release what an env holds open: a suite's env (the zoo adapters'
    ``env``) or the peg env's GL renderer."""
    inner = getattr(env, "env", None) or getattr(env, "renderer", None)
    close = getattr(inner, "close", None)
    if callable(close):
        close()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True)
    parser.add_argument("--episodes", type=int, default=8)
    parser.add_argument("--length", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--env", default="peg",
        help="environment to collect from: 'peg' (scripted demonstration "
             "policy) | 'synthetic' | suite spec ('gym:<id>', "
             "'dmc:<domain>:<task>', 'robosuite:<Task>'; random policy "
             "unless the env defines scripted_action)")
    args = parser.parse_args(argv)

    from multimodal_rssm_torch.envs import make_env

    for split, n, seed0 in (("train", args.episodes, args.seed),
                            ("validation", max(1, args.episodes // 4),
                             args.seed + 10_000)):
        out = os.path.join(args.out, split)
        os.makedirs(out, exist_ok=True)
        env = make_env(args.env, length=args.length, seed=seed0)
        try:
            for i in range(n):
                ep = collect_episode(args.length, seed0 + i, env=env)
                np.save(os.path.join(out, f"episode_{i:04d}.npy"), ep,
                        allow_pickle=True)
        finally:
            close_env(env)
        print(f"wrote {n} episodes to {out}")


if __name__ == "__main__":
    main()
