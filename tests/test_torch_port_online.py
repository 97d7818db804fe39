"""PyTorch port, the online loop and its surroundings: the port's own
``envs/`` against the JAX package's (the same observations, rewards and
ends from the same seeds and actions; the zoo adapters on
``tests/test_env_zoo.py``'s injected fakes; the MuJoCo peg task where
MuJoCo is installed), ``ExperienceReplay.append`` against the JAX
buffer's, ``collect_episode``'s row convention, ``run_online`` micro-runs
in both collection modes (metrics, K1 calls, checkpoints that restore, a
seed that fixes the run), ``evaluate_policy``, and the three control CLIs
(``train_behavior``, ``train_online``, ``eval_policy``) on the CPU at the
``bench.py --small`` widths, with their refusals.

The loop's numbers are the port's own (its noise streams are torch's, not
JAX's keys); ``test_torch_port_control.py`` holds each step against the
JAX package.
"""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.envs import synthetic as jsyn
from multimodal_rssm_tpu.envs import zoo as jzoo

from multimodal_rssm_torch.cli import eval_policy as cli_eval
from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.cli import train_behavior as cli_behavior
from multimodal_rssm_torch.cli import train_online as cli_online
from multimodal_rssm_torch.core.config import compose, load_run_config
from multimodal_rssm_torch.data import buffer as port_buffer
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.envs import SyntheticEnv, make_env
from multimodal_rssm_torch.envs import zoo
from multimodal_rssm_torch.eval.policy import evaluate_policy
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops import cuda_kernels
from multimodal_rssm_torch.train import behavior as bh
from multimodal_rssm_torch.train import online
from tests.test_env_zoo import (
    FakeClassicGym, FakeDMControl, FakeGymnasium, FakeRobosuite)
from tests.test_online import _CounterEnv
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False", "train.experience_size=200",
         "train.batch_size=2", "train.chunk_size=6"]
PLANNER = ["planner.candidates=20", "planner.top_candidates=4",
           "planner.planning_horizon=3", "planner.optimisation_iters=2"]
ONLINE = ["online.seed_episodes=2", "online.episodes=2",
          "online.collect_interval=2", "online.checkpoint_interval=1",
          "behavior.horizon=4"]
ENV_LENGTH = 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _same_obs(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _rollout(env, seed, actions):
    """[(obs, reward, done)] from reset(seed) through ``actions``."""
    out = [(env.reset(seed=seed), 0.0, False)]
    for a in actions:
        out.append(env.step(a))
    return out


def _same_rollout(got, want):
    assert len(got) == len(want)
    for (o, r, d), (wo, wr, wd) in zip(got, want):
        _same_obs(o, wo)
        assert r == wr and d == wd


# -- envs ------------------------------------------------------------------------------


def _env_pair(name):
    """(port env, JAX env, action width) of one environment, the suite
    adapters over fresh fakes."""
    if name == "synthetic":
        return (SyntheticEnv(length=6, seed=1), jsyn.SyntheticEnv(length=6,
                                                                  seed=1), 3)
    if name == "peg":
        pytest.importorskip("mujoco")
        from multimodal_rssm_tpu.envs.peg import PegInsertionEnv as JaxPeg
        from multimodal_rssm_torch.envs.peg import PegInsertionEnv

        return PegInsertionEnv(length=4), JaxPeg(length=4), 3
    fakes = {"gym": (FakeGymnasium, "GymAdapter", 2),
             "gym_classic": (FakeClassicGym, "GymAdapter", 3),
             "dmc": (FakeDMControl, "DMControlAdapter", 3),
             "robosuite": (FakeRobosuite, "RobosuiteAdapter", 7)}
    fake, adapter, width = fakes[name]
    return (getattr(zoo, adapter)(env=fake(), length=5),
            getattr(jzoo, adapter)(env=fake(), length=5), width)


@pytest.mark.parametrize("name", ["synthetic", "peg", "gym", "gym_classic",
                                  "dmc", "robosuite"])
def test_env_matches_jax(name):
    """From the same seed and actions, the port's env gives the JAX
    package's observations (the COBOTTA schema), rewards and ends."""
    env, jenv, width = _env_pair(name)
    assert env.action_size == jenv.action_size == width
    assert tuple(env.observation_names) == tuple(jenv.observation_names)
    rng = np.random.default_rng(0)
    actions = rng.uniform(-1, 1, (5, width)).astype(np.float32)
    n = {"synthetic": 5, "peg": 4}.get(name, 4)
    got = _rollout(env, 3, actions[:n])
    _same_rollout(got, _rollout(jenv, 3, actions[:n]))
    if name == "synthetic":
        assert got[-1][2] is False
        assert env.step(actions[0])[2] is True      # length 6
        assert got[0][0]["image_horizon"].shape == (64, 64, 3)


@pytest.mark.parametrize("helper", ["resize_frame", "pose_vector",
                                    "flatten_observation", "map_to_box",
                                    "contact_trace"])
def test_zoo_helpers_match_jax(helper):
    rng = np.random.default_rng(1)
    if helper == "resize_frame":
        for frame in (rng.integers(0, 256, (48, 40, 3), np.uint8),
                      rng.uniform(0, 1, (32, 32, 4)).astype(np.float32)):
            np.testing.assert_array_equal(zoo.resize_frame(frame, 64),
                                          jzoo.resize_frame(frame, 64))
    elif helper == "pose_vector":
        v = rng.normal(size=5) * 10
        np.testing.assert_array_equal(zoo.pose_vector(v, 3),
                                      jzoo.pose_vector(v, 3))
        np.testing.assert_array_equal(zoo.pose_vector(v[:2], 3),
                                      jzoo.pose_vector(v[:2], 3))
    elif helper == "flatten_observation":
        obs = {"b": rng.normal(size=2), "a": np.float64(2.0),
               "cam": np.zeros((32, 32, 3))}
        np.testing.assert_array_equal(zoo.flatten_observation(obs),
                                      jzoo.flatten_observation(obs))
    elif helper == "map_to_box":
        a = rng.uniform(-1, 1, 3).astype(np.float32)
        box = ([0.0, -2.0, -np.inf], [4.0, 2.0, np.inf])
        np.testing.assert_array_equal(zoo._map_to_box(a, *box),
                                      jzoo._map_to_box(a, *box))
    else:
        got, want = zoo.ContactTrace(), jzoo.ContactTrace()
        for x in rng.uniform(0, 5, 30):
            got.push(float(x))
            want.push(float(x))
        np.testing.assert_array_equal(got.spectrogram(), want.spectrogram())


def test_make_env_dispatch():
    assert isinstance(make_env("synthetic", length=3), SyntheticEnv)
    assert isinstance(make_env("gym:x", env=FakeGymnasium(), length=3),
                      zoo.GymAdapter)
    assert isinstance(make_env("dmc:d:t", env=FakeDMControl(), length=3),
                      zoo.DMControlAdapter)
    assert isinstance(make_env("robosuite:Lift", env=FakeRobosuite(),
                               length=3), zoo.RobosuiteAdapter)
    with pytest.raises(ValueError, match="unknown env"):
        make_env("nope")
    with pytest.raises(ValueError, match="unknown env suite"):
        make_env("atari:Pong")


# -- the buffer and collection --------------------------------------------------


@pytest.mark.parametrize("raw", [True, False])
def test_append_matches_jax_buffer(raw):
    """Steps appended to both packages' buffers, across the ring's wrap,
    leave the same arrays, write head and counters; ``raw=False`` quantises
    normalised images back to uint8."""
    over = SMALL[:-3] + ["train.experience_size=5"]
    D = port_buffer.build_buffer(compose(overrides=over))
    jD = jax_buffer.build_buffer(jax_compose(overrides=over))
    rng = np.random.default_rng(2)
    for t in range(7):
        img = rng.integers(0, 256, (64, 64, 3), np.uint8)
        obs = {"image_horizon": img if raw else
               (img / 256.0 - 0.5).astype(np.float32),
               "sound": rng.normal(size=(128, 20)).astype(np.float32)}
        a, r, done = rng.uniform(-1, 1, 3), float(rng.normal()), t == 3
        D.append(obs, a, r, done, raw=raw)
        jD.append(obs, a, r, done, raw=raw)
    for k in jD.observations:
        np.testing.assert_array_equal(D.observations[k], jD.observations[k])
    for k in ("actions", "rewards", "nonterminals"):
        np.testing.assert_array_equal(getattr(D, k), getattr(jD, k))
    assert (D.idx, D.full, D.steps, D.episodes) == (
        jD.idx, jD.full, jD.steps, jD.episodes) == (2, True, 7, 1)


def test_collect_episode_row_convention():
    """Row t holds the observation before the step and the action taken
    from it, the reward of that step; the terminal flag on the last row;
    the terminal observation is dropped; collection stops at ``done``."""
    D = port_buffer.build_buffer(compose(overrides=SMALL))
    m = online.collect_episode(_CounterEnv(length=6), D, None,
                               np.random.default_rng(0), seed=0)
    assert m["episode_steps"] == 6.0 and D.idx == 6
    np.testing.assert_array_equal(D.observations["sound"][:6, 0, 0],
                                  np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(D.rewards[:6],
                                  np.arange(1, 7, dtype=np.float32))
    np.testing.assert_array_equal(D.nonterminals[:6, 0], [1, 1, 1, 1, 1, 0])


# -- run_online, train_online ----------------------------------------------------


def _online_run(root, mode, monkeypatch, name=None):
    """One ``train_online`` CLI run on the CPU; returns (its result, the
    number of calls of K1's wrapper)."""
    calls = []
    wrapper = cuda_kernels.normalize_image
    monkeypatch.setattr(cuda_kernels, "normalize_image",
                        lambda *a: calls.append(a) or wrapper(*a))
    result = cli_online.main([
        *SMALL, *ONLINE, *PLANNER, f"online.collect_policy={mode}",
        f"main.experiment_name={name or mode}", "--env", "synthetic",
        "--env-length", str(ENV_LENGTH), "--device", "cpu", "--cwd",
        str(root)])
    monkeypatch.undo()
    return result, len(calls)


@pytest.fixture(scope="module")
def online_runs(tmp_path_factory):
    """A micro-run in each mode, and the actor mode once more."""
    root = tmp_path_factory.mktemp("online")
    mp = pytest.MonkeyPatch()
    runs = {mode: _online_run(root, mode, mp) for mode in ("actor", "cem")}
    runs["again"] = _online_run(root, "actor", mp, "actor_again")
    return runs


@pytest.mark.parametrize("mode", ["actor", "cem"])
def test_run_online_micro(online_runs, mode):
    """Two seed episodes, then two episodes of 2 updates each: metrics
    rows of both phases, finite losses, the episodes' length, K1 once per
    world-model step, behavior step and collected frame (under the shipped
    train.pallas_normalize=false), checkpoints at the top and under
    behavior/ that restore the returned state."""
    result, k1_calls = online_runs[mode]
    run_dir = result["results_dir"]
    rows = [json.loads(line) for line in
            open(os.path.join(run_dir, "metrics.jsonl"))]
    seed_rows = [r for r in rows if "episode_reward/seed" in r]
    online_rows = [r for r in rows if "episode_reward/online" in r]
    assert len(seed_rows) == 2 and len(online_rows) == 2
    for r in online_rows:
        assert r["episode_steps/online"] == float(ENV_LENGTH)
        assert np.isfinite(r["wm_loss/online"])
        if mode == "actor":
            assert np.isfinite(r["actor_loss/online"])
            assert np.isfinite(r["value_loss/online"])
        else:
            assert "actor_loss/online" not in r
    updates, frames = 2 * 2, 2 * ENV_LENGTH
    assert k1_calls == updates * (2 if mode == "actor" else 1) + frames
    cfg = load_run_config(run_dir)
    assert cfg.rssm.predict_reward and cfg.online.collect_policy == mode
    assert cfg.train.pallas_normalize is False
    for ep in (1, 2):
        assert os.path.exists(os.path.join(run_dir, f"models_{ep}.pt"))
    model = WorldModel.from_config(cfg)
    step, _ = ckpt.load_checkpoint(os.path.join(run_dir, "models_2.pt"),
                                   model)
    assert step == 2
    for k, v in result["model"].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    behavior = ckpt.latest_checkpoint(os.path.join(run_dir, "behavior"))
    if mode == "cem":
        assert behavior is None and result["behavior"] is None
        return
    bstate = bh.init_behavior_state(cfg, torch.device("cpu"), seed=5)
    assert ckpt.load_behavior_checkpoint(behavior, bstate) == 2
    want = result["behavior"]
    assert bstate.step == want.step == updates
    assert torch.equal(bstate.return_scale, want.return_scale)
    for got_m, want_m in ((bstate.actor, want.actor),
                          (bstate.value, want.value)):
        for k, v in want_m.state_dict().items():
            assert torch.equal(got_m.state_dict()[k], v), k
    for got_o, want_o in ((bstate.actor_opt, want.actor_opt),
                          (bstate.value_opt, want.value_opt)):
        for g, w in zip(got_o.state_dict()["state"].values(),
                        want_o.state_dict()["state"].values()):
            for k in w:
                assert torch.equal(g[k], w[k]), k


def test_a_seed_fixes_an_online_run(online_runs):
    """The actor mode run twice from one seed (the prefetch thread draws
    nothing) ends with the same world model and actor."""
    a, b = online_runs["actor"][0], online_runs["again"][0]
    for k, v in a["model"].state_dict().items():
        assert torch.equal(b["model"].state_dict()[k], v), k
    for k, v in a["behavior"].actor.state_dict().items():
        assert torch.equal(b["behavior"].actor.state_dict()[k], v), k


def test_online_cfg_refuses_unknown_collect_policy():
    cfg = compose(overrides=SMALL + ["online.collect_policy=random"])
    with pytest.raises(ValueError, match="collect_policy"):
        online.online_cfg(cfg)


def test_train_online_takes_the_env_action_size(tmp_path, monkeypatch):
    """A suite's action width flows into the model, the buffer and the
    actor (a 2-d gym action space against the COBOTTA default of 3)."""
    from multimodal_rssm_torch import envs

    monkeypatch.setattr(envs, "make_env", lambda name, length: zoo.GymAdapter(
        env=FakeGymnasium(horizon=100), length=length))
    result = cli_online.main([
        *SMALL, *ONLINE, "online.seed_episodes=1", "online.episodes=1",
        "online.collect_interval=1", "--env", "gym:fake", "--env-length",
        str(ENV_LENGTH), "--device", "cpu", "--cwd", str(tmp_path)])
    assert load_run_config(result["results_dir"]).env.action_size == 2
    assert result["behavior"].actor.action_size == 2


# -- evaluation ----------------------------------------------------------------------


def test_evaluate_policy(online_runs):
    """Greedy episodes of the online run's actor: one return per episode,
    finite statistics, the episodes' length; one seed gives one result."""
    result = online_runs["actor"][0]
    cfg = load_run_config(result["results_dir"])
    env = SyntheticEnv(length=5, seed=0)
    stats = [evaluate_policy(cfg, env, result["model"],
                             result["behavior"].actor, episodes=2, seed=1,
                             det=det) for det in (True, True, False)]
    assert stats[0] == stats[1]
    for s in stats:
        assert len(s["returns"]) == 2 and s["mean_steps"] == 5.0
        assert np.isfinite(s["mean_return"]) and np.isfinite(s["std_return"])
        assert len(s["final_rewards"]) == len(s["best_rewards"]) == 2


@pytest.mark.parametrize("policy", ["actor", "cem"])
def test_eval_policy_cli(online_runs, policy, capsys):
    run_dir = online_runs["actor"][0]["results_dir"]
    stats = cli_eval.main(["--run-dir", run_dir, "--episodes", "1",
                           "--env-length", "4", "--policy", policy,
                           "--device", "cpu", *PLANNER])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(stats))
    assert stats["mean_steps"] == 4.0


def test_eval_policy_refusals(online_runs, monkeypatch):
    """An environment whose action width differs from the run's raises;
    CEM on a run without a trained reward head raises; ``--stochastic``
    with CEM is a usage error."""
    run_dir = online_runs["actor"][0]["results_dir"]
    from multimodal_rssm_torch import envs

    make = envs.make_env
    monkeypatch.setattr(envs, "make_env", lambda name, length: zoo.GymAdapter(
        env=FakeGymnasium(), length=length) if name.startswith("gym")
        else make(name, length=length))
    with pytest.raises(ValueError, match="action_size"):
        cli_eval.main(["--run-dir", run_dir, "--env", "gym:fake",
                       "--device", "cpu"])
    with pytest.raises(ValueError, match="predict_reward"):
        cli_eval.main(["--run-dir", run_dir, "--policy", "cem", "--device",
                       "cpu", "rssm.predict_reward=false"])
    with pytest.raises(SystemExit):
        cli_eval.main(["--run-dir", run_dir, "--policy", "cem",
                       "--stochastic", "--device", "cpu"])


# -- train_behavior --------------------------------------------------------------------


@pytest.fixture(scope="module")
def world_model_run(tmp_path_factory):
    """A 2-step world-model run with a checkpoint, on a tiny synthetic
    set."""
    root = tmp_path_factory.mktemp("behavior")
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(root / "train"), 2, 30, shapes)
    write_synthetic_dataset(str(root / "val"), 1, 30, shapes, seed=9)
    result = cli_train.main([
        *SMALL, "train.train_iteration=2", "train.validation_interval=2",
        "train.checkpoint_interval=2", "train.train_data_path=[train]",
        "train.validation_data_path=[val]", "main.experiment_name=wm",
        "--device", "cpu", "--cwd", str(root)])
    return root, result["results_dir"]


@pytest.mark.parametrize("feed", ["true", "false"])
def test_train_behavior_cli(world_model_run, feed, monkeypatch):
    """Three behavior steps on the run's train set, on the device-resident
    and the host feed: finite metrics, K1 once per step (though the run
    says the shipped train.pallas_normalize=false), the checkpoint restores
    the returned state, and the world model's weights file is untouched."""
    root, run_dir = world_model_run
    assert load_run_config(run_dir).train.pallas_normalize is False
    calls = []
    wrapper = cuda_kernels.normalize_image
    monkeypatch.setattr(cuda_kernels, "normalize_image",
                        lambda *a: calls.append(a) or wrapper(*a))
    wm_file = os.path.join(run_dir, "models_2.pt")
    before = os.path.getmtime(wm_file)
    result = cli_behavior.main([
        "--run-dir", run_dir, "--cwd", str(root), "--device", "cpu",
        "behavior.train_iteration=3", "behavior.horizon=4",
        "behavior.checkpoint_interval=3", f"train.device_replay={feed}"])
    assert result["feed"] == ("device_resident" if feed == "true" else "host")
    assert len(calls) == 3 and len(result["step_seconds"]) == 3
    assert all(np.isfinite(v) for v in result["metrics"].values())
    assert os.path.getmtime(wm_file) == before
    cfg = bh.behavior_cfg(load_run_config(run_dir))
    bstate = bh.init_behavior_state(cfg, torch.device("cpu"), seed=9)
    path = os.path.join(result["out_dir"], "models_3.pt")
    assert ckpt.load_behavior_checkpoint(path, bstate) == 3
    assert bstate.step == result["state"].step == 3
    for k, v in result["state"].actor.state_dict().items():
        assert torch.equal(bstate.actor.state_dict()[k], v), k


def test_train_behavior_refuses_msgpack_and_unknown_value_head(
        world_model_run, tmp_path):
    """A ``.msgpack`` that is not a JAX package checkpoint (a real one
    loads: tests/test_torch_port_bridges.py) and an unknown value head."""
    root, run_dir = world_model_run
    bad = tmp_path / "models_2.msgpack"
    bad.write_bytes(b"\0")
    with pytest.raises(ValueError, match="not a JAX package checkpoint"):
        cli_behavior.main(["--run-dir", run_dir, "--cwd", str(root),
                           "--device", "cpu", "--model-path", str(bad)])
    with pytest.raises(ValueError, match="value_head"):
        cli_behavior.main(["--run-dir", run_dir, "--cwd", str(root),
                           "--device", "cpu", "behavior.value_head=mse"])


@pytest.mark.parametrize("cli", ["train_behavior", "train_online",
                                 "eval_policy"])
def test_control_clis_raise_without_gpu(cli, online_runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run_dir = online_runs["actor"][0]["results_dir"]
    main = {"train_behavior": cli_behavior.main,
            "train_online": cli_online.main, "eval_policy": cli_eval.main}[cli]
    args = [] if cli == "train_online" else ["--run-dir", run_dir]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
