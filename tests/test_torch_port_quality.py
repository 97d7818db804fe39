"""PyTorch port, the learning-parity gate: a run of training steps of the
port against the JAX package's, and the quality gate's helpers
(``cli/quality_gate.py``, ``cli/calibrate_quality_windows.py``) against the
JAX package's ``scripts/quality_gate.py`` / ``calibrate_quality_windows.py``.

The run: both packages at the gate's CPU widths (``quality_gate.TINY``),
float32, batch 2 x chunk 8 (the gate's batch 8 x chunk 20 takes 11 s a step
on one CPU thread), on the same start weights (``state_dict_from_jax``) and
the same batches: each step's raw batch sampled from the JAX package's
replay of a seeded synthetic set, its augmentation draws
(``HostAugmentDraws``) and the input pipeline's noise drawn on the JAX side,
the prepared batch handed to both.  The loss runs the deterministic path
(``key=None`` / generator None: zero latent noise), then a clip at 100 and
Adam at lr 1e-3, eps 1e-7, for ``STEPS`` = 30 steps; for the gate's
``default`` and ``categorical`` configs (the categorical run in
``test_torch_port_quality_categorical.py``).  Two readings:

- the free run: each package trains on its own for the 30 steps.  For
  the default config each step's loss is compared: step 1's (before any
  update) within rtol 1e-4, as ``test_torch_port_train.py``'s one step.
  After it the two runs' parameters part by float32 rounding, which Adam
  amplifies where a gradient lies within rounding of zero (a step of up
  to 2 lr either way), and the parting grows as the runs go on (measured:
  7e-5 at step 2, 1e-3 by step 10, 3.4e-2 at step 27, whether or not the
  port's Adam uses beta2 0.99 or its clip is halved): |loss_port -
  loss_jax| <= LOSS_RTOL(step) |loss_jax|, LOSS_RTOL(step) = 3e-3 (step -
  1) for step >= 2.  So the free run shows that the two runs learn alike
  (both losses fall below a fifth of the first), not that each step is
  right.  For the categorical config only that both learn is held (see
  ``test_free_run_learns_as_jax_does``);
- the forced run: at every one of the 30 steps the port starts from the
  JAX run's parameters, running statistics and Adam state (moments and
  count, ``io/checkpoint._load_adam``) of that step and takes the step on
  the same batch: its loss within rtol 1e-4 of JAX's (measured: at most
  1.6e-6 for either config), and at least ``FORCED_SHARE`` = 99 % of the
  parameter entries after the step within ``test_torch_port_train.py``'s
  one-step bound of JAX's (rtol 1e-5, atol 2e-5; measured: 99.87 % at
  step 1, where Adam's first step turns a gradient within rounding of
  zero into +-lr, and 100 % from step 4 on).  A wrong learning rate or
  Adam moment moves nearly every entry out of that bound.  The gradients'
  shares within ``test_torch_port_train.py``'s gradient bound are printed,
  not held: on these augmented (continuous-valued) frames they fall to
  65 % at the default config's step 1, where the one-step test's
  quantised random frames keep them within it; the loss and the
  parameters after each step are held.
"""

import argparse
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.cli import calibrate_quality_windows as calib
from multimodal_rssm_torch.cli import quality_gate as qg
from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io.checkpoint import _load_adam
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.train import trainer as tr
from tests.test_quality_gate_helpers import calib as jcalib
from tests.test_quality_gate_helpers import qg as jqg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 30
FORCED_SHARE = 0.99
B, L = 2, 8


def LOSS_RTOL(step: int) -> float:
    return 1e-4 if step == 1 else 3e-3 * (step - 1)


@pytest.fixture(autouse=True, scope="module")
def _learning_threads():
    """Under xdist (6 workers on 8 cores) the other port files take one
    torch thread each; the two learning runs (this file's and
    ``test_torch_port_quality_categorical.py``'s) take four.  They are the
    suite's longest runs, and the categorical one, in a file of two tests,
    is among the last that ``--dist loadfile`` hands out (it orders the
    files by their test counts), when most workers have finished."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(4)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))



def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def learning_run_for(config: str, tmp_path_factory) -> dict:
    """STEPS steps of both packages from the same weights on the same
    prepared batches: the JAX run's losses, the port's free run's, the
    forced steps' losses and, per forced step, the shares of gradient and
    parameter entries within the one-step bounds.  ``config`` names one
    of ``qg.CONFIGS``; each config's run is the ``learning_run`` fixture
    of a file of its own (this one: default;
    ``test_torch_port_quality_categorical.py``), so that xdist's
    ``--dist loadfile`` runs them on two workers.

    Each JAX state is laid out in the port's names once: the JAX run's
    parameters after a step are both what that forced step is held to and
    where the next forced step starts."""
    over = qg.TINY + [f"train.batch_size={B}", f"train.chunk_size={L}",
                      "train.experience_size=400",
                      *qg.CONFIGS[config][0]]
    jcfg = jax_compose(overrides=over + ["rssm.remat=false"])
    cfg = compose(overrides=over)
    ds = str(tmp_path_factory.mktemp("learning_ds"))
    write_synthetic_dataset(ds, 4, 80, {"image_horizon": [3, 64, 64],
                                        "sound": [128, 20]})
    jD = jax_buffer.build_buffer(jcfg, seed=0)
    jD.load_dataset(ds)
    spec = jtr.build_aug_spec(jD)
    draws = jtr.HostAugmentDraws(jD, spec, seed=0)
    bit_depth = int(jcfg.env.bit_depth)

    jm = JaxWorldModel.from_config(jcfg)
    batches = []
    for step in range(STEPS):
        obs, act, rew, nt = jD.sample(B, L)
        prep = jtr.prepare_observations(
            {k: jnp.asarray(v) for k, v in obs.items()}, spec,
            jax.tree_util.tree_map(jnp.asarray, draws.draw()), bit_depth,
            jax.random.fold_in(jax.random.PRNGKey(7), step))
        batches.append((_np_tree(prep), np.asarray(act, np.float32),
                        np.asarray(rew, np.float32),
                        np.asarray(nt, np.float32)))
    first = batches[0]
    variables = _np_tree(jax.jit(lambda k, o, a: jm.init(
        k, o, a, None, None, train=False))(
            jax.random.PRNGKey(1), {k: v[1:] for k, v in first[0].items()},
            first[1][:-1]))
    params, stats = variables["params"], variables["batch_stats"]

    loss_fn = jtr.make_loss_fn(jm, jcfg)
    optimizer = jtr.build_optimizer(jcfg)

    @jax.jit
    def jstep(params, stats, opt_state, batch):
        (loss, (stats, _)), grads = jax.value_and_grad(
            lambda p, s, b: loss_fn(p, s, b, None, True), has_aux=True)(
                params, stats, batch)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), stats, opt_state, loss,
                grads, optax.global_norm(grads))

    def port_state(params, stats):
        return state_dict_from_jax(_np_tree(params), _np_tree(stats))

    def port_step(model, opt, sched, batch, keep_grads):
        """One step; returns (loss, the gradients before the clip, or
        None)."""
        obs, act, rew, nt = batch
        loss, _ = tr.make_loss_fn(model, cfg)(
            ({k: _t(v) for k, v in obs.items()}, _t(act), _t(rew), _t(nt)),
            None, True)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = ({n: p.grad.clone() for n, p in model.named_parameters()
                  if p.grad is not None} if keep_grads else None)
        tr.apply_gradients(model, opt, sched, float(cfg.rssm.grad_clip_norm))
        return float(loss.detach()), grads

    @torch.no_grad()
    def share(got, want, what):
        """The share of ``want``'s entries that ``got`` holds within the
        one-step bounds: the gradients rtol 1e-4, atol 1e-5 x the tensor's
        largest; the parameters after the step rtol 1e-5, atol 2e-5 (a
        missing ``got`` counts as zeros)."""
        n_ok = n_all = 0
        for name, w in want.items():
            w = w.contiguous()   # a converted Linear's is a transposed view
            g = got.get(name)
            g = torch.zeros_like(w) if g is None else g.detach()
            tol = w.abs()
            if what == "params":
                tol.mul_(1e-5).add_(2e-5)
            else:
                atol = 1e-5 * tol.max()
                tol.mul_(1e-4).add_(atol)
            n_ok += int(torch.le((g - w).abs_(), tol).sum())
            n_all += w.numel()
        return n_ok / n_all

    free = WorldModel.from_config(cfg)
    start = port_state(params, stats)   # the JAX run's state at step 1
    free.load_state_dict(start)
    free_opt, free_sched = tr.build_optimizer(cfg, free)
    forced = WorldModel.from_config(cfg)
    forced_opt, forced_sched = tr.build_optimizer(cfg, forced)
    param_names = [n for n, _ in forced.named_parameters()]

    out = {"jax": [], "free": [], "forced": [], "forced_grads": [],
           "forced_params": []}
    opt_state = optimizer.init(params)
    for batch in batches:
        forced.load_state_dict(start)
        if out["jax"]:   # the JAX run's Adam state at this step
            _load_adam(forced_opt, forced, _np_tree(
                flax.serialization.to_state_dict(opt_state)),
                lambda tree: state_dict_from_jax(tree, None), "jax")
        floss, fgrads = port_step(forced, forced_opt, forced_sched, batch,
                                  True)
        out["forced"].append(floss)
        params, stats, opt_state, jloss, grads, _ = jstep(
            params, stats, opt_state,
            jax.tree_util.tree_map(jnp.asarray, batch))
        out["jax"].append(float(jloss))
        out["free"].append(port_step(free, free_opt, free_sched, batch,
                                     False)[0])
        start = port_state(params, stats)
        out["forced_grads"].append(share(
            fgrads, state_dict_from_jax(_np_tree(grads), None), "grads"))
        out["forced_params"].append(share(
            dict(forced.named_parameters()),
            {n: start[n] for n in param_names}, "params"))
    out["config"] = config
    return out


@pytest.fixture(scope="module", params=["default"])
def learning_run(request, tmp_path_factory):
    return learning_run_for(request.param, tmp_path_factory)


def test_free_run_learns_as_jax_does(learning_run):
    """Both runs learn (the last loss under a fifth of the first); for the
    default config each of the STEPS losses of the port's own run within
    LOSS_RTOL(step) of the JAX run's.  The categorical latent's mode is an
    argmax, so a rounding difference flips a class and the free runs part
    by steps (1e-2 at step 4, 0.16 at step 29): there the forced run holds
    each step."""
    jl, pl = np.asarray(learning_run["jax"]), np.asarray(learning_run["free"])
    rel = np.abs(pl - jl) / np.abs(jl)
    print(f"{learning_run['config']} free run, relative loss gaps by step:",
          " ".join(f"{r:.2e}" for r in rel))
    if learning_run["config"] == "default":
        for step, (r, j, p) in enumerate(zip(rel, jl, pl), start=1):
            assert r <= LOSS_RTOL(step), (step, p, j, r, LOSS_RTOL(step))
    assert jl[-1] < 0.2 * jl[0] and pl[-1] < 0.2 * pl[0]


def test_forced_run_matches_jax_at_every_step(learning_run):
    """Every step of the JAX run, taken by the port from JAX's state: the
    loss within rtol 1e-4, and at least ``FORCED_SHARE`` of the gradient
    and of the parameter entries after the step within the one-step
    bounds (the shares are printed by step)."""
    jl = np.asarray(learning_run["jax"])
    rel = np.abs(np.asarray(learning_run["forced"]) - jl) / np.abs(jl)
    print(f"{learning_run['config']} forced run, relative loss gaps by step:",
          " ".join(f"{r:.2e}" for r in rel))
    for what in ("grads", "params"):
        print(f"forced run, share of {what} entries within bounds by step:",
              " ".join(f"{w:.5f}" for w in learning_run[f"forced_{what}"]))
    assert len(jl) == STEPS
    for step, (r, g, p) in enumerate(zip(rel, learning_run["forced_grads"],
                                         learning_run["forced_params"]),
                                     start=1):
        assert r <= 1e-4, (step, r)
        assert p >= FORCED_SHARE, (step, p, g)


@pytest.mark.parametrize("variant", ["default", "categorical", "img256"])
def test_init_draws_as_the_jax_package_does(variant):
    """``init_parameters`` draws each tensor from the JAX package's
    initialiser (``state_dict_from_jax`` lays JAX's init out in the port's
    names): a zero or one tensor in JAX is so in the port; a GRU tensor
    lies in [0, 1/sqrt(hidden)); every other tensor of n >= 64 entries
    has the standard deviation of JAX's draw within max(5 %, 4 / sqrt(n))
    (four standard errors of the ratio of two sample deviations) and its
    largest
    magnitude within 10 % of JAX's (both truncate at two standard
    deviations; a Linear joined from two JAX Dense layers draws each input
    block with its own fan-in).  (The first training runs on
    the card drew as torch does, +-1/sqrt(fan_in) with random biases, and
    started from a loss 1.5-1.9x the JAX package's: ``PERF.md`` §6.)"""
    extra = {"default": [], "categorical": ["rssm.latent_dist=categorical"],
             "img256": ["rssm.normalization=GroupNorm",
                        "rssm.observation_names_enc=[image_horizon_256,sound]",
                        "rssm.observation_names_rec=[image_horizon_256,sound]"]
             }[variant]
    over = qg.TINY + ["rssm.predict_reward=true", *extra]
    jcfg = jax_compose(overrides=over + ["rssm.remat=false"])
    cfg = compose(overrides=over)
    jm = JaxWorldModel.from_config(jcfg)
    names = list(cfg.rssm.observation_names_enc)
    rng = np.random.default_rng(0)
    obs = {}
    for n in names:
        shape = cfg.env.observation_shapes[n]
        obs[n] = (rng.uniform(-.5, .5, (3, 2, *shape[1:], shape[0]))
                  if "image" in n else rng.normal(size=(3, 2, *shape))
                  ).astype(np.float32)
    act = rng.normal(size=(3, 2, 3)).astype(np.float32)
    variables = _np_tree(jax.jit(lambda k: jm.init(
        k, obs, act, None, None, train=False))(jax.random.PRNGKey(0)))
    want = state_dict_from_jax(variables["params"], None)
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    checked = 0
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        if not w.any():
            assert not got.any(), name
        elif np.all(w == 1.0):
            assert np.all(got == 1.0), name
        elif "weight_ih" in name or "weight_hh" in name or "bias_h" in name \
                or "bias_i" in name:
            bound = 1.0 / np.sqrt(cfg.rssm.belief_size)
            assert got.min() >= 0.0 and got.max() < bound, name
            assert w.min() >= 0.0 and w.max() < bound, name
        elif w.size >= 64:
            tol = max(0.05, 4 / np.sqrt(w.size))
            assert abs(got.std() / w.std() - 1) < tol, (name, got.std(),
                                                        w.std())
            assert np.abs(got).max() <= 1.1 * np.abs(w).max(), name
            checked += 1
    assert checked > 20


# -- the gate's helpers against the JAX package's script ------------------------


def test_config_matrix_is_the_jax_gates():
    assert qg.CONFIGS == jqg.CONFIGS
    assert qg.TINY == jqg.TINY


def test_tpu_windows_are_the_jax_packages():
    """The port's windows file carries the JAX package's tpu* blocks
    unchanged; its own blocks are keyed cuda* / cpu*."""
    with open(os.path.join(REPO, "scripts", "quality_windows.json")) as f:
        jax_windows = json.load(f)
    windows = qg.load_windows()
    tpu = {k for k in jax_windows if k.startswith("tpu")}
    assert tpu == {"tpu", "tpu_categorical", "tpu_chunk200"}
    for k in tpu:
        assert windows[k] == jax_windows[k], k
    for k in windows:
        assert k == "_comment" or k.startswith(("tpu", "cuda", "cpu")), k


@pytest.mark.parametrize("case", ["missing", "out_of_band", "nan", "inside"])
def test_check_windows_matches_jax(case):
    windows = {"a": [0.0, 1.0], "b": [5.0, 6.0], "_calibration": {"x": 1}}
    metrics = {"missing": {"a": 0.5}, "out_of_band": {"a": 2.0, "b": 5.5},
               "nan": {"a": float("nan"), "b": 5.5},
               "inside": {"a": 0.0, "b": 6.0}}[case]
    got = qg.check_windows(metrics, windows)
    assert got == jqg.check_windows(metrics, windows)
    assert len(got) == (0 if case == "inside" else 1)


@pytest.mark.parametrize("rows", ["empty", "train_only", "full", "no_analysis"])
def test_collect_metrics_matches_jax(tmp_path, rows):
    """Truncated artifacts (an empty metrics.jsonl, no validation row, no
    analysis) leave keys out, never raise; both scripts read the same."""
    lines = {"empty": [],
             "train_only": [{"step": 1, "loss/train": 100.0}],
             "full": [{"step": 1, "loss/train": 100.0},
                      {"step": 2, "loss/train": 50.0},
                      {"step": 2, "loss/validation": 60.0},
                      {"step": 4, "loss/validation": float("nan")}],
             "no_analysis": [{"step": 1, "loss/train": 9.0},
                             {"step": 1, "loss/validation": 8.0}]}[rows]
    (tmp_path / "metrics.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in lines))
    if rows == "full":
        (tmp_path / "analysis").mkdir()
        (tmp_path / "analysis" / "imagination_mse.json").write_text(
            json.dumps({"mse": {"image_horizon": 0.02, "sound": 0.1},
                        "metrics": {"image_horizon": {
                            "mse": 0.02, "psnr": 17.0, "ssim": 0.5}}}))
    got = qg.collect_metrics(str(tmp_path))
    want = jqg.collect_metrics(str(tmp_path))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if rows == "empty":
        assert qg.check_windows(got, {"train_loss_first": [0, 1]}) == [
            "train_loss_first: metric missing from run artifacts"]
    if rows == "full":
        assert got["val_rows_finite"] == 0.0
        assert got["imagination_psnr_image_horizon"] == 17.0


def test_derive_windows_matches_jax_and_covers_every_seed():
    rng = np.random.default_rng(3)
    per_seed = {s: {"train_loss_final": float(rng.uniform(15, 25)),
                    "imagination_ssim_image_horizon": float(rng.uniform(.3, .6)),
                    "imagination_psnr_sound": float(rng.uniform(5, 20)),
                    "val_rows_finite": 1.0} for s in (0, 1, 2)}
    per_seed[2]["extra"] = 3.0
    block = calib.derive_windows(per_seed)
    assert block == jcalib.derive_windows(per_seed)
    for name, (lo, hi) in block.items():
        if name.startswith("_"):
            continue
        for vals in per_seed.values():
            if name in vals:
                assert lo <= vals[name] <= hi, name
    assert block["val_rows_finite"] == [1.0, 1.0]
    assert block["_calibration"]["seeds"] == [0, 1, 2]
    assert block["_calibration"]["values"]["extra"] == {
        "0": None, "1": None, "2": 3.0}


def test_calibrate_merges_derived_blocks(monkeypatch, tmp_path):
    """``--jobs 2 --write`` runs every (config, seed) cell (datasets first),
    keys the blocks by device and config suffix and merges them into the
    windows file, leaving the tpu* blocks alone."""
    path = tmp_path / "windows.json"
    path.write_text(json.dumps({"tpu": {"a": [0, 1]}}))
    monkeypatch.setattr(qg, "WINDOWS_PATH", str(path))
    built, ran = [], []
    monkeypatch.setattr(qg, "build_dataset",
                        lambda root, seed, length: built.append(
                            (seed, length)))

    def fake_run(ns: argparse.Namespace):
        ran.append((ns.config, ns.seed, ns.device))
        run_dir = tmp_path / f"{ns.config}{ns.seed}"
        run_dir.mkdir()
        (run_dir / "metrics.jsonl").write_text(json.dumps(
            {"step": 1, "loss/train": 10.0 + ns.seed}) + "\n")
        return str(run_dir)

    monkeypatch.setattr(qg, "train_and_eval", fake_run)
    out = calib.main(["--seeds", "0", "1", "--configs", "default",
                      "chunk200", "--device", "cpu", "--jobs", "2",
                      "--workdir", str(tmp_path / "w"), "--write"])
    assert sorted(built) == [(0, 80), (0, 300), (1, 80), (1, 300)]
    assert sorted(ran) == [("chunk200", 0, "cpu"), ("chunk200", 1, "cpu"),
                           ("default", 0, "cpu"), ("default", 1, "cpu")]
    assert set(out) == {"cpu", "cpu_chunk200"}
    assert out["cpu"]["train_loss_first"] == [6.5, 16.5]
    written = json.loads(path.read_text())
    assert written["tpu"] == {"a": [0, 1]}
    assert written["cpu"] == out["cpu"]


def test_gate_exit_codes(monkeypatch, tmp_path, capsys):
    """0 inside every window, 1 on a miss (each printed), 2 without
    windows for the key; the last line is the JSON summary with the tpu
    reading."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    (run_dir / "metrics.jsonl").write_text(
        json.dumps({"step": 1, "loss/train": 10.0}) + "\n")
    monkeypatch.setattr(qg, "train_and_eval", lambda args: str(run_dir))
    path = tmp_path / "windows.json"
    monkeypatch.setattr(qg, "WINDOWS_PATH", str(path))
    argv = ["--device", "cpu", "--workdir", str(tmp_path / "w")]
    for windows, rc in (({"cpu": {"train_loss_first": [5, 20]},
                          "tpu": {"train_loss_first": [50, 60]}}, 0),
                        ({"cpu": {"train_loss_first": [11, 20]}}, 1),
                        ({"cuda": {}}, 2)):
        path.write_text(json.dumps(windows))
        assert qg.main(argv) == rc
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["rc"] == rc and summary["metrics"] == {
            "train_loss_first": 10.0, "train_loss_final": 10.0}
        if rc == 0:
            assert summary["tpu_failures"] == [
                "train_loss_first: 10.0 outside [50, 60]"]
