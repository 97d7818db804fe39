"""PyTorch port, the RSSM's model variants beyond the loss step, held
against the JAX package at the ``bench.py --small`` widths in float32
(categorical: V = K = 4; helpers and models from
``test_torch_port_variants``):

- ``ops/categorical.py`` function by function on NumPy-made logits and
  Gumbel noise (rtol 1e-5, atol 1e-6; the straight-through gradient
  too), and ``gumbel_noise`` from a ``torch.Generator`` by its
  distribution: JAX draws with its own generator.  1e6 draws: the mean
  within 0.005 of the Euler-Mascheroni constant (4 standard errors), the
  variance within 0.02 of pi^2 / 6 (6 standard errors);
- ``fusion.poe_posterior`` and NN = PoE at the posterior, Gaussian and
  categorical; the categorical ELBO terms and their gradients (rtol 1e-5);
- inference in eval mode for the unimodal and the categorical model:
  ``estimate_state_from`` and ``filter_step`` (one step: rtol 1e-5, atol
  5e-5), ``rollout_prior`` and ``imagine`` (rollouts: rtol 1e-4, atol
  1e-4), at zero noise and with one noise draw given to both; the
  streaming filter against the sequence estimate for every variant;
- the weight bridge: exact against ``export_world_model`` where it exports
  (unimodal, PoE), and every JAX leaf in exactly one port tensor where it
  refuses (q(st|ot), categorical);
- a unimodal reference ``.pth`` from the JAX exporter through
  ``train.model_path`` and ``estimate_state`` (exact), the eval CLIs on
  unimodal and categorical runs, and the refusals.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.eval import imagination as jim
from multimodal_rssm_tpu.io.torch_export import (
    export_world_model, save_reference_checkpoint)
from multimodal_rssm_tpu.losses import elbo as jelbo
from multimodal_rssm_tpu.ops import categorical as jcat
from multimodal_rssm_tpu.ops import fusion as jfusion

from multimodal_rssm_torch.cli import check_model as cli_check
from multimodal_rssm_torch.cli import estimate_state as cli_estimate
from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose, save_config
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.eval import imagination
from multimodal_rssm_torch.eval import state_estimation as se
from multimodal_rssm_torch.eval.streaming import OnlineFilter
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.losses import elbo
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.ops import categorical as cat
from multimodal_rssm_torch.ops import fusion

from tests.test_torch_port_variants import (
    CAT, ONE, QOT, ROLL, SMALL, VARIANTS, _close_tree, _configs, _models, _np,
    _np_tree, _observations, _t)

A = 3
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


# -- ops/categorical.py -------------------------------------------------------


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.fixture(scope="module")
def logits():
    """Normalised expert logits [E=3, T=2, B=2, V=5, K=4], raw logits of the
    same shape and Gumbel noise [T, B, V, K], from NumPy."""
    rng = np.random.default_rng(11)
    raw = rng.normal(scale=2.0, size=(3, 2, 2, 5, 4)).astype(np.float32)
    return (_log_softmax(raw), raw,
            rng.gumbel(size=(2, 2, 5, 4)).astype(np.float32))


CAT_FUNCTIONS = {
    "normalize_logits": (lambda m, a, r, g: m.normalize_logits(r[0]),),
    "normalize_logits_unimix": (
        lambda m, a, r, g: m.normalize_logits(r[0], 0.01),),
    "flatten_state": (lambda m, a, r, g: m.flatten_state(a[0]),),
    "unflatten_state": (
        lambda m, a, r, g: m.unflatten_state(m.flatten_state(a[0]), 5, 4),),
    "kl_categorical": (lambda m, a, r, g: m.kl_categorical(a[1], a[2]),),
    "kl_uniform": (lambda m, a, r, g: m.kl_uniform(a[1]),),
    "poe_logits": (lambda m, a, r, g: m.poe_logits(a),),
    "subset_poe_logits": (lambda m, a, r, g: m.subset_poe_logits(a),),
    "mopoe_logits": (lambda m, a, r, g: m.mopoe_logits(a),),
    "fuse_logits_NN": (lambda m, a, r, g: m.fuse_logits("NN", a),),
    "fuse_logits_PoE": (lambda m, a, r, g: m.fuse_logits("PoE", a),),
    "fuse_logits_MoPoE": (lambda m, a, r, g: m.fuse_logits("MoPoE", a),),
    "st_sample": (lambda m, a, r, g: m.st_sample(a[0], g),),
}


@pytest.mark.parametrize("name", list(CAT_FUNCTIONS))
def test_categorical_ops_match_jax(name, logits):
    (fn,) = CAT_FUNCTIONS[name]
    a, r, g = logits
    want = fn(jcat, jnp.asarray(a), jnp.asarray(r), jnp.asarray(g))
    got = fn(cat, _t(a), _t(r), _t(g))
    if isinstance(want, list):
        assert len(got) == len(want) == 4
    else:
        got, want = [got], [want]
    for x, y in zip(got, want):
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_allclose(_np(x), np.asarray(y), **TOL)


def test_st_sample_is_a_one_hot_with_the_probabilities_gradient(logits):
    """Forward the one-hot of argmax(logits + noise) (the mode at zero
    noise), backward through the probabilities: the gradient of a weighted
    sum equals JAX's."""
    a, _, g = logits
    w = np.random.default_rng(12).normal(size=a[0].shape).astype(np.float32)
    x = _t(a[0]).requires_grad_()
    sample = cat.st_sample(x, _t(g))
    (sample * _t(w)).sum().backward()
    want = jax.grad(lambda lg: jnp.sum(jcat.st_sample(lg, jnp.asarray(g))
                                       * w))(jnp.asarray(a[0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), **TOL)
    onehot = np.eye(4, dtype=np.float32)[np.argmax(a[0] + g, -1)]
    np.testing.assert_allclose(_np(sample), onehot, atol=1e-6)
    mode = cat.st_sample(_t(a[0]), torch.zeros(a[0].shape))
    np.testing.assert_allclose(_np(mode),
                               np.eye(4)[np.argmax(a[0], -1)], atol=1e-6)


def test_gumbel_noise_has_the_gumbel_distribution():
    """From a ``torch.Generator`` on the CPU: the standard Gumbel's mean
    and variance, finite everywhere, the same draws from the same seed and
    other draws from another."""
    g = torch.Generator().manual_seed(0)
    x = cat.gumbel_noise(g, (1000, 1000)).double()
    assert torch.isfinite(x).all()
    assert abs(float(x.mean()) - 0.5772156649) < 0.005
    assert abs(float(x.var()) - math.pi ** 2 / 6) < 0.02
    a = cat.gumbel_noise(torch.Generator().manual_seed(3), (4, 5))
    assert torch.equal(a, cat.gumbel_noise(torch.Generator().manual_seed(3),
                                           (4, 5)))
    assert not torch.equal(a, cat.gumbel_noise(
        torch.Generator().manual_seed(4), (4, 5)))


# -- fusion and the categorical ELBO terms ------------------------------------


def test_poe_posterior_and_nn_equal_poe_match_jax():
    """NN runs PoE at the posterior (the reference's routing), for the
    Gaussian experts and the categorical ones."""
    rng = np.random.default_rng(13)
    m = rng.normal(size=(3, 4, 2, 8)).astype(np.float32)
    s = rng.uniform(0.1, 2.0, size=(3, 4, 2, 8)).astype(np.float32)
    want = jfusion.poe_posterior(jnp.asarray(m), jnp.asarray(s))
    got = fusion.poe_posterior(_t(m), _t(s))
    for x, y in zip(got, want):
        np.testing.assert_allclose(_np(x), np.asarray(y), **TOL)
    for x, y in zip(fusion.fuse("NN", _t(m), _t(s)), got):
        assert torch.equal(x, y)
    lg = _t(_log_softmax(rng.normal(size=(3, 4, 2, 5, 4))))
    assert torch.equal(cat.fuse_logits("NN", lg), cat.fuse_logits("PoE", lg))


ELBO_CASES = {
    "kl_balanced_categorical_plain": (
        lambda m, q, p, e: m.kl_balanced_categorical(q, p, None, 0.5)),
    "kl_balanced_categorical_alpha": (
        lambda m, q, p, e: m.kl_balanced_categorical(q, p, 0.8, 0.5)),
    "mopoe_kl_categorical": (
        lambda m, q, p, e: m.mopoe_kl_categorical(e, p, 0.5)),
    "global_kl_categorical": (
        lambda m, q, p, e: m.global_kl_categorical(q)),
}


@pytest.mark.parametrize("name", list(ELBO_CASES))
def test_categorical_elbo_terms_and_gradients_match_jax(name):
    """Value and gradient with respect to every input (free nats 0.5, so
    that rows both above and below it occur)."""
    fn = ELBO_CASES[name]
    rng = np.random.default_rng(14)
    q, p = (_log_softmax(rng.normal(scale=s, size=(3, 2, 5, 4)))
            for s in (1.0, 0.3))
    e = _log_softmax(rng.normal(size=(3, 3, 2, 5, 4)))     # [T, E, B, V, K]
    want, jgrads = jax.value_and_grad(
        lambda *xs: fn(jelbo, *xs), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(e))
    xs = [_t(v).requires_grad_() for v in (q, p, e)]
    got = fn(elbo, *xs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for x, jg in zip(xs, jgrads):
        gx = np.zeros_like(np.asarray(jg)) if x.grad is None else x.grad
        np.testing.assert_allclose(_np(gx), np.asarray(jg), **TOL)


# -- inference ----------------------------------------------------------------


def _noise_patch(monkeypatch, draws):
    """Both packages' ``draw_state_noise`` return ``draws`` in order."""
    from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWM

    jit, pit = iter(draws), iter(draws)
    monkeypatch.setattr(JaxWM, "draw_state_noise",
                        lambda self, key, T, B: jnp.asarray(next(jit)))
    monkeypatch.setattr(WorldModel, "draw_state_noise",
                        lambda self, g, T, B: _t(next(pit)))


def _noise(rng, port, T, Bn):
    shape = port.noise_shape(T, Bn)
    if port.latent_dist == "categorical":
        return rng.gumbel(size=shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


def _inputs(rng, port, T, Bn):
    return (_observations(rng, T, Bn, port.observation_names_enc),
            rng.normal(size=(T, Bn, A)).astype(np.float32),
            (rng.uniform(size=(T, Bn, 1)) > 0.2).astype(np.float32),
            rng.normal(size=(Bn, 64)).astype(np.float32),
            np.eye(port.state_size, dtype=np.float32)[
                rng.integers(0, port.state_size, Bn)])


INFERENCE = ("unimodal", "cat_mopoe", "cat_unimodal")


@pytest.mark.parametrize("eps", ["zero", "shared"])
@pytest.mark.parametrize("variant", INFERENCE)
def test_estimate_state_from_and_filter_step_match_jax(variant, eps,
                                                       monkeypatch):
    """From a given belief and state, in eval mode, over 4 steps and over
    one frame: every key (the expert logits of a multimodal categorical
    model included)."""
    jm, variables, port = _models(variant)
    port.eval()
    rng = np.random.default_rng(1)
    shared = eps == "shared"
    obs, act, nt, h0, s0 = _inputs(rng, port, 4, 2)
    if shared:
        _noise_patch(monkeypatch, [_noise(rng, port, 4, 2) for _ in range(2)]
                     + [_noise(rng, port, 1, 2) for _ in range(2)])
    key = jax.random.PRNGKey(0) if shared else None
    want = jm.apply(variables, h0, s0, obs, act, nt, key, not shared, False,
                    method=jm.estimate_state_from)
    want1 = jm.apply(variables, h0, s0, act[0],
                     {k: v[0] for k, v in obs.items()}, nt[0], key,
                     not shared, False, method=jm.filter_step)
    g = torch.Generator() if shared else None
    with torch.no_grad():
        got = port.estimate_state_from(_t(h0), _t(s0),
                                       {k: _t(v) for k, v in obs.items()},
                                       _t(act), _t(nt), g)
        got1 = port.filter_step(_t(h0), _t(s0), _t(act[0]),
                                {k: _t(v[0]) for k, v in obs.items()},
                                _t(nt[0]), g)
    _close_tree(got, _np_tree(want), ONE)
    _close_tree(got1, _np_tree(want1), ONE)
    if variant == "cat_mopoe":
        assert set(got["expert_logits"]) == {"prior_expert", "image_horizon",
                                             "sound"}
        assert got["expert_logits_stacked"].shape == (4, 3, 2, 4, 4)


@pytest.mark.parametrize("eps", ["zero", "shared"])
@pytest.mark.parametrize("variant", INFERENCE)
def test_rollout_prior_matches_jax(variant, eps, monkeypatch):
    """A 20-step open-loop rollout with episode starts inside it: the
    carry is the sample (with noise) or the mean / the mode one-hot."""
    jm, variables, port = _models(variant)
    rng = np.random.default_rng(3)
    _, act, nt, h0, s0 = _inputs(rng, port, 20, 2)
    shared = eps == "shared"
    if shared:
        _noise_patch(monkeypatch, [_noise(rng, port, 20, 2)])
    want = _np_tree(jm.apply(variables, h0, s0, act, nt,
                             jax.random.PRNGKey(0), not shared,
                             method=jm.rollout_prior))
    with torch.no_grad():
        got = port.rollout_prior(_t(h0), _t(s0), _t(act), _t(nt),
                                 torch.Generator() if shared else None)
    _close_tree(got, want, ROLL)


@pytest.mark.parametrize("variant", INFERENCE)
def test_imagine_matches_jax(variant):
    """On JAX's det states of a 30-step sequence: a 20-step imagination
    from step 5, its rollout and its decoded predictions; for the
    categorical latent from the mode one-hots, not the probabilities."""
    jm, variables, port = _models(variant)
    port.eval()
    rng = np.random.default_rng(4)
    obs, act, nt, _, _ = _inputs(rng, port, 30, 1)
    states = _np_tree(jm.apply(variables, obs, act, nt, None, True, False,
                               method=jm.estimate_state))
    flat = {k: _t(v) for k, v in states.items() if not isinstance(v, dict)}
    roll, preds = imagination.imagine(port, flat, _t(act), 5, 20)
    jroll, jpreds = jim.imagine(jm, variables, states, jnp.asarray(act), 5,
                                20)
    _close_tree(roll, _np_tree(jroll), ROLL)
    assert set(preds) == set(jpreds) == set(port.observation_names_rec)
    for name in preds:
        np.testing.assert_allclose(_np(preds[name]["loc"]),
                                   np.asarray(jpreds[name]["loc"]), **ROLL)
    if port.latent_dist == "categorical":
        start = _np(flat["posterior_states"][5])
        assert np.abs(start - np.round(start)).max() < 1e-6   # a one-hot
        assert not np.allclose(start, _np(flat["posterior_means"][5]))


@pytest.mark.parametrize("variant", ["poe", "qot_poe", "qot_mopoe",
                                     "cat_mopoe"])
def test_cross_modal_view_matches_jax(variant):
    """The sound-only posterior (the prior expert and the sound expert) on
    the full model's weights, against JAX's ``cross_modal_model``: PoE of
    two experts, and for q(st|ot) the sound head in the encoder."""
    jm, variables, port = _models(variant)
    port.eval()
    rng = np.random.default_rng(6)
    obs, act, nt, _, _ = _inputs(rng, port, 6, 2)
    jview = jim.cross_modal_model(jm, ("sound",))
    want = jview.apply(variables, {"sound": obs["sound"]}, act, nt, None,
                       True, False, method=jview.estimate_state)
    view = imagination.cross_modal_model(port, ("sound",))
    with torch.no_grad():
        got = view.estimate_state({"sound": _t(obs["sound"])}, _t(act),
                                  _t(nt))
    key = ("expert_logits" if variant.startswith("cat") else
           "expert_means")
    assert set(got[key]) == {"prior_expert", "sound"}
    _close_tree(got, _np_tree(want), ROLL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_online_filter_matches_the_sequence_estimate(variant):
    """Frame by frame, every variant's streaming filter gives its det
    sequence estimate (the port against itself, rtol 1e-4)."""
    _, cfg = _configs(variant)
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    rng = np.random.default_rng(5)
    obs, act, nt, _, _ = _inputs(rng, model, 8, 1)
    with torch.no_grad():
        seq = model.estimate_state({k: _t(v) for k, v in obs.items()},
                                   _t(act), _t(nt))
    filt = OnlineFilter(model)
    steps = [filt.step(_t(act[t]), {k: _t(v[t]) for k, v in obs.items()},
                       _t(nt[t])) for t in range(8)]
    for key in seq:
        if isinstance(seq[key], dict):
            continue
        np.testing.assert_allclose(
            _np(torch.stack([s[key] for s in steps])), _np(seq[key]),
            err_msg=key, **ROLL)
    assert set(filt.decode()) == set(model.observation_names_rec)


# -- the weight bridge --------------------------------------------------------


def _flatten_export(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix if k == "main" else (f"{prefix}.{k}" if prefix else k)
        if isinstance(v, dict):
            out.update(_flatten_export(v, key))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("variant", ["unimodal", "poe", "nn"])
def test_state_dict_from_jax_matches_exporter(variant):
    """Leaf for leaf against the JAX package's torch exporter, exactly: the
    unimodal flat schema, and the multimodal one for PoE / NN."""
    jm, variables, port = _models(variant)
    want = _flatten_export(export_world_model(jm, variables))
    got = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(got) == set(want) == set(port.state_dict())
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    if variant == "unimodal":
        assert "transition_model.obs_encoder.fc1.weight" in got
        assert "encoder.conv.0.weight" in got


@pytest.mark.parametrize("variant", ["qot_mopoe", "qot_poe", "cat_mopoe",
                                     "cat_unimodal"])
def test_state_dict_from_jax_places_every_leaf_once(variant):
    """Where the exporter refuses: the port's names exactly, every JAX
    element in one port tensor (the split Linears re-joined), and the
    tensors equal to the JAX leaves they came from."""
    jm, variables, port = _models(variant)
    with pytest.raises((ValueError, NotImplementedError)):
        export_world_model(jm, variables)
    got = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(got) == set(port.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    joined = [p for p, _ in leaves
              if any(getattr(k, "key", None) in ("fc_sa_a",)
                     or str(getattr(k, "key", "")).startswith("obs_proj")
                     for k in p)]
    tensors = {k: v for k, v in got.items()
               if not k.endswith("num_batches_tracked")}
    assert len(leaves) - len(joined) == len(tensors)
    assert sum(np.size(v) for _, v in leaves) == sum(
        v.numel() for v in tensors.values())
    if variant.startswith("qot"):
        head = variables["params"]["encoder"]["sound_head"]["fc2"]
        assert np.array_equal(got["encoder.sound_head.fc2.weight"].numpy(),
                              np.asarray(head["kernel"]).T)
        assert not any(k.startswith("transition_model.obs_encoder.sound")
                       for k in got)
    else:
        cell = variables["params"]["core"]["cell"]
        assert got["transition_model.stochastic_state_model.fc2.weight"
                   ].shape == (16, 64)
        assert np.array_equal(
            got["transition_model.stochastic_state_model.fc2.weight"].numpy(),
            np.asarray(cell["ssm_fc2"]["kernel"]).T)


# -- reference .pth, the eval CLIs, refusals ----------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("variants_data")
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(root / "train"), 2, 30, shapes)
    write_synthetic_dataset(str(root / "val"), 1, 30, shapes, seed=9)
    return root


def _args(data_dir, variant, *extra):
    return SMALL + VARIANTS[variant] + [
        f"train.train_data_path=[{data_dir}/train]",
        f"train.validation_data_path=[{data_dir}/val]", "train.batch_size=2",
        "train.chunk_size=4", "train.validation_interval=2",
        "train.experience_size=200", *extra, "--device", "cpu", "--cwd",
        str(data_dir)]


def test_unimodal_reference_pth_loads_through_model_path_and_estimate_state(
        data_dir):
    """A unimodal ``models_{itr}.pth`` from the JAX exporter (the flat
    reference schema) starts a port run through ``train.model_path`` and is
    evaluated by ``estimate_state``: both models hold
    ``state_dict_from_jax`` of the same variables, exactly."""
    jm, variables, _ = _models("unimodal")
    save_reference_checkpoint(str(data_dir / "models_100.pth"), jm, variables)
    assert "transition_model" not in torch.load(
        data_dir / "models_100.pth", weights_only=True)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"])
    result = cli_train.main(_args(data_dir, "unimodal",
                                  "train.train_iteration=0",
                                  "train.model_path=models_100.pth",
                                  "main.experiment_name=pth_uni"))
    cfg = compose(overrides=SMALL + VARIANTS["unimodal"] + [
        f"train.train_data_path=[{data_dir}/train]"])
    run_dir = data_dir / "uni_pth_run"
    run_dir.mkdir()
    save_config(cfg, str(run_dir / "hydra_config.yaml"))
    os.link(data_dir / "models_100.pth", run_dir / "models_100.pth")
    evaluated = se.load_eval_model(cfg, str(run_dir / "models_100.pth"),
                                   torch.device("cpu"))
    saved = cli_estimate.main(["--targets", str(data_dir), "--itr", "100",
                               "--cwd", str(data_dir), "--device", "cpu"])
    assert saved == [str(run_dir / "states_models_100.npy")]
    states = np.load(saved[0], allow_pickle=True).item()
    assert len(states) == 2 and all(
        s["beliefs"].shape == (29, 1, 64) and "expert_means" not in s
        for s in states.values())
    for model in (result["model"], evaluated):
        got = model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("variant", ["unimodal", "cat_mopoe"])
def test_eval_clis_on_a_trained_variant(data_dir, variant):
    """Two train steps of the variant through the CLI, then
    ``estimate_state`` and ``check_model``: finite metrics, and the expert
    artifacts a variant has (none for the unimodal RSSM; the experts' and
    subset products' logits for the categorical latent)."""
    result = cli_train.main(_args(data_dir, variant, "train.train_iteration=2",
                                  "train.checkpoint_interval=2",
                                  f"main.experiment_name=cli_{variant}"))
    run_dir = result["results_dir"]
    assert np.isfinite(list(result["metrics"].values())).all()
    saved = cli_estimate.main(["--targets", os.path.dirname(run_dir), "--itr",
                               "2", "--cwd", str(data_dir), "--device",
                               "cpu"])
    states = np.load(saved[0], allow_pickle=True).item()
    width = 16
    for s in states.values():
        assert s["posterior_means"].shape == (29, 1, width)
        assert ("expert_logits" in s) == (variant == "cat_mopoe")
    out = cli_check.main(["--run", run_dir, "--itr", "2", "--t-start", "5",
                          "--horizon", "10", "--cwd", str(data_dir),
                          "--device", "cpu"])
    assert np.isfinite(list(out["mse"].values())).all()
    with open(os.path.join(out["out_dir"], "imagination_mse.json")) as f:
        assert json.load(f)["horizon"] == 10
    experts = os.path.join(out["out_dir"], "expert_distributions.npy")
    if variant == "unimodal":
        assert not os.path.exists(experts)
        assert set(out["mse"]) == {"image_horizon"}
    else:
        blob = np.load(experts, allow_pickle=True).item()
        assert set(blob["expert_logits"]) == {"prior_expert",
                                              "image_horizon", "sound"}
        assert blob["expert_logits"]["sound"].shape == (29, 4, 4)
        assert len(blob["subset_logits"]) == 4


def test_refusals():
    """Categorical latents need q(st|ht,ot) experts, as in the JAX core; an
    unknown fusion method, latent or expert distribution raises rather
    than run another variant."""
    with pytest.raises(ValueError, match="requires expert_dist"):
        WorldModel.from_config(compose(overrides=SMALL + CAT + QOT))
    for bad, match in (("rssm.multimodal_params.fusion_method=Sum",
                        "fusion_method"),
                       ("rssm.latent_dist=beta", "latent_dist"),
                       ("rssm.multimodal_params.expert_dist=q(st)",
                        "expert_dist")):
        with pytest.raises(ValueError, match=match):
            WorldModel.from_config(compose(overrides=SMALL + [bad]))
