"""PyTorch port, model: weights carried across from JAX, and the encoder,
RSSM core, decoders and ``train_forward`` held against the JAX package on
the same weights and inputs, at the ``bench.py --small`` widths in float32.

Tolerances:
- the weight converter is exact (a relayout, no arithmetic);
- module outputs and running stats at rtol 1e-5, atol 5e-5: the same
  float32 math with convolution and matmul sums taken in another order by
  each library.  Both packages differ from a float64 run of the port by up
  to 1.7e-5 on the O(1) sound embedding in eval mode (the 4-sample instance
  norm of its down-conversion amplifies rounding), so the absolute floor
  sits above that.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.io.torch_export import export_world_model
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel

from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.layers import BatchNorm, InstanceNorm
from multimodal_rssm_torch.models.world_model import WorldModel

RTOL, ATOL = 1e-5, 5e-5
SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]
T, B, A = 3, 2, 3
NAMES = ("image_horizon", "sound")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """A JAX model initialised from a seed, its variables as numpy, and the
    port's model carrying the same weights."""
    jm = JaxWorldModel.from_config(jax_compose(overrides=SMALL + ["rssm.remat=false"]))
    rng = np.random.default_rng(0)
    obs = {"image_horizon": rng.uniform(-0.5, 0.5, (T, B, 64, 64, 3)).astype(np.float32),
           "sound": rng.normal(size=(T, B, 128, 20)).astype(np.float32)}
    act = rng.normal(size=(T, B, A)).astype(np.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0),
                                 {k: jnp.asarray(v) for k, v in obs.items()},
                                 jnp.asarray(act), None, None, train=False))
    # non-trivial running stats, so eval mode reads something other than 0/1
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    port = WorldModel.from_config(compose(overrides=SMALL))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return jm, variables, port


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    obs = {"image_horizon": rng.uniform(-0.5, 0.5, (T, B, 64, 64, 3)).astype(np.float32),
           "sound": rng.normal(size=(T, B, 128, 20)).astype(np.float32)}
    return obs, rng.normal(size=(T, B, A)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _flatten_export(tree, prefix=""):
    """The exporter's nested reference schema -> flat keys, with
    ``transition_model.main`` folded into ``transition_model``."""
    out = {}
    for k, v in tree.items():
        key = prefix if k == "main" else (f"{prefix}.{k}" if prefix else k)
        if isinstance(v, dict):
            out.update(_flatten_export(v, key))
        else:
            out[key] = v
    return out


def _port_buffers(model):
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


# -- (c) weights ---------------------------------------------------------------


def test_state_dict_from_jax_matches_exporter(models):
    """Leaf for leaf against the JAX package's torch exporter, exactly."""
    jm, variables, port = models
    want = _flatten_export(export_world_model(jm, variables))
    got = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == tuple(np.shape(v)), k
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    assert set(port.state_dict()) == set(want)


# -- (d) modules ------------------------------------------------------------------


@pytest.mark.parametrize("train", [True, False])
def test_encoder_matches_jax(models, train):
    jm, variables, port = models
    model = copy.deepcopy(port).train(train)
    obs, _ = _inputs()
    want, mutated = jm.apply(
        variables, {k: jnp.asarray(v) for k, v in obs.items()},
        method=lambda m, o: m.encode(o, train=train), mutable=["batch_stats"])
    got = model.encode({k: _t(v) for k, v in obs.items()})
    for name in NAMES:
        _close(got[name], want[name], name)
    if train:
        stats = state_dict_from_jax(variables["params"], _np_tree(mutated["batch_stats"]))
        for k, v in _port_buffers(model).items():
            if k.startswith("encoder."):
                _close(v, stats[k].numpy(), k)


@pytest.mark.parametrize("eps", ["zero", "shared"])
def test_rssm_core_matches_jax(models, eps):
    """Every output of the posterior rollout, at zero noise and with one
    noise draw (numpy) given to both."""
    jm, variables, port = models
    rng = np.random.default_rng(2)
    emb = {"image_horizon": rng.normal(size=(T, B, 64)).astype(np.float32),
           "sound": rng.normal(size=(T, B, 32)).astype(np.float32)}
    act = rng.normal(size=(T, B, A)).astype(np.float32)
    nt = (rng.uniform(size=(T, B, 1)) > 0.3).astype(np.float32)
    draw = (lambda: rng.normal(size=(T, B, 16)).astype(np.float32)) if eps == "shared" \
        else (lambda: np.zeros((T, B, 16), np.float32))
    eps_prior, eps_post = draw(), draw()
    init_h = rng.normal(size=(B, 64)).astype(np.float32)
    init_s = rng.normal(size=(B, 16)).astype(np.float32)
    args = (init_h, init_s, act, nt, emb, eps_prior, eps_post)
    want = jm.apply(variables, *jax.tree_util.tree_map(jnp.asarray, args),
                    method=lambda m, *a: m.core(*a))
    got = port.transition_model(*[{k: _t(v) for k, v in a.items()}
                                  if isinstance(a, dict) else _t(a) for a in args])
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)


@pytest.mark.parametrize("train", [True, False])
def test_decoders_match_jax(models, train):
    jm, variables, port = models
    model = copy.deepcopy(port).train(train)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(T, B, 64)).astype(np.float32)
    s = rng.normal(size=(T, B, 16)).astype(np.float32)
    want, mutated = jm.apply(variables, jnp.asarray(h), jnp.asarray(s),
                             method=lambda m, h, s: m.decode(h, s, train=train),
                             mutable=["batch_stats"])
    got = model.observation_model(_t(h), _t(s))
    for name in NAMES:
        assert got[name]["loc"].shape == want[name]["loc"].shape
        _close(got[name]["loc"], want[name]["loc"], name)
    if train:
        stats = state_dict_from_jax(variables["params"], _np_tree(mutated["batch_stats"]))
        for k, v in _port_buffers(model).items():
            if k.startswith("observation_model."):
                _close(v, stats[k].numpy(), k)


@pytest.mark.parametrize("train", [True, False])
def test_train_forward_matches_jax(models, train):
    """States, per-element MSE, reward, and every running stat after one
    train-mode call (BatchNorm biased variance, InstanceNorm batch mean of
    per-instance stats)."""
    jm, variables, port = models
    model = copy.deepcopy(port).train(train)
    obs, act = _inputs(4)
    (states, per_elem, rew), mutated = jm.apply(
        variables, {k: jnp.asarray(v) for k, v in obs.items()},
        jnp.asarray(act), None, None, False, train=train,
        method=jm.train_forward, mutable=["batch_stats"])
    g_states, g_per_elem, g_rew = model.train_forward(
        {k: _t(v) for k, v in obs.items()}, _t(act), None, None)
    for k, v in states.items():
        if isinstance(v, dict):
            for name in v:
                _close(g_states[k][name], v[name], f"{k}.{name}")
        else:
            _close(g_states[k], v, k)
    for name in NAMES:
        _close(g_per_elem[name], per_elem[name], name)
    _close(g_rew["loc"], rew["loc"], "reward")
    stats = state_dict_from_jax(variables["params"], _np_tree(mutated["batch_stats"]))
    for k, v in _port_buffers(model).items():
        _close(v, stats[k].numpy(), k)


# -- the reference's quirks -----------------------------------------------------


def test_batchnorm_tracks_biased_variance():
    """Unlike nn.BatchNorm2d (unbiased running variance), the port tracks
    the biased batch variance, as the JAX package does."""
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    bn = BatchNorm(3).train()
    ref = torch.nn.BatchNorm2d(3).train()
    torch.testing.assert_close(bn(x), ref(x), rtol=1e-5, atol=1e-5)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    assert not torch.allclose(bn.running_var, ref.running_var)


def test_instancenorm_running_stats_are_batch_means():
    x = torch.randn(4, 3, 6, 5, generator=torch.Generator().manual_seed(1))
    norm = InstanceNorm(3).train()
    y = norm(x)
    torch.testing.assert_close(
        y, torch.nn.functional.instance_norm(x, eps=1e-5), rtol=1e-5, atol=1e-5)
    mean = x.mean(dim=(2, 3)).mean(0)
    var = x.var(dim=(2, 3), unbiased=False).mean(0)
    torch.testing.assert_close(norm.running_mean, 0.1 * mean)
    torch.testing.assert_close(norm.running_var, 0.9 + 0.1 * var)


def test_multimodal_core_runs_relu():
    """dense: elu in the config, but the reference's multimodal transition
    model runs its relu default; the reward head keeps dense (elu)."""
    model = WorldModel.from_config(compose(overrides=SMALL))
    assert model.transition_model.act is torch.nn.functional.relu
    assert model.reward_model.act is torch.nn.functional.elu
