"""PyTorch port, the loss step of this slice's world-model configurations
and ``train.grad_accum``, held against the JAX package's ``make_loss_fn``,
``accumulated_value_and_grad`` and optimizer on the same weights and batch
(``test_torch_port_codecs.py`` holds the modules, the weight bridge, remat
and the entry points).  Configurations (``test_torch_port_codecs.CONFIGS``,
the ``bench.py --small`` widths, float32, deterministic: ``key=None`` /
``generator=None``): the COBOTTA 128 px camera with sound and the pose as
observations (BatchNorm); 256 px with GroupNorm; 64 px InstanceNorm with
the ``draw_target`` label head; 84 px with no norm.  ``grad_accum`` 2 and
4 run on the default configuration at batch 4.

Tolerances: loss and metrics rtol 1e-4, atol 1e-6 x the value; parameters
after one clipped Adam step rtol 1e-5, atol 2e-5, or the 2 lr bound where
the clipped gradient is within 100 x eps of zero (as
``test_torch_port_train.py``); such entries are under 5 % of the nonzero
ones (the train test's 1 %: the 256 px GroupNorm step's gradient norm,
1.5e5, clips every gradient by 6.6e-4 and leaves 3.2 % of them under
100 eps, the 84 px one 1.0 %).  Gradients rtol 1e-4, atol 2e-5 x the
tensor's largest magnitude (the train test's 1e-5, doubled): an
InstanceNorm over the 64 px encoder's last 2 x 2 map (4 positions a
channel) and the 256 px GroupNorm configuration's image term (196,608
features a frame, summed into the shared core's gradients) amplify float32
rounding; the largest differences measured are 1.3e-5 and 1.7e-5 of the
tensor's largest magnitude (128 px and 84 px: under 5e-6).  GroupNorm's
two variances (flax's E[x^2] - E[x]^2, ``nn.GroupNorm``'s mean squared
deviation) differ far less: 3.9e-6 at the module level
(``test_torch_port_codecs.py``).  ReLU inputs within 1e-5 x their call's mean |input| of zero
are taken on JAX's side, as ``test_torch_port_variants.py`` does with a
fixed 2e-6 band (the no-norm decoder's inputs shrink to a median of 1e-3,
where a fixed band takes hundreds of unambiguous inputs for kinks; under
``grad_accum`` each micro-batch's kinks count 1 / accum).
"""

import functools
import os
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.train import trainer as tr
from test_torch_port_codecs import (
    CONFIGS, _batch, _bridged, _close, _np_tree, _port_stats)
from test_torch_port_variants import _on_jax_side_of_kinks, _ReluKinks

GRAD_ATOL = 2e-5   # x the tensor's largest magnitude (module docstring)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _jax_adam_step(optimizer, grads, params):
    """The JAX package's optimizer step from a fresh state (the clip and
    Adam's first update, applied) and the gradient norms, in one ``jax.jit``
    as its train step takes them.  Run eagerly, optax's per-leaf ops each
    compile on their own (~700 small XLA compiles a configuration, half of
    this file's time)."""
    @jax.jit
    def step(grads, params):
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        norms = {"grad_norm": optax.global_norm(grads),
                 **{f"grad_norm_{mod}": optax.global_norm(sub)
                    for mod, sub in grads.items()}}
        return optax.apply_updates(params, updates), norms

    return step(grads, params)


def _jax_step(jm, jcfg, variables, jbatch, accum=1):
    """JAX's deterministic loss / gradient / clipped-Adam step, over
    ``accum`` micro-batches (``accumulated_value_and_grad``)."""
    params, stats = variables["params"], variables["batch_stats"]
    loss_fn = jtr.make_loss_fn(jm, jcfg)
    if accum == 1:
        step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                       static_argnums=(3, 4))
        (jloss, (jstats, jmetrics)), jgrads = step(params, stats, jbatch,
                                                  None, True)
    else:
        step = jax.jit(functools.partial(
            jtr.accumulated_value_and_grad, loss_fn, key=None, accum=accum))
        (jloss, (jstats, jmetrics)), jgrads = step(params, stats,
                                                  batch=jbatch)
    new_params, norms = _jax_adam_step(jtr.build_optimizer(jcfg), jgrads,
                                       params)
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    jmetrics.update({k: float(v) for k, v in norms.items()})
    return {"loss": float(jloss), "metrics": jmetrics,
            "grads": state_dict_from_jax(_np_tree(jgrads), None),
            "stats": state_dict_from_jax(params, _np_tree(jstats)),
            "params": state_dict_from_jax(
                _np_tree(new_params), None)}


# a ReLU input within KINK_REL x the mean |input| of its call may fall on
# either side of zero in either package's float32 (2e-6 at the O(0.2)
# inputs of a normed codec; the no-norm decoder's inputs shrink to a median
# of 1e-3 by its last layer, where float32 rounding is that much smaller)
KINK_REL = 1e-5


class _RelativeReluKinks(_ReluKinks):
    """``test_torch_port_variants._ReluKinks`` with the kink band scaled to
    each ReLU call's mean |input|."""

    def relu(self, x, inplace=False):
        y = self._relu(x)
        if x.requires_grad:
            ax = x.detach().abs()
            near = ax < KINK_REL * ax.mean()
            if bool(near.any()):
                site = {"x": x, "near": near}
                y.register_hook(lambda g, site=site: site.update(g=g))
                self.sites.append(site)
        return y


def _port_step(cfg, variables, pbatch, jgrads, accum=1):
    """The port's deterministic step on the same weights, its gradients
    with each ReLU input within the kink band on JAX's side."""
    with _RelativeReluKinks() as kinks:
        model = WorldModel.from_config(cfg)
        model.load_state_dict(state_dict_from_jax(variables["params"],
                                                  variables["batch_stats"]))
        opt, sched = tr.build_optimizer(cfg, model)
        loss_fn = tr.make_loss_fn(model, cfg)
        if accum == 1:
            loss, metrics = loss_fn(pbatch, None, True)
            loss.backward(retain_graph=True)
            named = list(model.named_parameters())
            columns = kinks.columns([p for _, p in named])
        else:   # each micro-batch's graph kept for its kinks' columns
            backward = torch.Tensor.backward
            with mock.patch.object(
                    torch.Tensor, "backward",
                    lambda t, *a, **k: backward(t, *a, retain_graph=True, **k)):
                metrics = tr.accumulated_backward(loss_fn, model, pbatch,
                                                  None, accum)
            loss, named = metrics["loss"], list(model.named_parameters())
            columns = [([d / accum for d in k], sign, what) for k, sign, what
                       in kinks.columns([p for _, p in named])]
    grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
             for n, p in named}
    grads, switched = _on_jax_side_of_kinks(grads, jgrads, columns)
    for n, p in named:
        p.grad = grads[n].clone()
    metrics.update(tr.apply_gradients(model, opt, sched,
                                      float(cfg.rssm.grad_clip_norm)))
    return {"loss": float(loss.detach()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "model": model, "kinks": len(columns),
            "switched": switched}


@functools.lru_cache(maxsize=None)
def _step(config):
    jcfg, cfg, jm, variables = _bridged(tuple(CONFIGS[config]))
    jbatch, pbatch = _batch(cfg, 1)
    j = _jax_step(jm, jcfg, variables, jbatch)
    return j, _port_step(cfg, variables, pbatch, j["grads"])


@functools.lru_cache(maxsize=None)
def _accum_step(accum):
    over = tuple(["train.batch_size=4"])
    jcfg, cfg, jm, variables = _bridged(over)
    jbatch, pbatch = _batch(cfg, 2, Bn=4)
    j = _jax_step(jm, jcfg, variables, jbatch, accum)
    return j, _port_step(cfg, variables, pbatch, j["grads"], accum)


def _check_step(j, p):
    assert set(p["metrics"]) == set(j["metrics"])
    _close(p["loss"], j["loss"], 1e-4, 1e-6, "loss")
    for k, v in j["metrics"].items():
        _close(p["metrics"][k], v, 1e-4, 1e-6, k)
    assert set(p["grads"]) == set(j["grads"])
    for name, g in p["grads"].items():
        _close(g.numpy(), j["grads"][name].numpy(), 1e-4, GRAD_ATOL, name)
    model = p["model"]
    clip = min(1.0, 100.0 / j["metrics"]["grad_norm"])
    n_steep = n_all = 0
    for name, prm in model.named_parameters():
        got, want = prm.detach().numpy(), j["params"][name].numpy()
        jg = j["grads"][name].numpy()
        steep = np.abs(jg) * clip < 100 * 1e-7
        assert np.all(np.abs(got - want)[steep] <= 2e-3 + 1e-7), name
        np.testing.assert_allclose(got[~steep], want[~steep], rtol=1e-5,
                                   atol=2e-5, err_msg=name)
        n_steep += int((steep & (jg != 0)).sum())
        n_all += int((jg != 0).sum())
    assert n_steep < 0.05 * n_all
    for name, v in _port_stats(model).items():
        _close(v.numpy(), j["stats"][name].numpy(), 1e-4, 1e-6, name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_loss_and_metrics_match_jax(config):
    j, p = _step(config)
    assert set(p["metrics"]) == set(j["metrics"])
    _close(p["loss"], j["loss"], 1e-4, 1e-6, "loss")
    for k, v in j["metrics"].items():
        _close(p["metrics"][k], v, 1e-4, 1e-6, k)
    names = set(CONFIGS[config][1].split("=")[1].strip("[]").split(","))
    assert {f"observation_{n}_loss" for n in names} <= set(p["metrics"])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_gradients_match_jax(config, capsys):
    j, p = _step(config)
    with capsys.disabled():
        print(f"\n{config}: {p['kinks']} ReLU inputs within {KINK_REL} x "
              f"mean |x| of zero; on the other side in JAX: {p['switched']}")
    assert set(p["grads"]) == set(j["grads"])
    for name, g in p["grads"].items():
        _close(g.numpy(), j["grads"][name].numpy(), 1e-4, GRAD_ATOL, name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_running_stats_and_params_after_one_step_match_jax(config):
    j, p = _step(config)
    _check_step(j, p)
    if config == "img256_groupnorm":
        assert not _port_stats(p["model"].encoder["image_horizon_256"])


# -- train.grad_accum ---------------------------------------------------------------


@pytest.mark.parametrize("accum", [2, 4])
def test_grad_accum_matches_jax(accum):
    """``accum`` micro-batches of a batch of 4 (the default configuration:
    BatchNorm sees each micro-batch's statistics) against JAX's
    ``accumulated_value_and_grad``: the mean loss and metrics, the mean
    gradient and its norms, the running stats threaded through the
    micro-batches, and the parameters after one clipped Adam step."""
    j, p = _accum_step(accum)
    _check_step(j, p)
    full, _ = _step_full_batch()
    assert abs(p["loss"] - full) > 1e-6 * abs(full)   # micro-batch statistics


@functools.lru_cache(maxsize=None)
def _step_full_batch():
    jcfg, cfg, jm, variables = _bridged(("train.batch_size=4",))
    _, pbatch = _batch(cfg, 2, Bn=4)
    model = WorldModel.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    loss, _ = tr.make_loss_fn(model, cfg)(pbatch, None, True)
    return float(loss.detach()), model
