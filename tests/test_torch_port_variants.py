"""PyTorch port, the RSSM's model variants held against the JAX package:
the unimodal RSSM, PoE / NN fusion, q(st|ot) experts, categorical latents,
latent overshooting and the log-prob ELBO.  At the ``bench.py --small``
widths in float32 (categorical: V = K = 4), on weights carried over by
``state_dict_from_jax``.

- **The loss step**: per variant, one deterministic step (``key=None`` /
  ``generator=None``) of both packages' ``make_loss_fn`` and optimizer on
  the same batch: loss, metrics, gradients, running stats and post-Adam
  parameters, at the tolerances of ``test_torch_port_train.py`` (loss and
  metrics rtol 1e-4, atol 1e-6 x the value; gradients rtol 1e-4, atol
  1e-5 x the tensor's largest magnitude; parameters rtol 1e-5, atol 2e-5,
  or the 2 lr bound where the clipped gradient is within 100 x eps of
  zero).  Overshooting runs at D = 3 on a 6-step chunk, so that rows both
  inside the chunk and masked past its end occur.  A ReLU input within
  2e-6 of zero (a few of ~10^6 per step) may fall on either side of the
  kink in either package's float32 (one such input of the image decoder,
  -1.06e-7 in float64, is +4.17e-7 in the port's float32 and routes its
  gradient, 26 % of that layer's largest, the other way): the port's
  gradient is taken, and its optimizer steps, with each such input on
  JAX's side, and the kinks met are printed.
- **The categorical samples**: the deterministic step's one-hots equal
  JAX's; the smallest gap between the top two logits is printed.
- The unimodal core's activation (``dense``) against the multimodal
  ones' (relu).

``test_torch_port_variants_eval.py`` holds the rest: the categorical ops,
inference, the weight bridge, reference ``.pth`` files and the eval CLIs.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.ops.image import normalize_image_deterministic as jax_det
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops.image import normalize_image_deterministic
from multimodal_rssm_torch.train import trainer as tr

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False", "train.chunk_size=6"]
CAT = ["rssm.latent_dist=categorical", "rssm.categorical_params.variables=4",
       "rssm.categorical_params.classes=4",
       "rssm.categorical_params.unimix=0.01"]
POE = ["rssm.multimodal_params.fusion_method=PoE"]
QOT = ["rssm.multimodal_params.expert_dist=q(st|ot)"]
OVERSHOOT = ["rssm.overshooting_distance=3", "rssm.overshooting_kl_beta=1",
             "rssm.overshooting_reward_scale=1", "rssm.predict_reward=true"]
VARIANTS = {
    "unimodal": ["rssm=unimodal"],
    "poe": POE,
    "nn": ["rssm.multimodal_params.fusion_method=NN"],
    "qot_poe": POE + QOT,
    "qot_mopoe": QOT,
    "cat_mopoe": CAT,
    "cat_poe": CAT + POE,
    "cat_unimodal": ["rssm=unimodal"] + CAT,
    "overshoot_mopoe": OVERSHOOT,
    "overshoot_poe": OVERSHOOT + POE,
    "overshoot_cat": OVERSHOOT + CAT,
    "log_prob": ["rssm.worldmodel_LogProbLoss=true",
                 "rssm.predict_reward=true"],
}
CATEGORICAL = ("cat_mopoe", "cat_poe", "cat_unimodal")
L, B, A = 6, 2, 3
ONE = dict(rtol=1e-5, atol=5e-5)      # one step
ROLL = dict(rtol=1e-4, atol=1e-4)     # rollouts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol_scale, name):
    want = np.asarray(want)
    atol = atol_scale * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=name)


def _close_tree(got, want, tol, name=""):
    assert set(got) == set(want), name
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, tol, f"{name}{k}.")
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(w),
                                       err_msg=f"{name}{k}", **tol)


def _configs(variant):
    over = SMALL + VARIANTS[variant]
    return jax_compose(overrides=over + ["rssm.remat=false"]), compose(
        overrides=over)


def _observations(rng, T, Bn, names):
    obs = {"image_horizon": rng.uniform(-.5, .5, (T, Bn, 64, 64, 3)).astype(
        np.float32), "sound": rng.normal(size=(T, Bn, 128, 20)).astype(
        np.float32)}
    return {k: obs[k] for k in names}


@functools.lru_cache(maxsize=None)
def _models(variant):
    """The JAX model of a variant initialised from a seed (running stats
    moved off their init), its variables as NumPy, and the port's model on
    the same weights."""
    jcfg, cfg = _configs(variant)
    jm = JaxWorldModel.from_config(jcfg)
    port = WorldModel.from_config(cfg)
    rng = np.random.default_rng(0)
    obs = _observations(rng, 3, B, port.observation_names_enc)
    act = rng.normal(size=(3, B, A)).astype(np.float32)
    init = jax.jit(functools.partial(jm.init, train=False))
    variables = _np_tree(init(jax.random.PRNGKey(0), obs, act, None, None))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return jm, variables, port


# -- the loss step -----------------------------------------------------------

KINK = 2e-6   # |ReLU input| within which float32 rounding picks the side


class _ReluKinks:
    """Within the context, every ReLU of a port model built and run there
    records its inputs within ``KINK`` of zero and the gradient at its
    output, so that the gradient of each such input's other side can be
    formed (``columns``)."""

    def __init__(self):
        self.sites = []

    def relu(self, x, inplace=False):
        y = self._relu(x)
        if x.requires_grad:
            near = x.detach().abs() < KINK
            if bool(near.any()):
                site = {"x": x, "near": near}
                y.register_hook(lambda g, site=site: site.update(g=g))
                self.sites.append(site)
        return y

    def __enter__(self):
        from multimodal_rssm_torch.models import layers
        self._relu = torch.relu
        self._saved = (torch.nn.functional.relu, layers._ACTIVATIONS["relu"])
        torch.nn.functional.relu = layers._ACTIVATIONS["relu"] = self.relu
        return self

    def __exit__(self, *exc):
        from multimodal_rssm_torch.models import layers
        torch.nn.functional.relu, layers._ACTIVATIONS["relu"] = self._saved

    def columns(self, params):
        """Per kink: (the change its other side makes to every parameter's
        gradient, the allowed sign, a description)."""
        out = []
        for i, site in enumerate(self.sites):
            for e in site["near"].nonzero():
                e = tuple(e.tolist())
                g = site.get("g")
                if g is None or float(g[e]) == 0.0:
                    continue
                k = torch.autograd.grad(site["x"][e] * g[e].detach(), params,
                                        retain_graph=True, allow_unused=True)
                k = [torch.zeros_like(p) if d is None else d
                     for d, p in zip(k, params)]
                x = float(site["x"][e].detach())
                out.append((k, -1.0 if x > 0 else 1.0,
                            f"relu call {i} at {e}: x={x:.3g}, "
                            f"dL/dy={float(g[e]):.3g}"))
        return out


def _on_jax_side_of_kinks(port_grads, jax_grads, columns):
    """The port's gradients with each kink's side chosen as the one that
    brings them to JAX's (least squares, rounded to {0, the allowed
    sign}); returns (gradients, the kinks switched)."""
    names = list(port_grads)
    if not columns:
        return port_grads, []
    flat = lambda gs: np.concatenate([np.ravel(g) for g in gs])  # noqa: E731
    diff = flat([jax_grads[n].numpy() - port_grads[n].numpy() for n in names])
    K = np.stack([flat([d.numpy() for d in k]) for k, _, _ in columns], 1)
    c, *_ = np.linalg.lstsq(K.astype(np.float64), diff, rcond=None)
    fixed = {n: port_grads[n].clone() for n in names}
    switched = []
    for ci, (k, sign, what) in zip(c, columns):
        if ci * sign > 0.5:
            switched.append(what)
            for n, d in zip(names, k):
                fixed[n] += sign * d
    return fixed, switched


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


@functools.lru_cache(maxsize=None)
def _step(variant):
    """One JAX loss / grad / optimizer step and the port's, on the same
    weights and prepared batch, deterministic (key=None / generator=None);
    and both packages' det states of that batch."""
    jcfg, cfg = _configs(variant)
    jm, variables, _ = _models(variant)
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (L, B, 64, 64, 3), dtype=np.uint8)
    sound = rng.normal(size=(L, B, 128, 20)).astype(np.float32)
    act = rng.normal(size=(L, B, A)).astype(np.float32)
    rew = rng.normal(size=(L, B)).astype(np.float32)
    nt = np.ones((L, B, 1), np.float32)
    nt[2, 1] = 0.0
    names = tuple(cfg.rssm.observation_names_enc)
    obs = {"image_horizon": np.asarray(jax_det(jnp.asarray(img), 5)),
           "sound": sound}
    obs = {k: obs[k] for k in names}
    jbatch = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(act),
              jnp.asarray(rew), jnp.asarray(nt))
    loss_fn = jtr.make_loss_fn(jm, jcfg)
    (jloss, (jstats, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True), static_argnums=(3, 4))(
            params, stats, jbatch, None, True)
    new_params, norms = _jax_adam_step(jtr.build_optimizer(jcfg), jgrads,
                                       params)
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    jmetrics.update({k: float(v) for k, v in norms.items()})
    jstates = _np_tree(jm.apply(
        variables, {k: v[1:] for k, v in jbatch[0].items()}, jbatch[1][:-1],
        jbatch[3][:-1], None, True, False, method=jm.estimate_state))

    pobs = {"image_horizon": normalize_image_deterministic(_t(img), 5),
            "sound": _t(sound)}
    batch = ({k: pobs[k] for k in names}, _t(act), _t(rew), _t(nt))
    with _ReluKinks() as kinks:
        model = WorldModel.from_config(cfg)
        model.load_state_dict(state_dict_from_jax(params, stats))
        opt, sched = tr.build_optimizer(cfg, model)
        with torch.no_grad():
            states = model.eval().estimate_state(
                {k: v[1:] for k, v in batch[0].items()}, batch[1][:-1],
                batch[3][:-1])
        loss, metrics = tr.make_loss_fn(model, cfg)(batch, None, True)
        loss.backward(retain_graph=True)
        named = list(model.named_parameters())
        columns = kinks.columns([p for _, p in named])
    grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
             for n, p in named}
    jgrads_sd = state_dict_from_jax(_np_tree(jgrads), None)
    # the optimizer steps on the gradients with the kinks on JAX's side
    grads, switched = _on_jax_side_of_kinks(grads, jgrads_sd, columns)
    for n, p in named:
        p.grad = grads[n].clone()
    metrics.update(tr.apply_gradients(model, opt, sched,
                                      float(cfg.rssm.grad_clip_norm)))
    return {
        "jax": {"loss": float(jloss), "metrics": jmetrics,
                "grads": jgrads_sd,
                "stats": state_dict_from_jax(params, _np_tree(jstats)),
                "params": state_dict_from_jax(
                    _np_tree(new_params), None),
                "states": jstates},
        "port": {"loss": float(loss.detach()),
                 "metrics": {k: float(v) for k, v in metrics.items()},
                 "grads": grads, "model": model, "states": states,
                 "kinks": len(columns), "switched": switched},
    }


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_metrics_match_jax(variant):
    run = _step(variant)
    j, p = run["jax"], run["port"]
    assert set(p["metrics"]) == set(j["metrics"])
    _close(p["loss"], j["loss"], 1e-4, 1e-6, "loss")
    for k, v in j["metrics"].items():
        _close(p["metrics"][k], v, 1e-4, 1e-6, k)
    if variant.startswith("overshoot") or variant == "log_prob":
        assert j["metrics"]["reward_loss"] != 0.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradients_match_jax(variant, capsys):
    run = _step(variant)
    j, p = run["jax"], run["port"]
    assert set(p["grads"]) == set(j["grads"])
    with capsys.disabled():
        print(f"\n{variant}: {p['kinks']} ReLU inputs within {KINK} of "
              f"zero; on the other side in JAX: {p['switched']}")
    for name, g in p["grads"].items():
        _close(g.numpy(), j["grads"][name].numpy(), 1e-4, 1e-5, name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_running_stats_and_params_after_one_step_match_jax(variant):
    """As ``test_torch_port_train``'s: where the clipped gradient is within
    100 x eps of zero, Adam's first step can differ by up to 2 lr; there
    the check is that bound, and such entries are under 1 % of those with a
    gradient (the exact zeros, which the categorical one-hots leave in the
    decoders' state columns, step by 0 in both)."""
    run = _step(variant)
    j, model = run["jax"], run["port"]["model"]
    clip = min(1.0, 100.0 / j["metrics"]["grad_norm"])
    n_steep = n_all = 0
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), j["params"][name].numpy()
        jg = j["grads"][name].numpy()
        steep = np.abs(jg) * clip < 100 * 1e-7
        assert np.all(np.abs(got - want)[steep] <= 2e-3 + 1e-7), name
        np.testing.assert_allclose(got[~steep], want[~steep], rtol=1e-5,
                                   atol=2e-5, err_msg=name)
        n_steep += int((steep & (jg != 0)).sum())
        n_all += int((jg != 0).sum())
    assert n_steep < 0.01 * n_all
    stats = [k for k in model.state_dict()
             if k.endswith(("running_mean", "running_var"))]
    assert stats
    for name in stats:
        _close(model.state_dict()[name].numpy(), j["stats"][name].numpy(),
               1e-4, 1e-6, name)


def _top2_gap(logits) -> float:
    top = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float(np.min(top[..., 1] - top[..., 0]))


@pytest.mark.parametrize("variant", CATEGORICAL)
def test_categorical_samples_are_jax_one_hots(variant, capsys):
    """The det step's posterior and prior states are one-hots (to the
    float32 rounding of the straight-through ``onehot + p - sg(p)``) equal
    to JAX's; the smallest top-2 logit gap of the batch is printed (a near
    tie would show there, not be re-seeded away)."""
    run = _step(variant)
    j, p = run["jax"]["states"], run["port"]["states"]
    gaps = {}
    for kind in ("prior", "posterior"):
        got = _np(p[f"{kind}_states"]).reshape(L - 1, B, 4, 4)
        onehot = np.round(got)
        assert np.abs(got - onehot).max() < 1e-6, kind
        assert np.all(onehot.sum(-1) == 1.0), kind
        np.testing.assert_array_equal(
            onehot, np.round(j[f"{kind}_states"]).reshape(got.shape),
            err_msg=kind)
        np.testing.assert_allclose(got.reshape(j[f"{kind}_states"].shape),
                                   j[f"{kind}_states"], atol=1e-6,
                                   err_msg=kind)
        gaps[kind] = min(_top2_gap(j[f"{kind}_logits"]),
                         _top2_gap(_np(p[f"{kind}_logits"])))
        np.testing.assert_allclose(_np(p[f"{kind}_logits"]),
                                   j[f"{kind}_logits"], **ROLL)
    with capsys.disabled():
        print(f"\n{variant}: smallest top-2 logit gap {gaps}")
    assert min(gaps.values()) > 0.0


def test_unimodal_core_runs_dense_activation():
    """The reference's unimodal transition model receives
    ``activation_function.dense`` (elu); its multimodal ones run relu."""
    for variant, want in (("unimodal", torch.nn.functional.elu),
                          ("cat_unimodal", torch.nn.functional.elu),
                          ("poe", torch.nn.functional.relu)):
        model = WorldModel.from_config(_configs(variant)[1])
        assert model.transition_model.act is want, variant
    uni = WorldModel.from_config(_configs("unimodal")[1])
    assert uni.observation_names_enc == ("image_horizon",)
    assert not any(k.startswith("encoder.image_horizon")
                   for k in uni.state_dict())
