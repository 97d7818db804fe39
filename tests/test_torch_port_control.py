"""PyTorch port, control: the DreamerV3 return tools, the policy heads and
their weight bridge, TD(lambda) returns, imagination, the behavior step,
the CEM planner and the latent agents, held against the JAX package at the
``bench.py --small`` widths in float32 (batch 2 x chunk 6, horizon 5), on
weights carried over by ``state_dict_from_jax`` /
``policy_state_dict_from_jax``.  Where the JAX package draws noise from a
key, the test draws the same tensors from the same key splits and hands
them to the port.

Tolerances:
- the return tools and ``lambda_returns``: rtol 1e-6, atol 1e-6;
- the heads on the same weights: rtol 1e-5, atol 1e-5;
- ``imagine_policy`` (5 steps through the GRU): rtol 1e-5, atol 1e-5;
- the mode-seeking action picks, of 100 samples, the one whose
  squash-corrected log density is largest; with the heads' init_std 5
  most samples saturate the tanh, where the correction log(1 - tanh^2 +
  1e-6) is decided by the float32 rounding of tanh near 1 (the two
  packages' tanh differ by an ulp on about half of such inputs, moving a
  sample's score by up to ~0.6).  Where the two packages pick different
  samples, the choice must be such a tie (the two picks' JAX scores closer
  than the largest score difference between the packages) and the port
  takes JAX's pick; the ties met are printed;
- one behavior step, per value head and return-norm setting: the losses
  and metrics rtol 1e-5 (atol 1e-7); each head's gradients rtol 1e-4,
  atol 1e-5 x the tensor's largest magnitude; post-step parameters and
  ``return_scale`` within 1e-4 x the tensor's largest magnitude.  Adam's
  first step moves a parameter by about lr x sign(gradient), so where a
  gradient lies within float32 rounding of zero (|g| <= 1e-5 x the
  tensor's largest, or switched by a ReLU kink below) the two packages may
  step opposite ways: there the bound is 2 lr, and the count is printed.
  The world model is bit-unchanged and holds no ``.grad``; the value head
  moves by its own loss's gradient only.  A ReLU input of the imagination
  within 2e-6 of zero may fall on either side of the kink in either
  package's float32 (``test_torch_port_variants.py``): the port's actor
  gradient is taken with each such input on JAX's side, and the kinks met
  are printed;
- the CEM planner on the same noise: each iteration's candidate returns
  rtol 1e-5, atol 1e-5, the same elite sets (a near-tie fails with the
  gap printed), the plan rtol 1e-5, atol 1e-5;
- the latent agent frame by frame on JAX's prepared frames and noise:
  the actions rtol 1e-5, atol 1e-5; the carried belief and posterior mean
  at ``test_torch_port_eval.py``'s one-step ``filter_step`` tolerance,
  rtol 1e-5, atol 5e-5 (the image encoder's convolutions sum in another
  order on one thread: a posterior mean moved 1.5e-5 on a frame).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.eval import state_estimation as jse
from multimodal_rssm_tpu.models import policy as jpol
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.ops import gaussian as jgauss
from multimodal_rssm_tpu.ops import returns as jrt
from multimodal_rssm_tpu.train import agent as jagent
from multimodal_rssm_tpu.train import behavior as jbh
from multimodal_rssm_tpu.train import planner as jplan
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data import buffer as port_buffer
from multimodal_rssm_torch.io.jax_weights import (
    codec_state_dict, policy_state_dict_from_jax, state_dict_from_jax)
from multimodal_rssm_torch.models import policy as pol
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops import cuda_kernels, gaussian
from multimodal_rssm_torch.ops import returns as rt
from multimodal_rssm_torch.train import agent as agent_mod
from multimodal_rssm_torch.train import behavior as bh
from multimodal_rssm_torch.train import planner as plan_mod
from multimodal_rssm_torch.train import trainer as tr
from tests.test_torch_port_variants import _on_jax_side_of_kinks, _ReluKinks

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False", "train.experience_size=200",
         "train.batch_size=2", "train.chunk_size=6", "behavior.horizon=5",
         "rssm.predict_reward=true"]
L, B, A, HB, S = 6, 2, 3, 64, 16
EXACT = dict(rtol=1e-6, atol=1e-6)
HEAD = dict(rtol=1e-5, atol=1e-5)
METRIC = dict(rtol=1e-5, atol=1e-7)
FILTER = dict(rtol=1e-5, atol=5e-5)     # test_torch_port_eval's ONE
SIGN_EPS = 1e-5     # |g| <= this x max |g|: Adam's first step may take either sign


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


def _configs(extra=()):
    jcfg = jax_compose(overrides=SMALL + ["rssm.remat=false", *extra])
    cfg = compose(overrides=SMALL + list(extra))
    jbh.behavior_cfg(jcfg)
    bh.behavior_cfg(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module")
def world():
    """A JAX world model initialised from a seed (running stats moved off
    their init), its variables as NumPy, the port's model on the same
    weights, and both packages' buffers (for the augmentation spec)."""
    jcfg, cfg = _configs()
    jm = JaxWorldModel.from_config(jcfg)
    rng = np.random.default_rng(0)
    obs = {"image_horizon": rng.uniform(-.5, .5, (3, B, 64, 64, 3)).astype(
        np.float32), "sound": rng.normal(size=(3, B, 128, 20)).astype(
        np.float32)}
    act = rng.normal(size=(3, B, A)).astype(np.float32)
    init = jax.jit(functools.partial(jm.init, train=False))
    variables = _np_tree(init(jax.random.PRNGKey(0), obs, act, None, None))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    port = WorldModel.from_config(cfg)
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return {"jcfg": jcfg, "cfg": cfg, "jm": jm, "variables": variables,
            "port": port, "jD": jax_buffer.build_buffer(jcfg),
            "pD": port_buffer.build_buffer(cfg)}


def _heads(jcfg, cfg, seed=1):
    """JAX actor / value params from ``init_behavior_state`` and the port's
    ``BehaviorState`` on the same weights."""
    actor, value = jbh.build_policy_models(jcfg)
    aopt, vopt = jbh.build_behavior_optimizers(jcfg)
    jstate = jbh.init_behavior_state(jcfg, actor, value, aopt, vopt,
                                     jax.random.PRNGKey(seed))
    bstate = bh.init_behavior_state(cfg, torch.device("cpu"))
    a_sd, v_sd = policy_state_dict_from_jax(_np_tree(jstate.actor_params),
                                            _np_tree(jstate.value_params))
    bstate.actor.load_state_dict(a_sd, strict=True)
    bstate.value.load_state_dict(v_sd, strict=True)
    return (actor, value, aopt, vopt, jstate), bstate


# -- ops/returns.py ----------------------------------------------------------


def _returns_case(name, rng):
    """(JAX output, port output) of one return tool on shared inputs."""
    x = np.concatenate([rng.normal(size=40) * 10, [0.0, -25.0, 30.0]]
                       ).astype(np.float32)
    bins = np.asarray(jrt.bin_centers(255))
    if name == "symlog":
        return jrt.symlog(jnp.asarray(x)), rt.symlog(_t(x))
    if name == "symexp":
        y = np.clip(x, -15, 15)
        return jrt.symexp(jnp.asarray(y)), rt.symexp(_t(y))
    if name == "bin_centers":
        return jrt.bin_centers(255), rt.bin_centers(255)
    if name == "twohot":
        # in range, outside it, and exactly on bins (DreamerV3's targets)
        y = np.concatenate([x, bins[[0, 7, 128, 200, 254]]]).reshape(3, -1)
        return (jrt.twohot(jnp.asarray(y), jnp.asarray(bins)),
                rt.twohot(_t(y), _t(bins)))
    if name == "twohot_decode":
        probs = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(
            size=(4, 255)).astype(np.float32)), -1))
        return (jrt.twohot_decode(jnp.asarray(probs), jnp.asarray(bins)),
                rt.twohot_decode(_t(probs), _t(bins)))
    if name.startswith("update_return_scale"):
        step = {"": None, "_step0": 0, "_step5": 5}[
            name[len("update_return_scale"):]]
        r = rng.normal(size=(4, 10)).astype(np.float32) * 7
        return (jrt.update_return_scale(jnp.float32(2.0), jnp.asarray(r),
                                        0.99, 5.0, step=step),
                rt.update_return_scale(torch.tensor(2.0), _t(r), 0.99, 5.0,
                                       step=step))
    if name == "normalize_returns":
        return ([jrt.normalize_returns(jnp.asarray(x), jnp.float32(s))
                 for s in (0.5, 3.0)],
                [rt.normalize_returns(_t(x), torch.tensor(s))
                 for s in (0.5, 3.0)])
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "symlog", "symexp", "bin_centers", "twohot", "twohot_decode",
    "update_return_scale", "update_return_scale_step0",
    "update_return_scale_step5", "normalize_returns"])
def test_return_tools_match_jax(name):
    want, got = _returns_case(name, np.random.default_rng(3))
    if not isinstance(want, list):
        want, got = [want], [got]
    for w, g in zip(want, got):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=name,
                                   **EXACT)


# -- models/policy.py --------------------------------------------------------

ENC_SHAPES = {"image_horizon": (3, 64, 64)}
ENC_EMB = {"image": 64, "sound": 32, "other": 16}
ENC_ACT = {"dense": "elu", "cnn": "relu"}


def _head_case(name, rng):
    """(JAX outputs, port outputs) of one policy head on one weight set."""
    key = jax.random.PRNGKey(5)
    h = rng.normal(size=(4, B, HB)).astype(np.float32)
    s = rng.normal(size=(4, B, S)).astype(np.float32)
    if name in ("value", "twohot_value"):
        jmod = (jpol.ValueModel(64, "elu") if name == "value" else
                jpol.TwoHotValueModel(64, 255, "elu"))
        params = _np_tree(jmod.init(key, h, s)["params"])
        port = (pol.ValueModel(HB, S, 64, "elu") if name == "value" else
                pol.TwoHotValueModel(HB, S, 64, 255, "elu"))
        port.load_state_dict(policy_state_dict_from_jax({}, params)[1])
        want = dict(jmod.apply({"params": params}, h, s))
        got = port(_t(h), _t(s))
        r = rng.normal(size=(4, B)).astype(np.float32)
        want["log_prob"] = jgauss.log_prob(want["loc"], want["scale"], r)
        got["log_prob"] = port.get_log_prob(_t(h), _t(s), _t(r))
        return want, got, params, port
    h, s = h[0], s[0]
    if name.startswith("actor_enc") or name == "pie_emb":
        jmod = (jpol.PieEmb(64, A) if name == "pie_emb" else
                jpol.ActorModelEnc("image_horizon", ENC_SHAPES, ENC_EMB,
                                   ENC_ACT, 64, A))
        x = (rng.normal(size=(B, 32)).astype(np.float32) if name == "pie_emb"
             else rng.uniform(-.5, .5, (B, 64, 64, 3)).astype(np.float32))
        params = _np_tree(jmod.init(key, x) if name == "pie_emb" else
                          jmod.init(key, x, key))["params"]
        if name == "pie_emb":
            port = pol.PieEmb(32, 64, A)
            port.load_state_dict(policy_state_dict_from_jax(params, {})[0])
            eps = rng.normal(size=(7, B, A)).astype(np.float32)
            want = dict(jmod.apply({"params": params}, x))
            want["sample"] = want["loc"] + want["scale"] * eps
            got = dict(port(_t(x)))
            got["sample"] = port.sample(_t(x), _t(eps), sample_shape=(7,))
            return want, got, params, port
        port = pol.ActorModelEnc("image_horizon", ENC_SHAPES, ENC_EMB,
                                 ENC_ACT, 64, A)
        sd = {f"encoder.{k}": v for k, v in codec_state_dict(
            "image_encoder", params["encoder"]).items()}
        sd.update({f"pie.{k}": v for k, v in policy_state_dict_from_jax(
            params["pie"], {})[0].items()})
        port.load_state_dict(sd, strict=True)
        det = name.endswith("mode")
        eps = np.asarray(jax.random.normal(
            key, (pol.MODE_SAMPLES, B, A) if det else (B, A)))
        want = {"action": jmod.apply({"params": params}, x, key, det=det)}
        got = {"action": port(_t(x), det=det, eps=_t(eps))}
        return want, got, params, port
    jmod = jpol.ActorModel(64, A) if name.startswith("actor") else jpol.Pie(
        64, A)
    params = _np_tree(jmod.init(key, h, s, key) if name.startswith("actor")
                      else jmod.init(key, h, s))["params"]
    if name == "pie":
        port = pol.Pie(HB, S, 64, A)
        port.load_state_dict(policy_state_dict_from_jax(params, {})[0])
        want = dict(jmod.apply({"params": params}, h, s))
        got = dict(port(_t(h), _t(s)))
        eps = np.asarray(jax.random.normal(key, (B, A)))
        want["sample"] = jmod.apply({"params": params}, h, s, key,
                                    method=jmod.sample)
        got["sample"] = port.sample(_t(h), _t(s), _t(eps))
        a = rng.uniform(-1, 1, (B, A)).astype(np.float32)
        want["log_prob"] = jmod.apply({"params": params}, h, s, a,
                                      method=jmod.get_log_prob)
        got["log_prob"] = port.get_log_prob(_t(h), _t(s), _t(a))
        return want, got, params, port
    port = pol.ActorModel(HB, S, 64, A)
    port.load_state_dict(policy_state_dict_from_jax(params, {})[0])
    det = name == "actor_mode"
    eps = np.asarray(jax.random.normal(
        key, (pol.MODE_SAMPLES, B, A) if det else (B, A)))
    want = {"action": jmod.apply({"params": params}, h, s, key, det=det)}
    got = {"action": port(_t(h), _t(s), det=det, eps=_t(eps))}
    return want, got, params, port


@pytest.fixture
def jax_side_modes(monkeypatch):
    """``mode_seeking_action`` with each pick that differs from the JAX
    formula's on the same samples checked to be a rounding tie and taken
    on JAX's side; yields the ties met."""
    ties = []
    port_mode = pol.mode_seeking_action

    def mode(d, raw):
        got = port_mode(d, raw).clone()
        loc, scale, r = (_np(x) for x in (d["loc"], d["scale"], raw))
        ja = jnp.tanh(r)
        jscore = np.asarray((jgauss.log_prob(loc, scale, r)
                             - jnp.log(1.0 - jnp.square(ja) + 1e-6)).sum(-1))
        ta = torch.tanh(raw)
        tscore = _np((gaussian.log_prob(d["loc"], d["scale"], raw)
                      - torch.log(1.0 - ta * ta + 1e-6)).sum(-1))
        jpick, tpick = jscore.argmax(0), tscore.argmax(0)
        for b in np.nonzero(jpick != tpick)[0]:
            band = float(np.abs(jscore[:, b] - tscore[:, b]).max())
            gap = float(jscore[jpick[b], b] - jscore[tpick[b], b])
            assert gap <= band, (b, gap, band)
            ties.append(f"row {b}: JAX's pick {gap:.3g} above the port's "
                        f"within a rounding band of {band:.3g}")
            got[b] = _t(np.asarray(ja)[jpick[b], b])
        return got

    monkeypatch.setattr(pol, "mode_seeking_action", mode)
    yield ties
    print(f"mode-seeking ties taken on JAX's side: {ties}")


@pytest.mark.parametrize("name", [
    "value", "twohot_value", "pie", "actor_sample", "actor_mode", "pie_emb",
    "actor_enc_sample", "actor_enc_mode"])
def test_policy_heads_match_jax(name, jax_side_modes):
    """Each head's outputs on the bridge's weights; the actors' sampled and
    mode-seeking actions from the JAX key's noise."""
    want, got, _, _ = _head_case(name, np.random.default_rng(4))
    assert set(got) == set(want), name
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(w),
                                   err_msg=f"{name}/{k}", **HEAD)
    if "action" in got:
        assert float(got["action"].detach().abs().max()) <= 1.0


@pytest.mark.parametrize("name", ["value", "twohot_value", "actor_sample"])
def test_policy_bridge_is_leaf_for_leaf(name):
    """Every JAX Dense leaf lands, transposed, on the port's parameter of
    the same path, and nothing else is in the state dict."""
    _, _, params, port = _head_case(name, np.random.default_rng(4))
    sd = port.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(leaves) == len(sd)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        torch_key = ".".join(keys[:-1] + [
            "weight" if keys[-1] == "kernel" else "bias"])
        want = leaf.T if keys[-1] == "kernel" else leaf
        np.testing.assert_array_equal(sd[torch_key].numpy(), want)


def test_policy_heads_compute_in_float32_under_autocast():
    """Under a bf16 autocast the heads give their float32 outputs."""
    _, got32, _, port = _head_case("pie", np.random.default_rng(4))
    rng = np.random.default_rng(4)
    h = _t(rng.normal(size=(4, B, HB)).astype(np.float32))[0]
    s = _t(rng.normal(size=(4, B, S)).astype(np.float32))[0]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        d = port(h, s)
    assert d["loc"].dtype == torch.float32
    torch.testing.assert_close(d["loc"], got32["loc"], rtol=0, atol=0)


# -- lambda_returns, imagine_policy ----------------------------------------------


def test_lambda_returns_match_jax():
    rng = np.random.default_rng(6)
    r, v = (rng.normal(size=(14, 5)).astype(np.float32) for _ in range(2))
    boot = rng.normal(size=5).astype(np.float32)
    for disc, lam in ((0.99, 0.95), (0.9, 0.0), (0.9, 1.0)):
        want = jbh.lambda_returns(jnp.asarray(r), jnp.asarray(v),
                                  jnp.asarray(boot), disc, lam)
        got = bh.lambda_returns(_t(r), _t(v), _t(boot), disc, lam)
        np.testing.assert_allclose(_np(got), np.asarray(want), **EXACT)


def _imagination_noise(key, horizon, n, det=False):
    """The noise JAX's ``imagine_policy`` draws from ``key``: per step the
    actor's (k_act) and the prior's (k_state)."""
    acts, states = [], []
    for k in jax.random.split(key, horizon):
        k_act, k_state = jax.random.split(k)
        acts.append(jax.random.normal(
            k_act, (pol.MODE_SAMPLES, n, A) if det else (n, A)))
        states.append(jax.random.normal(k_state, (1, n, S))[0])
    return _t(np.stack(acts)), _t(np.stack(states))


@pytest.mark.parametrize("det", [False, True])
def test_imagine_policy_matches_jax(world, det, jax_side_modes):
    jcfg, cfg = world["jcfg"], world["cfg"]
    (actor, _, _, _, jstate), bstate = _heads(jcfg, cfg)
    rng = np.random.default_rng(7)
    N, H = 6, 5
    h0 = rng.normal(size=(N, HB)).astype(np.float32)
    s0 = rng.normal(size=(N, S)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = _np_tree(jbh.imagine_policy(
        world["jm"], world["variables"], actor, jstate.actor_params,
        jnp.asarray(h0), jnp.asarray(s0), H, key, det_action=det))
    a_eps, s_eps = _imagination_noise(key, H, N, det)
    world["port"].eval()
    with torch.no_grad():
        got = bh.imagine_policy(world["port"], bstate.actor, _t(h0), _t(s0),
                                H, det_action=det, action_eps=a_eps,
                                state_eps=s_eps)
    for k in ("beliefs", "states", "actions"):
        np.testing.assert_allclose(_np(got[k]), want[k], err_msg=k, **HEAD)


# -- the behavior step -------------------------------------------------------------

STEP_CASES = {
    "gaussian": [],
    "gaussian_return_norm": ["behavior.return_norm=true"],
    "twohot": ["behavior.value_head=twohot_symlog"],
    "twohot_return_norm_imag_batch": ["behavior.value_head=twohot_symlog",
                                      "behavior.return_norm=true",
                                      "behavior.imag_batch=6"],
}


def _raw_batch(jD, seed=1):
    rng = np.random.default_rng(seed)
    hwc = jD.observations["image_horizon"].shape[1:]
    obs = {"image_horizon": rng.integers(0, 256, (L, B, *hwc), np.uint8),
           "sound": rng.normal(size=(L, B, 128, 20)).astype(np.float32)}
    act = rng.uniform(-1, 1, (L, B, A)).astype(np.float32)
    rew = rng.normal(size=(L, B)).astype(np.float32)
    nt = np.ones((L, B, 1), np.float32)
    nt[3, 1] = 0.0
    return obs, act, rew, nt


def _jax_losses(jm, wm, jcfg, actor, value, obs, act, nt, keys, n_starts):
    """JAX's actor and value losses of ``make_behavior_step``, composed
    from the JAX package's public functions with the step's key splits,
    for their gradients (held equal to the JAX step's losses)."""
    b = jcfg.behavior
    H, disc, lam = int(b.horizon), float(b.discount), float(b.disclam)
    _, key_post, key_img, key_sub = keys
    states = jm.apply(wm, {k: v[1:] for k, v in obs.items()}, act[:-1],
                      nt[:-1], key_post, train=False,
                      method=jm.estimate_state)
    h0 = states["beliefs"].reshape(-1, HB)
    s0 = states["posterior_states"].reshape(-1, S)
    if n_starts < h0.shape[0]:
        idx = jax.random.permutation(key_sub, h0.shape[0])[:n_starts]
        h0, s0 = h0[idx], s0[idx]
    weights = disc ** jnp.arange(H - 1, dtype=jnp.float32)

    def actor_loss(ap, vp):
        traj = jbh.imagine_policy(jm, wm, actor, ap, h0, s0, H, key_img)
        hs, ss = traj["beliefs"], traj["states"]
        rewards = jm.apply(wm, hs, ss, method=jm.reward)["loc"]
        vals = value.apply({"params": vp}, hs, ss)["loc"]
        returns = jbh.lambda_returns(rewards[:-1], vals[:-1], vals[-1],
                                     disc, lam)
        objective = returns
        if b.return_norm:
            scale = jrt.update_return_scale(
                jnp.ones(()), returns, float(b.return_norm_decay),
                float(b.return_norm_percentile), step=0)
            objective = jrt.normalize_returns(returns, scale)
        return -jnp.mean(weights[:, None] * objective), (traj, returns)

    def value_loss(vp, traj, targets):
        out = value.apply({"params": vp}, traj["beliefs"][:-1],
                          traj["states"][:-1])
        if b.value_head == "twohot_symlog":
            probs = jrt.twohot(jrt.symlog(targets),
                               jrt.bin_centers(int(b.twohot_bins)))
            logp = jnp.sum(probs * jax.nn.log_softmax(out["logits"], -1), -1)
        else:
            logp = jgauss.log_prob(out["loc"], out["scale"], targets)
        return -jnp.mean(weights[:, None] * logp)

    @jax.jit
    def grads(ap, vp):
        (la, (traj, returns)), ga = jax.value_and_grad(
            actor_loss, has_aux=True)(ap, vp)
        traj = jax.lax.stop_gradient(traj)
        lv, gv = jax.value_and_grad(value_loss)(
            vp, traj, jax.lax.stop_gradient(returns))
        return la, lv, ga, gv

    return grads


def _flat_grads(tree, prefix):
    """{port parameter name: tensor} of a JAX gradient tree."""
    a, _ = policy_state_dict_from_jax(_np_tree(tree), {})
    return {f"{prefix}{k}": v for k, v in a.items()}


def _port_actor_grads(world, cfg, bstate, batch, noise):
    """The port's actor loss of ``BehaviorStep.update``, composed from its
    public functions on a model built inside ``_ReluKinks``: (the actor's
    gradients, those with each ReLU kink on JAX's side is done by the
    caller, the kink columns)."""
    with _ReluKinks() as kinks:
        model = WorldModel.from_config(cfg)
        model.load_state_dict(world["port"].state_dict())
        model.eval()
        step = bh.BehaviorStep(model, cfg, None, torch.device("cpu"))
        h0, s0 = step.starts(batch, None, noise)
        traj = bh.imagine_policy(model, bstate.actor, h0, s0, step.horizon,
                                 action_eps=noise.actions,
                                 state_eps=noise.states)
        rewards = model.reward(traj["beliefs"], traj["states"])["loc"]
        vals = bstate.value(traj["beliefs"], traj["states"])["loc"]
        returns = bh.lambda_returns(rewards[:-1], vals[:-1], vals[-1],
                                    step.discount, step.lam)
        objective = returns
        if step.return_norm:
            objective = rt.normalize_returns(returns, rt.update_return_scale(
                bstate.return_scale, returns, step.rn_decay, step.rn_pct, 0))
        weights = step.discount ** torch.arange(step.horizon - 1,
                                                dtype=torch.float32)
        loss = -torch.mean(weights[:, None] * objective)
        names = [n for n, _ in bstate.actor.named_parameters()]
        params = [p for _, p in bstate.actor.named_parameters()]
        grads = torch.autograd.grad(loss, params, retain_graph=True)
        columns = kinks.columns(params)
    return dict(zip(names, grads)), columns


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_behavior_step_matches_jax(world, case, monkeypatch):
    jcfg, cfg = _configs(STEP_CASES[case])
    jm, wm, port = world["jm"], world["variables"], world["port"]
    (actor, value, aopt, vopt, jstate), bstate = _heads(jcfg, cfg)
    b = jcfg.behavior
    H = int(b.horizon)
    lr_a, lr_v = float(b.actor_learning_rate), float(b.value_learning_rate)
    jspec = jtr.build_aug_spec(world["jD"])
    jdraws = jse.fixed_draws(world["jD"], jspec)
    obs, act, rew, nt = _raw_batch(world["jD"])
    jraw = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(act),
            jnp.asarray(rew), jnp.asarray(nt))
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, 4)
    n_all = (L - 1) * B
    n = min(int(b.imag_batch or n_all), n_all)

    # the JAX step (it donates its state: hand it a copy)
    step_fn = jbh.make_behavior_step(jm, jcfg, actor, value, aopt, vopt, jspec)
    before = _np_tree(jstate)
    new_state, jmetrics = step_fn(jax.tree_util.tree_map(jnp.array, jstate),
                                  wm, jraw, jdraws, key)
    new_state, jmetrics = _np_tree(new_state), _np_tree(jmetrics)

    # the same prepared batch and noise for the port
    prepared = _np_tree(jtr.prepare_observations(
        jraw[0], jspec, jdraws, int(jcfg.env.bit_depth), keys[0],
        pallas_normalize=jtr.pallas_normalize_enabled(jcfg)))
    k1, k2 = jax.random.split(keys[1])
    a_eps, s_eps = _imagination_noise(keys[2], H, n)
    noise = bh.BehaviorNoise(
        posterior=tuple(_t(jax.random.normal(k, (L - 1, B, S)))
                        for k in (k1, k2)),
        starts=(_t(jax.random.permutation(keys[3], n_all)[:n])
                if n < n_all else None),
        actions=a_eps, states=s_eps)
    batch = ({k: _t(v) for k, v in prepared.items()}, _t(act), _t(rew),
             _t(nt))

    # the JAX gradients of each loss (held to the JAX step's losses)
    grads_fn = _jax_losses(jm, wm, jcfg, actor, value,
                           {k: jnp.asarray(v) for k, v in prepared.items()},
                           jnp.asarray(act), jnp.asarray(nt), keys, n)
    la, lv, ga, gv = grads_fn(before.actor_params, before.value_params)
    np.testing.assert_allclose(float(la), jmetrics["actor_loss"], **METRIC)
    np.testing.assert_allclose(float(lv), jmetrics["value_loss"], **METRIC)
    jgrads_actor = {k: v for k, v in _flat_grads(ga, "").items()}
    jgrads_value = _flat_grads(gv, "")

    # the port's actor gradient with each kink on JAX's side
    port_actor, columns = _port_actor_grads(world, cfg, bstate, batch, noise)
    fixed, switched = _on_jax_side_of_kinks(port_actor, jgrads_actor, columns)
    print(f"{case}: {len(columns)} ReLU kinks met, switched: {switched}")

    # the port's step, recording the gradients each head is given
    applied = []
    apply = bh._apply
    monkeypatch.setattr(bh, "_apply", lambda params, grads, opt, m: (
        applied.append([g.clone() for g in grads]), apply(params, grads,
                                                          opt, m))[1])
    wm_before = {k: v.clone() for k, v in port.state_dict().items()}
    step = bh.BehaviorStep(port, cfg, tr.build_aug_spec(world["pD"]),
                                 torch.device("cpu"))
    port.train()
    metrics = step.update(bstate, batch, None, noise)
    assert port.training, "the step did not restore the model's mode"

    # losses and metrics
    assert set(jmetrics) <= set(metrics)
    for k, w in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), w, err_msg=k, **METRIC)
    # the world model: bit-unchanged, no gradient
    for k, v in port.state_dict().items():
        assert torch.equal(v, wm_before[k]), k
    assert all(p.grad is None for p in port.parameters())
    # the gradients the port applied: the actor's is the composed loss's
    # (so the replica above is the step's), the value head's is the value
    # loss's alone, as JAX's
    a_names = [n for n, _ in bstate.actor.named_parameters()]
    v_names = [n for n, _ in bstate.value.named_parameters()]
    for name, g in zip(a_names, applied[0]):
        torch.testing.assert_close(g, port_actor[name], rtol=1e-6, atol=0)
    for grads, want, names in ((fixed, jgrads_actor, a_names),
                               (dict(zip(v_names, applied[1])), jgrads_value,
                                v_names)):
        for name in names:
            w = want[name].numpy()
            np.testing.assert_allclose(
                _np(grads[name]), w, rtol=1e-4,
                atol=1e-5 * float(np.abs(w).max()), err_msg=name)

    # post-step parameters and return_scale
    jnew_a, jnew_v = policy_state_dict_from_jax(new_state.actor_params,
                                                new_state.value_params)
    sign_free = 0
    for module, jnew, jg, lr, got_g in (
            (bstate.actor, jnew_a, jgrads_actor, lr_a, port_actor),
            (bstate.value, jnew_v, jgrads_value, lr_v, None)):
        for name, p in module.named_parameters():
            w, g = jnew[name].numpy(), jg[name].numpy()
            d = np.abs(_np(p) - w)
            free = np.abs(g) <= SIGN_EPS * np.abs(g).max()
            if got_g is not None:   # a kink switched this element's side
                free |= np.abs(_np(fixed[name]) - _np(got_g[name])) > 1e-5 * (
                    np.abs(g).max())
            sign_free += int(free.sum())
            assert (d[~free] <= 1e-4 * np.abs(w).max()).all(), (
                name, d[~free].max())
            assert (d[free] <= 2 * lr * (1 + 1e-3)).all(), name
    print(f"{case}: {sign_free} parameters with a gradient within rounding "
          "of zero")
    np.testing.assert_allclose(_np(bstate.return_scale),
                               new_state.return_scale, rtol=1e-4)
    assert bstate.step == int(new_state.step) == 1


# -- the CEM planner ----------------------------------------------------------

PLANNER = ["planner.candidates=40", "planner.top_candidates=4",
           "planner.planning_horizon=4", "planner.optimisation_iters=3"]


def _jax_cem(jm, wm, jcfg, h, s, key):
    """``make_cem_planner``'s iterations with the JAX package's functions
    and the plan's key splits: (plan [H, B, A], [(returns, elites)] per
    iteration, action noise [iters, H, B, J, A], state noise
    [iters, H, B * J, S])."""
    p = jcfg.planner
    H, J, K = (int(p.planning_horizon), int(p.candidates),
               int(p.top_candidates))
    stochastic = bool(p.stochastic_rollout)
    h_rep, s_rep = jnp.repeat(h, J, axis=0), jnp.repeat(s, J, axis=0)
    mean, std = jnp.zeros((H, B, A)), jnp.ones((H, B, A))
    record, a_eps, s_eps = [], [], []
    for _ in range(int(p.optimisation_iters)):
        key, k_act, k_roll = jax.random.split(key, 3)
        eps = jax.random.normal(k_act, (H, B, J, A), jnp.float32)
        actions = jnp.clip(mean[:, :, None] + std[:, :, None] * eps, -1, 1)
        roll = jm.apply(wm, h_rep, s_rep, actions.reshape(H, B * J, A), None,
                        k_roll, det=not stochastic, method=jm.rollout_prior)
        r = jm.apply(wm, roll["beliefs"], roll["prior_states"],
                     method=jm.reward)["loc"].sum(0).reshape(B, J)
        _, idx = jax.lax.top_k(r, K)
        elite = jnp.take_along_axis(actions, idx[None, :, :, None], axis=2)
        mean, std = elite.mean(axis=2), elite.std(axis=2) + 1e-6
        record.append((np.asarray(r), np.asarray(idx)))
        a_eps.append(np.asarray(eps))
        s_eps.append(np.asarray(jax.random.normal(k_roll, (H, B * J, S))))
    return (np.asarray(jnp.clip(mean, -1, 1)), record, _t(np.stack(a_eps)),
            _t(np.stack(s_eps)) if stochastic else None)


@pytest.mark.parametrize("stochastic", [True, False])
def test_cem_planner_matches_jax(world, stochastic):
    jcfg, cfg = _configs(PLANNER + [
        f"planner.stochastic_rollout={str(stochastic).lower()}"])
    jm, wm = world["jm"], world["variables"]
    rng = np.random.default_rng(8)
    h = rng.normal(size=(B, HB)).astype(np.float32)
    s = rng.normal(size=(B, S)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    jplan_fn = jplan.make_cem_planner(jm, jcfg, full_sequence=True)
    want = np.asarray(jplan_fn(wm, jnp.asarray(h), jnp.asarray(s), key))
    replica, record, a_eps, s_eps = _jax_cem(jm, wm, jcfg, jnp.asarray(h),
                                             jnp.asarray(s), key)
    np.testing.assert_allclose(replica, want, rtol=1e-6, atol=1e-6)

    got_record = []
    plan = plan_mod.make_cem_planner(world["port"], cfg, full_sequence=True)
    got = plan(_t(h), _t(s), noise=(a_eps, s_eps), record=got_record)
    assert tuple(got.shape) == (4, B, A)
    K = 4
    for i, ((r, idx), rec) in enumerate(zip(record, got_record)):
        np.testing.assert_allclose(_np(rec["returns"]), r, rtol=1e-5,
                                   atol=1e-5, err_msg=f"iteration {i}")
        for b in range(B):
            top = np.sort(r[b])[::-1]
            gap = top[K - 1] - top[K]
            assert set(_np(rec["elites"][b])) == set(idx[b]), (
                f"iteration {i} row {b}: elite sets differ; the K-th and "
                f"(K+1)-th returns are {gap:.3g} apart")
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    assert float(got.abs().max()) <= 1.0


def test_planner_refuses_more_elites_than_candidates():
    _, cfg = _configs(["planner.candidates=4", "planner.top_candidates=5"])
    with pytest.raises(ValueError, match="top_candidates"):
        plan_mod.make_cem_planner(None, cfg)


def test_reward_head_guard():
    _, cfg = _configs(["rssm.predict_reward=false"])
    with pytest.raises(ValueError, match="predict_reward"):
        plan_mod.check_reward_head_trained(cfg)
    cfg.rssm.predict_reward = True
    plan_mod.check_reward_head_trained(cfg)


# -- the latent agents ----------------------------------------------------------

AGENT_CASES = {"sample_explore": (False, True), "mode": (True, False)}


@pytest.mark.parametrize("case", list(AGENT_CASES))
def test_latent_agent_matches_jax(world, case):
    """Three frames through JAX's ``LatentAgent`` and the port's ``step``
    on JAX's prepared frames and noise: beliefs, posterior means (the
    carried state) and actions."""
    from multimodal_rssm_torch.envs import SyntheticEnv

    det, explore = AGENT_CASES[case]
    jcfg, cfg = world["jcfg"], world["cfg"]
    (actor, _, _, _, jstate), bstate = _heads(jcfg, cfg)
    jag = jagent.LatentAgent(jcfg, world["jm"], actor, world["jD"])
    pag = agent_mod.LatentAgent(cfg, world["port"], bstate.actor, world["pD"])
    env = SyntheticEnv(length=5, seed=2)
    obs = env.reset(seed=2)
    for t in range(3):
        key = jax.random.PRNGKey(20 + t)
        k_prep, k_act, k_noise = jax.random.split(key, 3)
        want = jag(world["variables"], jstate.actor_params, obs, key,
                   explore=explore, det=det)
        frame = jtr.prepare_observations(
            {k: jnp.asarray(v)[None, None] for k, v in obs.items()},
            jag.spec, jag.draws, int(jcfg.env.bit_depth), k_prep)
        got = pag.step(
            {k: _t(v[0]) for k, v in frame.items()}, explore=explore,
            det=det, action_eps=_t(jax.random.normal(
                k_act, (pol.MODE_SAMPLES, 1, A) if det else (1, A))),
            explore_eps=_t(jax.random.normal(k_noise, (1, A))))
        np.testing.assert_allclose(_np(got)[0], want, err_msg=f"frame {t}",
                                   **HEAD)
        np.testing.assert_allclose(_np(pag.h), np.asarray(jag.h), **FILTER)
        np.testing.assert_allclose(_np(pag.s), np.asarray(jag.s), **FILTER)
        obs, _, _ = env.step(want)


@pytest.mark.parametrize("kind", ["actor", "cem"])
def test_agents_carry_state_and_normalise_through_k1(world, kind,
                                                     monkeypatch):
    """Across frames the agent carries the filter's belief and posterior
    mean (its second frame's state is ``filter_step`` from its first's and
    the action it took), each frame goes through K1's wrapper once, and
    actions stay in [-1, 1]."""
    from multimodal_rssm_torch.envs import SyntheticEnv

    jcfg, cfg = _configs(PLANNER)
    port = world["port"]
    calls, frames = [], []
    wrapper = cuda_kernels.normalize_image
    monkeypatch.setattr(cuda_kernels, "normalize_image",
                        lambda *a: calls.append(a) or wrapper(*a))
    if kind == "cem":
        agent = plan_mod.CEMAgent(cfg, port, world["pD"])
    else:
        agent = agent_mod.LatentAgent(
            cfg, port, bh.init_behavior_state(cfg, torch.device("cpu")).actor,
            world["pD"])
    prepare = agent.prepare
    monkeypatch.setattr(agent, "prepare", lambda o, g: frames.append(
        prepare(o, g)) or frames[-1])
    env = SyntheticEnv(length=5, seed=3)
    obs, gen = env.reset(seed=3), torch.Generator().manual_seed(0)
    actions = []
    for _ in range(3):
        a = agent(obs, gen, explore=True)
        assert a.shape == (A,) and np.abs(a).max() <= 1.0
        actions.append(_t(a)[None])
        obs, _, _ = env.step(a)
    assert len(calls) == 3 and len(frames) == 3
    h = torch.zeros(1, HB)
    s = torch.zeros(1, S)
    prev = torch.zeros(1, A)
    port.eval()
    with torch.no_grad():
        for t in range(3):
            out = port.filter_step(h, s, prev, frames[t])
            h, s, prev = out["beliefs"], out["posterior_means"], actions[t]
    torch.testing.assert_close(agent.h, h, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(agent.s, s, rtol=1e-6, atol=1e-6)
