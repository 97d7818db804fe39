"""PyTorch port, offline evaluation: episode state estimation, the world
model's inference entry points (``estimate_state_from``, ``filter_step``,
``rollout_prior``, ``decode``, the cross-modal view), reconstruction,
open-loop imagination, PSNR / SSIM, the streaming filter, the PCA, and the
``estimate_state`` / ``check_model`` CLIs, held against the JAX package's
``eval/`` on the same weights and inputs, at the ``bench.py --small``
widths in float32 with non-trivial running stats, on a tiny COBOTTA-schema
set (3 episodes x 40) that both packages' buffers load.

Tolerances:
- exact where the math is a relayout or a copy: episode bounds, file names,
  the augmentation draws, an episode's sound, actions, rewards and
  nonterminals, the quantised part of its image, the states' keys;
- rtol 1e-5, atol 5e-5 for one-step outputs (``filter_step``, a short
  ``estimate_state_from``, the decoders), as in test_torch_port_model;
- rtol 1e-4, atol 1e-4 for rollouts of 20 steps or more (an episode's
  estimate, ``rollout_prior``, ``imagine``, the filter over a sequence) and
  what is computed from them, where the GRU compounds rounding, as the JAX
  package's own ``test_streaming_filter_matches_sequence`` allows;
- rtol 1e-5 for PSNR and SSIM on the same inputs;
- the PCA's projections at rtol 1e-5 against scikit-learn's, up to a sign
  per component.
"""

import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.eval import imagination as jim
from multimodal_rssm_tpu.eval import metrics as jmetrics
from multimodal_rssm_tpu.eval import state_estimation as jse
from multimodal_rssm_tpu.eval.streaming import OnlineFilter as JaxOnlineFilter
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.ops.image import normalize_image_deterministic as jax_det
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.cli import check_model as cli_check
from multimodal_rssm_torch.cli import estimate_state as cli_estimate
from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose, load_run_config
from multimodal_rssm_torch.data import buffer as port_buffer
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.eval import imagination, visualize
from multimodal_rssm_torch.eval import metrics
from multimodal_rssm_torch.eval import state_estimation as se
from multimodal_rssm_torch.eval.streaming import OnlineFilter
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops import cuda_kernels
from multimodal_rssm_torch.train import trainer as tr

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False", "train.experience_size=200"]
SHAPES = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
NAMES = ("image_horizon", "sound")
ONE = dict(rtol=1e-5, atol=5e-5)      # one step
ROLL = dict(rtol=1e-4, atol=1e-4)     # rollouts of 20 steps or more
BIT_DEPTH = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close_tree(got, want, tol, name=""):
    """Every entry of a (nested) state dict, the same keys on both sides."""
    assert set(got) == set(want), name
    for k, w in want.items():
        if isinstance(w, dict):
            _close_tree(got[k], w, tol, f"{name}{k}.")
        else:
            np.testing.assert_allclose(_np(got[k]), np.asarray(w),
                                       err_msg=f"{name}{k}", **tol)


@pytest.fixture(scope="module")
def models():
    """A JAX model initialised from a seed (running stats moved off their
    init), its variables as NumPy, and the port's model on the same
    weights, in eval mode."""
    jm = JaxWorldModel.from_config(jax_compose(overrides=SMALL + [
        "rssm.remat=false"]))
    rng = np.random.default_rng(0)
    T, B = 3, 2
    obs = {"image_horizon": rng.uniform(-.5, .5, (T, B, 64, 64, 3)).astype(
        np.float32), "sound": rng.normal(size=(T, B, 128, 20)).astype(
        np.float32)}
    act = rng.normal(size=(T, B, 3)).astype(np.float32)
    init = jax.jit(functools.partial(jm.init, train=False))
    variables = jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(0), obs, act, None, None))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    port = WorldModel.from_config(compose(overrides=SMALL))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return jm, variables, port.eval()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The episode dir and both packages' buffers loaded from it."""
    root = tmp_path_factory.mktemp("eval_data")
    write_synthetic_dataset(str(root / "train"), 3, 40, SHAPES)
    write_synthetic_dataset(str(root / "val"), 1, 40, SHAPES, seed=9)
    jD = jax_buffer.build_buffer(jax_compose(overrides=SMALL))
    jD.load_dataset(str(root / "train"))
    pD = port_buffer.build_buffer(compose(overrides=SMALL))
    port_buffer.load_dataset(str(root), pD, "train")
    return root, jD, pD


def _jax_episode(jD, epi, seed=0):
    """JAX's prepared episode (its own noise): obs targets [T-1, 1, ...],
    actions [T-1, 1, A], nonterminals [T-1, 1, 1], as NumPy."""
    spec = jtr.build_aug_spec(jD)
    obs, act, _, nt = jse.get_episode_data(
        jD, epi, spec, jse.fixed_draws(jD, spec), BIT_DEPTH,
        jax.random.PRNGKey(seed))
    return ({k: np.asarray(v[1:]) for k, v in obs.items()},
            np.asarray(act[:-1]), np.asarray(nt[:-1]))


@pytest.fixture(scope="module")
def episode_states(models, data):
    """JAX's det estimate of episode 1 in eval mode, and its inputs."""
    jm, variables, _ = models
    obs, act, nt = _jax_episode(data[1], 1)
    states = jm.apply(variables, obs, act, nt, None, True, False,
                      method=jm.estimate_state)
    return obs, act, nt, jax.tree_util.tree_map(np.asarray, states)


# -- data --------------------------------------------------------------------------


def test_episode_bounds_and_file_names_match_jax(data):
    _, jD, pD = data
    np.testing.assert_array_equal(se.episode_bounds(pD),
                                  jse.episode_bounds(jD))
    assert list(se.episode_bounds(pD)) == [0, 40, 80, 120]
    assert pD.file_names == jD.file_names and len(pD.file_names) == 3


@pytest.mark.parametrize("epi", [0, 2])
def test_get_episode_data_matches_jax(data, epi, monkeypatch):
    """Sound, actions, rewards and nonterminals equal JAX's; the prepared
    image is JAX's deterministic normalise of the same crop plus noise in
    [0, 2^-bit_depth] (float32 can round the top of the noise up to
    2^-bit_depth itself), through K1's wrapper (its plain version on the
    CPU), once."""
    _, jD, pD = data
    jspec, spec = jtr.build_aug_spec(jD), tr.build_aug_spec(pD)
    assert tuple(spec) == tuple(jspec)
    jdraws, draws = jse.fixed_draws(jD, jspec), se.fixed_draws(pD, spec)
    for name, entry in jdraws.items():
        for k, v in entry.items():
            np.testing.assert_array_equal(draws[name][k], v)
    calls = []
    wrapper = cuda_kernels.normalize_image
    monkeypatch.setattr(cuda_kernels, "normalize_image",
                        lambda *a: calls.append(a) or wrapper(*a))
    obs, act, rew, nt = se.get_episode_data(
        pD, epi, spec, draws, BIT_DEPTH, torch.Generator().manual_seed(0),
        torch.device("cpu"))
    assert len(calls) == 1
    jobs, jact, jrew, jnt = jse.get_episode_data(
        jD, epi, jspec, jdraws, BIT_DEPTH, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(obs["sound"].numpy(), np.asarray(jobs["sound"]))
    for got, want in ((act, jact), (rew, jrew), (nt, jnt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert obs["image_horizon"].shape == (40, 1, 64, 64, 3)
    dh, dw = jdraws["image_horizon"].get("crop", (0, 0))
    raw = jD.observations["image_horizon"][40 * epi:40 * epi + 40, None,
                                           dh:dh + 64, dw:dw + 64]
    noise = obs["image_horizon"].numpy() - np.asarray(jax_det(jnp.asarray(raw),
                                                              BIT_DEPTH))
    assert noise.min() >= 0.0 and noise.max() <= 2.0 ** -BIT_DEPTH
    assert noise.std() > 0.25 * 2.0 ** -BIT_DEPTH / np.sqrt(12)


# -- the world model's inference entry points -------------------------------------


def _noise_patch(monkeypatch, draws):
    """Both packages' ``draw_state_noise`` return ``draws`` in order."""
    jit, pit = iter(draws), iter(draws)
    monkeypatch.setattr(JaxWorldModel, "draw_state_noise",
                        lambda self, key, T, B: jnp.asarray(next(jit)))
    monkeypatch.setattr(WorldModel, "draw_state_noise",
                        lambda self, g, T, B: _t(next(pit)))


def _inputs(rng, T, B):
    obs = {"image_horizon": rng.uniform(-.5, .5, (T, B, 64, 64, 3)).astype(
        np.float32), "sound": rng.normal(size=(T, B, 128, 20)).astype(
        np.float32)}
    return (obs, rng.normal(size=(T, B, 3)).astype(np.float32),
            (rng.uniform(size=(T, B, 1)) > 0.2).astype(np.float32),
            rng.normal(size=(B, 64)).astype(np.float32),
            rng.normal(size=(B, 16)).astype(np.float32))


@pytest.mark.parametrize("eps", ["zero", "shared"])
def test_estimate_state_from_matches_jax(models, eps, monkeypatch):
    """From a given belief and state, in eval mode: every key, the expert
    dicts included, at zero noise and with one noise draw given to both."""
    jm, variables, port = models
    rng = np.random.default_rng(1)
    T, B = 4, 2
    obs, act, nt, h0, s0 = _inputs(rng, T, B)
    shared = eps == "shared"
    if shared:
        _noise_patch(monkeypatch, [rng.normal(size=(T, B, 16)).astype(
            np.float32) for _ in range(2)])
    want = jm.apply(variables, h0, s0, obs, act, nt,
                    jax.random.PRNGKey(0) if shared else None, not shared,
                    False, method=jm.estimate_state_from)
    with torch.no_grad():
        got = port.estimate_state_from(
            _t(h0), _t(s0), {k: _t(v) for k, v in obs.items()}, _t(act),
            _t(nt), torch.Generator() if shared else None)
    _close_tree(got, jax.tree_util.tree_map(np.asarray, want), ONE)


@pytest.mark.parametrize("eps", ["zero", "shared"])
def test_filter_step_matches_jax(models, eps, monkeypatch):
    jm, variables, port = models
    rng = np.random.default_rng(2)
    obs, act, nt, h0, s0 = _inputs(rng, 1, 2)
    shared = eps == "shared"
    if shared:
        _noise_patch(monkeypatch, [rng.normal(size=(1, 2, 16)).astype(
            np.float32) for _ in range(2)])
    want = jm.apply(variables, h0, s0, act[0], {k: v[0] for k, v in obs.items()},
                    nt[0], jax.random.PRNGKey(0), not shared, False,
                    method=jm.filter_step)
    with torch.no_grad():
        got = port.filter_step(_t(h0), _t(s0), _t(act[0]),
                               {k: _t(v[0]) for k, v in obs.items()},
                               _t(nt[0]), torch.Generator() if shared else None)
    assert got["beliefs"].shape == (2, 64)
    assert got["expert_means_stacked"].shape == (3, 2, 16)
    _close_tree(got, jax.tree_util.tree_map(np.asarray, want), ONE)


@pytest.mark.parametrize("eps", ["zero", "shared"])
def test_rollout_prior_matches_jax(models, eps, monkeypatch):
    """A 25-step open-loop rollout with episode starts inside it; with
    noise, the carry is the prior sample, not the mean."""
    jm, variables, port = models
    rng = np.random.default_rng(3)
    T, B = 25, 2
    _, act, nt, h0, s0 = _inputs(rng, T, B)
    shared = eps == "shared"
    noise = rng.normal(size=(T, B, 16)).astype(np.float32)
    if shared:
        _noise_patch(monkeypatch, [noise])
    want = jax.tree_util.tree_map(np.asarray, jm.apply(
        variables, h0, s0, act, nt, jax.random.PRNGKey(0), not shared,
        method=jm.rollout_prior))
    with torch.no_grad():
        got = port.rollout_prior(_t(h0), _t(s0), _t(act), _t(nt),
                                 torch.Generator() if shared else None)
    _close_tree(got, want, ROLL)
    if shared:
        np.testing.assert_allclose(
            _np(got["prior_states"]),
            want["prior_means"] + want["prior_std_devs"] * noise, **ONE)
        assert not np.allclose(want["prior_states"], want["prior_means"])
    else:
        np.testing.assert_array_equal(_np(got["prior_states"]),
                                      _np(got["prior_means"]))


def test_det_episode_estimate_in_eval_mode_matches_jax(models,
                                                       episode_states):
    """JAX-prepared observations of a whole episode (39 steps, batch 1):
    every key, the expert dicts included; the running stats and their
    counters do not move."""
    _, _, port = models
    obs, act, nt, want = episode_states
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        got = port.estimate_state({k: _t(v) for k, v in obs.items()}, _t(act),
                                  _t(nt))
    assert got["beliefs"].shape == (39, 1, 64)
    assert set(got["expert_means"]) == {"prior_expert", *NAMES}
    _close_tree(got, want, ROLL)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- reconstruction, imagination and their metrics ---------------------------------


def test_reconstruct_imagine_and_metrics_match_jax(models, episode_states):
    """On JAX's states of one episode: the reconstruction, a 20-step
    imagination from step 5 (actions 6..25, targets 6..25), its MSE and its
    PSNR / SSIM, end to end; and the port's metrics on JAX's own
    predictions at rtol 1e-5."""
    jm, variables, port = models
    obs, act, _, states = episode_states
    t_start, horizon = 5, 20
    recon = imagination.reconstruct(port, {k: _t(v) for k, v in states.items()
                                           if not isinstance(v, dict)})
    jrecon = jim.reconstruct(jm, variables, states)
    for name in NAMES:
        np.testing.assert_allclose(_np(recon[name]["loc"]),
                                   np.asarray(jrecon[name]["loc"]), **ROLL)

    roll, preds = imagination.imagine(
        port, {k: _t(v) for k, v in states.items() if not isinstance(v, dict)},
        _t(act), t_start, horizon)
    jroll, jpreds = jim.imagine(jm, variables, states, jnp.asarray(act),
                                t_start, horizon)
    _close_tree(roll, jax.tree_util.tree_map(np.asarray, jroll), ROLL)
    for name in NAMES:
        assert preds[name]["loc"].shape[0] == horizon
        np.testing.assert_allclose(_np(preds[name]["loc"]),
                                   np.asarray(jpreds[name]["loc"]), **ROLL)
    targets = {k: _t(v) for k, v in obs.items()}
    jtargets = {k: jnp.asarray(v) for k, v in obs.items()}
    mse = imagination.video_prediction_mse(preds, targets, t_start, horizon)
    jmse = jim.video_prediction_mse(jpreds, jtargets, t_start, horizon)
    assert mse.keys() == jmse.keys()
    for name in NAMES:
        np.testing.assert_allclose(mse[name], jmse[name], rtol=1e-4)
    quality = metrics.video_prediction_metrics(preds, targets, t_start, horizon)
    jquality = jmetrics.video_prediction_metrics(jpreds, jtargets, t_start,
                                                 horizon)
    assert set(quality["image_horizon"]) == {"mse", "psnr", "ssim"}
    assert set(quality["sound"]) == {"mse", "psnr"}
    _close_tree(quality, jquality, dict(rtol=1e-4, atol=0))
    same_preds = {k: {"loc": _t(np.asarray(v["loc"]))} for k, v in jpreds.items()}
    _close_tree(metrics.video_prediction_metrics(same_preds, targets, t_start,
                                                 horizon),
                jquality, dict(rtol=1e-5, atol=0))


@pytest.mark.parametrize("shape", [(3, 2, 16, 16, 3), (4, 9, 12, 1)])
def test_psnr_and_ssim_match_jax(shape):
    rng = np.random.default_rng(4)
    a = rng.uniform(-.5, .5, shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), -.5, .5).astype(np.float32)
    np.testing.assert_allclose(float(metrics.psnr(_t(a), _t(b))),
                               float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics.ssim(_t(a), _t(b))),
                               float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    assert float(metrics.ssim(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-6)
    with pytest.raises(ValueError, match="smaller than SSIM window"):
        metrics.ssim(_t(a[..., :6, :]), _t(b[..., :6, :]))


# -- the streaming filter and the cross-modal view ---------------------------------


def test_online_filter_matches_sequence_and_jax(models, episode_states):
    """Frame by frame over a 39-step episode: the port's filter equals its
    own det sequence estimate and JAX's OnlineFilter; its decode equals
    JAX's."""
    jm, variables, port = models
    obs, act, nt, states = episode_states
    filt, jfilt = OnlineFilter(port), JaxOnlineFilter(jm, variables)
    filt.reset(1)
    jfilt.reset(1)
    got, jgot = [], []
    for t in range(act.shape[0]):
        frame = {k: v[t] for k, v in obs.items()}
        got.append(filt.step(_t(act[t]), {k: _t(v) for k, v in frame.items()},
                             _t(nt[t])))
        jgot.append(jfilt.step(jnp.asarray(act[t]), frame, jnp.asarray(nt[t])))
    with torch.no_grad():
        seq = port.estimate_state({k: _t(v) for k, v in obs.items()}, _t(act),
                                  _t(nt))
    for key in ("beliefs", "posterior_means", "posterior_states", "prior_means"):
        stacked = torch.stack([o[key] for o in got])
        np.testing.assert_allclose(_np(stacked), _np(seq[key]), err_msg=key,
                                   **ROLL)
        np.testing.assert_allclose(_np(stacked), np.stack(
            [np.asarray(o[key]) for o in jgot]), err_msg=key, **ROLL)
        np.testing.assert_allclose(_np(stacked), states[key], err_msg=key,
                                   **ROLL)
    recon, jrecon = filt.decode(), jfilt.decode()
    for name in NAMES:
        assert recon[name]["loc"].shape == np.asarray(jrecon[name]["loc"]).shape
        np.testing.assert_allclose(_np(recon[name]["loc"]),
                                   np.asarray(jrecon[name]["loc"]), **ROLL)


def test_online_filter_draws_from_its_own_generator(models):
    """``det=False``: the filter's seeded generator draws new noise each
    frame, and the same seed repeats the same stream."""
    _, _, port = models
    rng = np.random.default_rng(5)
    obs, act, _, _, _ = _inputs(rng, 3, 1)
    runs = []
    for _ in range(2):
        filt = OnlineFilter(port, det=False, seed=7)
        runs.append([filt.step(_t(act[t]), {k: _t(v[t]) for k, v in obs.items()})
                     ["posterior_states"] for t in range(3)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    det = OnlineFilter(port).step(_t(act[0]), {k: _t(v[0]) for k, v in obs.items()})
    assert not torch.equal(runs[0][0], det["posterior_states"])
    torch.testing.assert_close(det["posterior_states"], det["posterior_means"])


def test_cross_modal_model_shares_parameters_and_matches_jax(models,
                                                             episode_states):
    """The sound-only view: the full model itself (its own tensors, the
    same ``data_ptr``s, no copy), run without the image (its encoder and
    expert never run), experts {prior_expert, sound}, and the same states
    as JAX's cross-modal model on the full model's variables, also frame by
    frame through ``filter_step``."""
    jm, variables, port = models
    obs, act, nt, _ = episode_states
    view = imagination.cross_modal_model(port, ("sound",))
    assert view.model is port and view.names == ("sound",)
    full = dict(port.named_parameters())
    for k, p in view.named_parameters():
        assert p.data_ptr() == full[k].data_ptr(), k
    assert port.observation_names_enc == NAMES      # the model is unchanged
    assert set(port.transition_model.obs_encoder) == {"prior_expert", *NAMES}
    jview = jim.cross_modal_model(jm, ("sound",))
    want = jview.apply(variables, obs, act, nt, None, True, False,
                       method=jview.estimate_state)
    sound = {"sound": _t(obs["sound"])}
    with torch.no_grad():
        got = view.estimate_state(sound, _t(act), _t(nt))
    assert set(got["expert_means"]) == {"prior_expert", "sound"}
    assert got["expert_means_stacked"].shape == (39, 2, 1, 16)
    _close_tree(got, jax.tree_util.tree_map(np.asarray, want), ROLL)
    filt = OnlineFilter(view)
    filt.reset(1)
    frames = [filt.step(_t(act[t]), {"sound": sound["sound"][t]}, _t(nt[t]))
              for t in range(act.shape[0])]
    np.testing.assert_allclose(
        _np(torch.stack([f["posterior_means"] for f in frames])),
        np.asarray(want["posterior_means"]), **ROLL)
    with pytest.raises(ValueError, match="not encoded"):
        imagination.cross_modal_model(port, ("touch",))


# -- PCA ----------------------------------------------------------------------------


def test_pca_matches_sklearn():
    decomposition = pytest.importorskip("sklearn.decomposition")
    rng = np.random.default_rng(6)
    feats = [rng.normal(size=(20, 8)) @ rng.normal(size=(8, 8)) + i
             for i in range(3)]
    pca, proj = visualize.pca_trajectories(feats, 3)
    ref = decomposition.PCA(n_components=3).fit(np.concatenate(feats, 0))
    np.testing.assert_allclose(pca.mean_, ref.mean_, rtol=1e-10)
    np.testing.assert_allclose(pca.explained_variance_,
                               ref.explained_variance_, rtol=1e-8)
    for got, x in zip(proj, feats):
        want = ref.transform(x)
        assert got.shape == (20, 3)
        for k in range(3):
            sign = np.sign(np.dot(got[:, k], want[:, k]))
            np.testing.assert_allclose(sign * got[:, k], want[:, k],
                                       rtol=1e-5, atol=1e-8)
            np.testing.assert_allclose(sign * pca.components_[k],
                                       ref.components_[k], rtol=1e-5,
                                       atol=1e-8)


def test_reverse_image_observation_takes_tensors():
    x = np.random.default_rng(7).uniform(-.5, .5, (2, 4, 4, 3)).astype(np.float32)
    got = visualize.reverse_image_observation(_t(x))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, visualize.reverse_image_observation(x))


# -- checkpoints and the CLIs ----------------------------------------------------------


@pytest.mark.parametrize("path,want", [
    ("/r/run_0/models_2.pt", "/r/run_0/states_models_2.npy"),
    ("/r/run_0/models_10000.pth", "/r/run_0/states_models_10000.npy"),
    ("/r/run_0/models_5.msgpack", "/r/run_0/states_models_5.npy"),
    ("/r/a.pth_dir/models_3.pth", "/r/a.pth_dir/states_models_3.npy")])
def test_states_file_name(path, want):
    assert se.states_file_name(path) == want


@pytest.mark.parametrize("present,want", [
    (("models_2.pt", "models_2.pth"), "models_2.pt"),
    (("models_2.pth", "models_2.msgpack"), "models_2.pth"),
    (("models_2.msgpack", "models_20.pt"), "models_2.msgpack")])
def test_find_model_checkpoint_order(tmp_path, present, want):
    for name in present:
        (tmp_path / name).write_bytes(b"")
    assert ckpt.find_model_checkpoint(str(tmp_path), 2) == str(tmp_path / want)
    with pytest.raises(FileNotFoundError, match="models_3"):
        ckpt.find_model_checkpoint(str(tmp_path), 3)


@pytest.fixture(scope="module")
def trained_run(data):
    """A 2-step run of the port's train CLI with the shipped default
    ``train.pallas_normalize=false`` and a checkpoint at step 2: (data
    root, run dir)."""
    root = data[0]
    result = cli_train.main(SMALL + [
        f"train.train_data_path=[{root}/train]",
        f"train.validation_data_path=[{root}/val]", "train.batch_size=2",
        "train.chunk_size=4", "train.train_iteration=2",
        "train.validation_interval=2", "train.checkpoint_interval=2",
        "main.experiment_name=eval_cli",
        "--device", "cpu", "--cwd", str(root)])
    assert os.path.exists(os.path.join(result["results_dir"], "models_2.pt"))
    return root, result["results_dir"]


def test_estimate_state_cli_round_trip(models, data, trained_run, monkeypatch):
    """``cli.estimate_state --device cpu`` writes ``states_models_2.npy``
    keyed by episode file, with JAX ``get_states``' keys and shapes per
    episode; K1's wrapper runs once per episode (its plain version on the
    CPU) although the run trained without it; the running stats stay as
    loaded."""
    jm, variables, _ = models
    _, jD, pD = data
    root, run_dir = trained_run
    assert str(load_run_config(run_dir).train.pallas_normalize) == "False"
    calls = []
    plain = cuda_kernels.normalize_image_plain
    monkeypatch.setattr(cuda_kernels, "normalize_image_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    loaded = []
    load = se.load_eval_model
    monkeypatch.setattr(se, "load_eval_model",
                        lambda *a: loaded.append(load(*a)) or loaded[-1])
    saved = cli_estimate.main(["--targets", os.path.dirname(run_dir), "--itr",
                               "2", "--cwd", str(root), "--device", "cpu"])
    assert saved == [os.path.join(run_dir, "states_models_2.npy")]
    assert calls == [(39 + 1, 1, 64, 64, 3)] * 3
    states = np.load(saved[0], allow_pickle=True).item()
    want = jse.get_states(jm, variables, jD)
    assert list(states) == list(want) == pD.file_names
    for name, st in states.items():
        for k, v in want[name].items():
            got = st[k]
            if isinstance(v, dict):
                assert set(got) == set(v), k
                got, v = got["sound"], v["sound"]
            assert got.shape == np.shape(v) and np.isfinite(got).all(), k
        assert st["beliefs"].shape == (39, 1, 64)
    payload = torch.load(os.path.join(run_dir, "models_2.pt"),
                         weights_only=True)["model"]
    (model,) = loaded
    for k, v in model.state_dict().items():
        assert torch.equal(v, payload[k]), k


def test_check_model_cli_writes_the_jax_artifacts(trained_run, monkeypatch):
    """``cli.check_model --device cpu``: the JAX CLI's artifact names
    (``.png`` with PIL, else ``.npy``), finite metrics, every episode
    projected, and the running stats left as loaded."""
    root, run_dir = trained_run
    loaded = []
    load = se.load_eval_model
    monkeypatch.setattr(se, "load_eval_model",
                        lambda *a: loaded.append(load(*a)) or loaded[-1])
    out = cli_check.main(["--run", run_dir, "--itr", "2", "--episode", "1",
                          "--t-start", "5", "--horizon", "10", "--cwd",
                          str(root), "--device", "cpu"])
    try:
        import PIL  # noqa: F401
        grid = ".png"
    except ImportError:
        grid = ".npy"
    want = {f"reconstruction_image_horizon{grid}",
            f"imagination_image_horizon{grid}", "pca_beliefs.npy",
            "pca_posterior_means.npy", "expert_distributions.npy",
            "imagination_mse.json"}
    assert want <= set(out["files"])
    with open(os.path.join(out["out_dir"], "imagination_mse.json")) as f:
        report = json.load(f)
    assert (report["t_start"], report["horizon"]) == (5, 10)
    for name in NAMES:
        assert np.isfinite(report["mse"][name])
        assert np.isfinite(report["metrics"][name]["psnr"])
    assert np.isfinite(report["metrics"]["image_horizon"]["ssim"])
    proj = np.load(os.path.join(out["out_dir"], "pca_beliefs.npy"),
                   allow_pickle=True)
    assert len(proj) == 3 and proj[0].shape == (39, 3)
    experts = np.load(os.path.join(out["out_dir"], "expert_distributions.npy"),
                      allow_pickle=True).item()
    assert set(experts["expert_means"]) == {"prior_expert", *NAMES}
    assert len(experts["subset_means"]) == 4
    payload = torch.load(os.path.join(run_dir, "models_2.pt"),
                         weights_only=True)["model"]
    for k, v in loaded[0].state_dict().items():
        assert torch.equal(v, payload[k]), k


@pytest.mark.parametrize("present,error", [
    ("models_2.msgpack", ValueError), (None, FileNotFoundError)])
def test_eval_clis_refuse_what_they_cannot_load(trained_run, tmp_path,
                                                present, error):
    """A run dir holding only a ``.msgpack`` that is not a JAX package
    checkpoint raises ``ValueError`` in both CLIs (a real one loads:
    tests/test_torch_port_bridges.py); one without a checkpoint raises
    ``FileNotFoundError`` in ``check_model`` and is skipped by
    ``estimate_state``."""
    root, run_dir = trained_run
    target = tmp_path / "runs" / "run_0"
    target.mkdir(parents=True)
    shutil.copy(os.path.join(run_dir, "hydra_config.yaml"), target)
    if present:
        (target / present).write_bytes(b"\0")
    common = ["--itr", "2", "--cwd", str(root), "--device", "cpu"]
    bad = "not a JAX package checkpoint"
    with pytest.raises(error, match=bad if present else "models_2"):
        cli_check.main(["--run", str(target), *common])
    if present:
        with pytest.raises(error, match=bad):
            cli_estimate.main(["--targets", str(target.parent), *common])
    else:
        assert cli_estimate.main(["--targets", str(target.parent), *common]) == []


def test_eval_clis_raise_without_gpu(trained_run, monkeypatch):
    root, run_dir = trained_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_estimate.main(["--targets", os.path.dirname(run_dir), "--itr", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_check.main(["--run", run_dir, "--itr", "2"])
