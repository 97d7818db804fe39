"""PyTorch port, the file bridges: the JAX package's ``.msgpack``
checkpoints (``io/flax_msgpack.py``, ``io/checkpoint.py``), the reference
``.pth`` export (``io/torch_export.py``, ``cli/export_torch.py``), the
cross-check CLI's comparison helpers, the run archive's ``git_hash``, the
loop's histograms and profile trace, and the config keys the port checks
only (``train.mesh``, ``rssm.convt_impl``, ``rssm.scan_unroll``).

The fixture ``tests/torch_port_fixtures/jax_unimodal_pose.msgpack`` is a
JAX package checkpoint written by its own ``save_checkpoint`` after one
optimizer step (``write_fixture`` below; ``JAX_PLATFORMS=cpu PYTHONPATH=.
python tests/test_torch_port_bridges.py`` rewrites it): ``rssm=unimodal``
over the symbolic ``pose_quat_v2`` observation at belief 64 / state 16 /
hidden 32 (470 KB; at hidden 64, 620 KB; the image and sound codecs make
even the smallest multimodal file several MB).  Beside it
``jax_unimodal_pose.npz`` holds the JAX package's det ``estimate_state`` on
a seeded 20-step episode and the parameters and Adam state after one more
JAX step on the deterministic path (``key=None``), in the port's names,
with the inputs of both and the configuration's overrides;
``chip_smoke.py`` holds the card against them.

Tolerances:
- the decoder, the weights, the ``.pth`` and its read-back exactly (bytes
  and layout transforms);
- the estimate at rtol 1e-5, atol 1e-6 (float32 matmuls over a 20-step
  recurrence, ordered differently by each library);
- one step from the ``.msgpack``: parameters and Adam's first moment at
  rtol 1e-5, atol 1e-7, the second moment at rtol 1e-4, atol 1e-12 (a
  square of float32 gradients that differ by rounding), the step count
  exactly;
- the histograms' counts and bins exactly, their moments at rtol 1e-5
  (float32 sums over the same values in another order);
- the committed fixture against a fresh write at rtol 1e-6, atol 1e-7.
"""

import functools
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from hypothesis import given, settings, strategies as st

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.core.config import save_config as jsave_config
from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.eval import state_estimation as jse
from multimodal_rssm_tpu.io import checkpoint as jckpt
from multimodal_rssm_tpu.io import metrics as jmetrics
from multimodal_rssm_tpu.io import torch_export as jexport
from multimodal_rssm_tpu.io import torch_import as jimport
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWM
from multimodal_rssm_tpu.train import behavior as jbh
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.cli import crosscheck_torch as cli_cross
from multimodal_rssm_torch.cli import estimate_state as cli_estimate
from multimodal_rssm_torch.cli import export_torch as cli_export
from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import (
    compose, load_run_config, save_config)
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.eval import state_estimation as se
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io import flax_msgpack
from multimodal_rssm_torch.io.jax_weights import (
    policy_state_dict_from_jax, state_dict_from_jax)
from multimodal_rssm_torch.io.metrics import (
    MetricLogger, get_git_hash, histogram_record)
from multimodal_rssm_torch.io.torch_export import (
    reference_state_dict, save_reference_checkpoint)
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.train import behavior as bh
from multimodal_rssm_torch.train import loop
from multimodal_rssm_torch.train import trainer as tr
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "tests", "torch_port_fixtures")
FIXTURE = os.path.join(FIXTURE_DIR, "jax_unimodal_pose.msgpack")
FIXTURE_NPZ = os.path.join(FIXTURE_DIR, "jax_unimodal_pose.npz")
# the fixture's configuration (the card's smoke test repeats it)
FIXTURE_OVERRIDES = [
    "rssm=unimodal", "rssm.observation_names_enc=[pose_quat_v2]",
    "rssm.observation_names_rec=[pose_quat_v2]", "rssm.belief_size=64",
    "rssm.state_size=16", "rssm.hidden_size=32",
    "rssm.embedding_size.other=16", "rssm.embedding_size.fusion=64",
    "train.use_amp=False"]
EPISODE_T, STEP_L, STEP_B = 20, 6, 4
SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pose_batch(rng, L, B):
    """(observations, actions, rewards, nonterminals) of the pose model."""
    nt = np.ones((L, B, 1), np.float32)
    nt[L // 2, 0] = 0.0
    return ({"pose_quat_v2": rng.normal(size=(L, B, 3)).astype(np.float32)},
            rng.normal(size=(L, B, 3)).astype(np.float32),
            rng.normal(size=(L, B)).astype(np.float32), nt)


def jax_step(jm, jcfg, state, batch):
    """One JAX train step on the deterministic path (``key=None``): the
    TrainState after the clipped Adam update."""
    loss_fn = jtr.make_loss_fn(jm, jcfg)
    (_, (stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params, state.batch_stats, batch, None, True)
    updates, opt_state = jtr.build_optimizer(jcfg).update(
        grads, state.opt_state, state.params)
    return state.replace(step=state.step + 1,
                         params=optax.apply_updates(state.params, updates),
                         batch_stats=stats, opt_state=opt_state)


def write_fixture(out_dir: str) -> None:
    """The JAX package's checkpoint after one deterministic step from a
    seeded init (its ``save_checkpoint``), and the ``.npz`` of its det
    estimate and of one more step (see the module docstring)."""
    jcfg = jax_compose(overrides=FIXTURE_OVERRIDES)
    jm = JaxWM.from_config(jcfg)
    rng = np.random.default_rng(0)
    b1 = _pose_batch(rng, STEP_L, STEP_B)
    variables = _np_tree(jm.init(
        jax.random.PRNGKey(0), {k: v[1:] for k, v in b1[0].items()},
        b1[1][:-1], None, None, train=False))
    state = jtr.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=jtr.build_optimizer(jcfg).init(variables["params"]))
    state = jax_step(jm, jcfg, state, b1)
    os.makedirs(out_dir, exist_ok=True)
    path = jckpt.save_checkpoint(out_dir, 1, state)
    os.replace(path, os.path.join(out_dir, os.path.basename(FIXTURE)))

    episode = _pose_batch(rng, EPISODE_T, 1)
    est = jm.apply({"params": state.params}, episode[0], episode[1],
                   episode[3], None, True, False, method=jm.estimate_state)
    b2 = _pose_batch(rng, STEP_L, STEP_B)
    after = jax_step(jm, jcfg, state, b2)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        after.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    out = {"episode/pose_quat_v2": episode[0]["pose_quat_v2"],
           "episode/actions": episode[1], "episode/nonterminals": episode[3],
           "estimate/beliefs": np.asarray(est["beliefs"]),
           "estimate/posterior_means": np.asarray(est["posterior_means"]),
           "batch/pose_quat_v2": b2[0]["pose_quat_v2"],
           "batch/actions": b2[1], "batch/rewards": b2[2],
           "batch/nonterminals": b2[3], "step/count": np.asarray(adam.count),
           "config/overrides": np.asarray(FIXTURE_OVERRIDES)}
    for tag, tree in (("params", after.params), ("exp_avg", adam.mu),
                      ("exp_avg_sq", adam.nu)):
        for k, v in state_dict_from_jax(_np_tree(tree), None).items():
            out[f"step/{tag}/{k}"] = v.numpy()
    np.savez(os.path.join(out_dir, os.path.basename(FIXTURE_NPZ)), **out)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fixture_npz():
    with np.load(FIXTURE_NPZ) as z:
        return dict(z)


def _step_tensors(npz, tag):
    prefix = f"step/{tag}/"
    return {k[len(prefix):]: v for k, v in npz.items()
            if k.startswith(prefix)}


def _assert_same_tree(got, want, path=""):
    """Decoded trees equal: the same keys and types, arrays equal with
    their dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert list(map(type, got)) == list(map(type, want)) or len(
            got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and (got == want or (
            got != got and want != want)), (path, got, want)


# -- the msgpack decoder ----------------------------------------------------------


_LEAF = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=True), st.text(max_size=300),
    st.binary(max_size=300),
    st.builds(lambda shape, dt, seed: np.random.default_rng(seed).normal(
        size=shape).astype(dt), st.lists(st.integers(0, 4), max_size=3),
        st.sampled_from(["float32", "float64", "int32", "int8", "uint16"]),
        st.integers(0, 1000)),
    st.builds(lambda v, dt: np.dtype(dt).type(v), st.integers(-100, 100),
              st.sampled_from(["float32", "int64", "int16"])),
    st.builds(complex, st.floats(-1e3, 1e3), st.floats(-1e3, 1e3)))
_TREE = st.recursive(
    _LEAF, lambda kids: st.one_of(
        st.lists(kids, max_size=20),
        st.dictionaries(st.text(max_size=20), kids, max_size=20)),
    max_leaves=60)


@settings(max_examples=60, deadline=None)
@given(_TREE)
def test_decoder_matches_flax_and_msgpack(tree):
    """Hypothesis trees of every msgpack and flax ext type: the decoder
    returns what ``flax.serialization.msgpack_restore`` does, and on plain
    data what the ``msgpack`` package does (lengths past the fix forms:
    str / bin / array / map up to 300 and 20)."""
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(flax_msgpack.loads(data),
                      serialization.msgpack_restore(data))
    plain = msgpack.packb(["x" * 70000, b"\1" * 70000, list(range(70000)),
                           {str(i): i for i in range(20)}], use_bin_type=True)
    assert flax_msgpack.loads(plain) == msgpack.unpackb(plain, raw=False)


@pytest.mark.parametrize("max_chunk", [16, 1000])
def test_decoder_restores_chunked_arrays(max_chunk, monkeypatch):
    """flax splits an array over ``MAX_CHUNK_SIZE`` bytes into chunks; the
    threshold is lowered here instead of writing 1 GiB."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", max_chunk)
    rng = np.random.default_rng(1)
    tree = {"big": rng.normal(size=(50, 7)).astype(np.float32),
            "nested": {"w": rng.integers(0, 9, (3, 4, 5)).astype(np.int64),
                       "small": np.ones(2, np.float32)}}
    data = serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, raw=False)
    assert flax_msgpack.CHUNKED in raw["big"]
    got = flax_msgpack.loads(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_decoder_rejects_truncated_and_trailing_data():
    data = serialization.msgpack_serialize({"a": np.arange(5.0)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(data[:-3])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(data + b"\0")


# -- the fixture -------------------------------------------------------------------


def test_committed_fixture_is_what_the_jax_package_writes_now(tmp_path):
    """A fresh ``write_fixture`` equals the committed files: the msgpack
    decoded leaf for leaf, the npz array for array."""
    write_fixture(str(tmp_path))
    assert os.path.getsize(FIXTURE) <= 512 * 1024
    _assert_same_tree(flax_msgpack.load(str(tmp_path / os.path.basename(
        FIXTURE))), flax_msgpack.load(FIXTURE))
    fresh = dict(np.load(tmp_path / os.path.basename(FIXTURE_NPZ)))
    committed = _fixture_npz()
    assert set(fresh) == set(committed)
    np.testing.assert_array_equal(committed.pop("config/overrides"),
                                  FIXTURE_OVERRIDES)
    for k, v in committed.items():
        np.testing.assert_allclose(fresh[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_decoder_reads_the_fixture_as_flax_does():
    with open(FIXTURE, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    _assert_same_tree(flax_msgpack.load(FIXTURE), want)


@pytest.fixture(scope="module")
def pose_models():
    """The JAX model of the fixture with its variables as the JAX package
    reads them, and the port's config."""
    jcfg = jax_compose(overrides=FIXTURE_OVERRIDES)
    jm = JaxWM.from_config(jcfg)
    variables = jse.load_model_variables(jm, jcfg, FIXTURE)
    return jm, jcfg, variables, compose(overrides=FIXTURE_OVERRIDES)


def test_msgpack_weights_load_as_the_jax_package_reads_them(pose_models):
    _, _, variables, cfg = pose_models
    model = WorldModel.from_config(cfg)
    ckpt.load_model_weights(FIXTURE, model)
    want = state_dict_from_jax(_np_tree(variables["params"]), None)
    assert set(model.state_dict()) == set(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_msgpack_estimate_matches_the_jax_package(pose_models):
    """The det estimate of the fixture's episode, eval mode, against the
    JAX package's on the same file, now and as stored."""
    jm, _, variables, cfg = pose_models
    npz = _fixture_npz()
    obs = {"pose_quat_v2": npz["episode/pose_quat_v2"]}
    want = jm.apply(variables, obs, npz["episode/actions"],
                    npz["episode/nonterminals"], None, True, False,
                    method=jm.estimate_state)
    model = WorldModel.from_config(cfg)
    ckpt.load_model_weights(FIXTURE, model)
    with torch.no_grad():
        got = model.eval().estimate_state(
            {"pose_quat_v2": _t(obs["pose_quat_v2"])},
            _t(npz["episode/actions"]), _t(npz["episode/nonterminals"]))
    for k in ("beliefs", "posterior_means"):
        assert got[k].shape == npz[f"estimate/{k}"].shape
        for ref in (np.asarray(want[k]), npz[f"estimate/{k}"]):
            np.testing.assert_allclose(got[k].numpy(), ref, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_model_path_msgpack_then_one_step_matches_jax(pose_models, tmp_path):
    """``train.model_path=<.msgpack>`` restores the whole TrainState (the
    JAX loop's ``load_checkpoint``); one deterministic step from it equals
    the JAX package's step from the same file: parameters, Adam's moments
    and its count."""
    jm, jcfg, _, cfg = pose_models
    npz = _fixture_npz()
    template = jtr.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jse.load_model_variables(jm, jcfg, FIXTURE)["params"],
        batch_stats={},
        opt_state=jtr.build_optimizer(jcfg).init(
            jse.load_model_variables(jm, jcfg, FIXTURE)["params"]))
    jstate, jstep, _ = jckpt.load_checkpoint(FIXTURE, template)
    batch = ({"pose_quat_v2": npz["batch/pose_quat_v2"]},
             npz["batch/actions"], npz["batch/rewards"],
             npz["batch/nonterminals"])
    after = jax_step(jm, jcfg, jstate, batch)
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        after.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]

    cfg.train.model_path = os.path.basename(FIXTURE)
    model = WorldModel.from_config(cfg)
    opt, sched = tr.build_optimizer(cfg, model)
    loop.load_model_path(cfg, FIXTURE_DIR, model, opt, sched)
    assert opt.state_dict()["state"][0]["step"].item() == jstep == 1
    train_raw = ({"pose_quat_v2": _t(batch[0]["pose_quat_v2"])},
                 _t(batch[1]), _t(batch[2]), _t(batch[3]))
    # the deterministic path: the loss without a generator
    loss_fn = tr.make_loss_fn(model, cfg)
    opt.zero_grad(set_to_none=True)
    loss, _ = loss_fn(train_raw, None, True)
    loss.backward()
    tr.apply_gradients(model, opt, sched, float(cfg.rssm.grad_clip_norm))
    names = [n for n, _ in model.named_parameters()]
    state = opt.state_dict()["state"]
    for want in (state_dict_from_jax(_np_tree(after.params), None),
                 {k: _t(v) for k, v in _step_tensors(npz, "params").items()}):
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=n)
    for tag, key, tol in (("exp_avg", adam.mu, (1e-5, 1e-7)),
                          ("exp_avg_sq", adam.nu, (1e-4, 1e-12))):
        for want in (state_dict_from_jax(_np_tree(key), None),
                     {k: _t(v) for k, v in _step_tensors(npz, tag).items()}):
            for i, n in enumerate(names):
                np.testing.assert_allclose(
                    state[i][tag].numpy(), want[n].numpy(), rtol=tol[0],
                    atol=tol[1], err_msg=f"{tag} {n}")
    # torch's Adam skips a parameter without a gradient (the reward head
    # here: rssm.predict_reward is off), optax steps it on a zero one; both
    # leave it where it is, its moments at 0
    idle = {i for i, (_, p) in enumerate(model.named_parameters())
            if p.grad is None}
    assert {names[i] for i in idle} == {n for n in names
                                        if n.startswith("reward_model.")}
    for i in idle:
        assert not state[i]["exp_avg"].any()
    assert {float(s["step"]) for i, s in state.items() if i not in idle} == {
        float(adam.count)} == {float(npz["step/count"])} == {2.0}
    assert {float(state[i]["step"]) for i in idle} == {1.0}


@pytest.mark.parametrize("schedule", [0, 5])
def test_msgpack_train_state_carries_the_warmup(schedule, tmp_path):
    """With ``rssm.learning_rate_schedule`` the optax schedule's count goes
    to the LR schedule (the lr of the next step is the JAX one's); a file
    and a run that disagree on having a schedule raise."""
    over = FIXTURE_OVERRIDES + [f"rssm.learning_rate_schedule={schedule}"]
    jcfg = jax_compose(overrides=over)
    jm = JaxWM.from_config(jcfg)
    rng = np.random.default_rng(3)
    b = _pose_batch(rng, STEP_L, STEP_B)
    variables = _np_tree(jm.init(jax.random.PRNGKey(2),
                                 {k: v[1:] for k, v in b[0].items()},
                                 b[1][:-1], None, None, train=False))
    state = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                           params=variables["params"], batch_stats={},
                           opt_state=jtr.build_optimizer(jcfg).init(
                               variables["params"]))
    for _ in range(3):
        state = jax_step(jm, jcfg, state, b)
    path = jckpt.save_checkpoint(str(tmp_path), 3, state)
    cfg = compose(overrides=over)
    model = WorldModel.from_config(cfg)
    opt, sched = tr.build_optimizer(cfg, model)
    assert ckpt.load_jax_train_state(path, model, opt, sched) == 3
    if schedule:
        assert sched.last_epoch == 3
        assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 3 / 5)
    other = compose(overrides=FIXTURE_OVERRIDES + [
        f"rssm.learning_rate_schedule={5 - schedule}"])
    model = WorldModel.from_config(other)
    opt, sched = tr.build_optimizer(other, model)
    with pytest.raises(ValueError, match="must go together"):
        ckpt.load_jax_train_state(path, model, opt, sched)


def test_msgpack_without_optimizer_state_raises(tmp_path):
    """A file whose optimizer state the port cannot carry is refused, not
    started from zeros: no Adam state, and a file with no state at all."""
    payload = flax_msgpack.load(FIXTURE)
    state = dict(payload["state"], opt_state={"0": {}})
    path = tmp_path / "models_1.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"step": 1, "state": state, "extra": {}}))
    cfg = compose(overrides=FIXTURE_OVERRIDES)
    model = WorldModel.from_config(cfg)
    opt, sched = tr.build_optimizer(cfg, model)
    with pytest.raises(ValueError, match="cannot be carried"):
        ckpt.load_jax_train_state(str(path), model, opt, sched)
    path.write_bytes(serialization.msgpack_serialize({"step": 1}))
    with pytest.raises(ValueError, match="not a JAX package checkpoint"):
        ckpt.load_model_weights(str(path), model)


def test_eval_clis_take_a_jax_run(pose_models, tmp_path, monkeypatch):
    """A JAX run dir (its ``hydra_config.yaml``, ``models_1.msgpack``):
    ``latest_checkpoint`` / ``find_model_checkpoint`` find the file and
    ``cli.estimate_state`` evaluates the weights the JAX package reads from
    it, writing JAX ``get_states``' keys and shapes."""
    jm, jcfg, variables, _ = pose_models
    root = tmp_path
    write_synthetic_dataset(str(root / "train"), 2, 21, {"pose_quat_v2": [3]},
                            seed=4)
    run = root / "results" / "jax" / "run_0"
    run.mkdir(parents=True)
    jcfg.train.train_data_path = ["train"]
    jsave_config(jcfg, str(run / "hydra_config.yaml"))
    os.link(FIXTURE, run / "models_1.msgpack")
    assert ckpt.latest_checkpoint(str(run)) == str(run / "models_1.msgpack")
    assert ckpt.find_model_checkpoint(str(run), 1) == str(
        run / "models_1.msgpack")
    assert ckpt.latest_checkpoint(str(run), (".pt",)) is None
    loaded = []
    load = se.load_eval_model
    monkeypatch.setattr(se, "load_eval_model",
                        lambda *a: loaded.append(load(*a)) or loaded[-1])
    (saved,) = cli_estimate.main(["--targets", str(run.parent), "--itr", "1",
                                  "--cwd", str(root), "--device", "cpu"])
    want_sd = state_dict_from_jax(_np_tree(variables["params"]), None)
    for k, v in loaded[0].state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    got = np.load(saved, allow_pickle=True).item()
    jD = jax_buffer.build_buffer(jcfg)
    jD.load_dataset(str(root / "train"))
    want = jse.get_states(jm, variables, jD)
    assert list(got) == list(want)
    for name in want:
        for k in ("beliefs", "posterior_means"):
            assert got[name][k].shape == np.shape(want[name][k]) == (
                (20, 1, 64) if k == "beliefs" else (20, 1, 16))
            assert np.isfinite(got[name][k]).all()


def test_resume_of_a_jax_run_dir_raises(data_dir, tmp_path):
    """``--resume`` continues a port run; a dir with only the JAX package's
    checkpoints raises instead of starting over in it."""
    run = tmp_path / "run_0"
    run.mkdir()
    save_config(compose(overrides=SMALL + [
        f"train.train_data_path=[{data_dir}/train]",
        f"train.validation_data_path=[{data_dir}/val]",
        "train.batch_size=2", "train.chunk_size=4",
        "train.experience_size=200"]), str(run / "hydra_config.yaml"))
    os.link(FIXTURE, run / "models_1.msgpack")
    with pytest.raises(ValueError, match="train.model_path"):
        _train(data_dir, "train.train_iteration=2", "--resume", str(run))


def _behavior_file(tmp_path, drop_return_scale):
    """A JAX ``BehaviorState`` after one update, written by the JAX
    package's ``save_checkpoint`` (optionally without ``return_scale``, as
    a file from before the field)."""
    cfg = jbh.behavior_cfg(jax_compose(overrides=FIXTURE_OVERRIDES))
    actor, value = jbh.build_policy_models(cfg)
    aopt, vopt = jbh.build_behavior_optimizers(cfg)
    bstate = jbh.init_behavior_state(cfg, actor, value, aopt, vopt,
                                     jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    grads = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype),
        (bstate.actor_params, bstate.value_params))
    au, aos = aopt.update(grads[0], bstate.actor_opt_state,
                          bstate.actor_params)
    vu, vos = vopt.update(grads[1], bstate.value_opt_state,
                          bstate.value_params)
    bstate = bstate.replace(
        step=bstate.step + 1,
        actor_params=optax.apply_updates(bstate.actor_params, au),
        value_params=optax.apply_updates(bstate.value_params, vu),
        actor_opt_state=aos, value_opt_state=vos,
        return_scale=jnp.asarray(2.5, jnp.float32))
    path = jckpt.save_checkpoint(str(tmp_path), 4, bstate)
    if drop_return_scale:
        payload = flax_msgpack.load(path)
        payload["state"].pop("return_scale")
        with open(path, "wb") as f:
            f.write(serialization.msgpack_serialize(payload))
    return path, bstate


@pytest.mark.parametrize("drop_return_scale", [False, True])
def test_behavior_msgpack_loads(drop_return_scale, tmp_path, caplog):
    """``behavior/models_{itr}.msgpack`` into the port's ``BehaviorState``:
    both heads through ``policy_state_dict_from_jax``, both Adam states,
    the step; a file without ``return_scale`` starts it at the fresh
    state's 1 with the JAX package's warning."""
    path, jstate = _behavior_file(tmp_path, drop_return_scale)
    cfg = bh.behavior_cfg(compose(overrides=FIXTURE_OVERRIDES))
    bstate = bh.init_behavior_state(cfg, torch.device("cpu"))
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    with caplog.at_level("WARNING"):
        assert ckpt.load_behavior_checkpoint(path, bstate) == 4
    assert ("predates state field(s) /return_scale" in caplog.text) == (
        drop_return_scale)
    assert bstate.step == 1
    assert float(bstate.return_scale) == (1.0 if drop_return_scale else 2.5)
    actor, value = policy_state_dict_from_jax(
        _np_tree(jstate.actor_params), _np_tree(jstate.value_params))
    for module, want in ((bstate.actor, actor), (bstate.value, value)):
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), k
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        jstate.actor_opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    mu = policy_state_dict_from_jax(_np_tree(adam.mu), {})[0]
    state = bstate.actor_opt.state_dict()["state"]
    for i, (n, _) in enumerate(bstate.actor.named_parameters()):
        assert torch.equal(state[i]["exp_avg"], mu[n]), n
        assert float(state[i]["step"]) == 1.0


def test_control_and_analysis_clis_take_a_jax_run(data_dir, tmp_path):
    """A JAX run dir written by the JAX package (its config, its
    ``save_checkpoint`` of a TrainState and of a ``BehaviorState`` under
    ``behavior/``): ``check_model``, ``train_behavior --model-path`` and
    ``eval_policy --policy actor`` run on it, each on the weights the file
    holds."""
    from multimodal_rssm_torch.cli import check_model as cli_check
    from multimodal_rssm_torch.cli import eval_policy as cli_eval
    from multimodal_rssm_torch.cli import train_behavior as cli_behavior

    jm, variables, _ = _default_pair()
    jcfg = jax_compose(overrides=SMALL + [
        "rssm.remat=false", f"train.train_data_path=[{data_dir}/train]",
        "train.batch_size=2", "train.chunk_size=4",
        "train.experience_size=200"])
    run = tmp_path / "run_0"
    run.mkdir()
    jsave_config(jcfg, str(run / "hydra_config.yaml"))
    jckpt.save_checkpoint(str(run), 3, jtr.TrainState(
        step=np.asarray(3, np.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jtr.build_optimizer(jcfg).init(variables["params"])))
    bcfg = jbh.behavior_cfg(jcfg)
    actor, value = jbh.build_policy_models(bcfg)
    bstate = jbh.init_behavior_state(bcfg, actor, value,
                                     *jbh.build_behavior_optimizers(bcfg),
                                     jax.random.PRNGKey(7))
    jckpt.save_checkpoint(str(run / "behavior"), 2, bstate)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"])

    def same(model):
        for k, v in model.state_dict().items():
            assert torch.equal(v.cpu(), want[k]), k

    out = cli_check.main(["--run", str(run), "--itr", "3", "--t-start", "2",
                          "--horizon", "3", "--cwd", str(data_dir),
                          "--device", "cpu"])
    assert np.isfinite(out["mse"]["image_horizon"])
    result = cli_behavior.main([
        "--run-dir", str(run), "--cwd", str(data_dir), "--device", "cpu",
        "--model-path", str(run / "models_3.msgpack"),
        "behavior.train_iteration=1", "behavior.horizon=3",
        "behavior.checkpoint_interval=1"])
    assert all(np.isfinite(v) for v in result["metrics"].values())
    loaded, heads = [], []
    load, load_heads = se.load_eval_model, ckpt.load_behavior_checkpoint
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(se, "load_eval_model",
                   lambda *a: loaded.append(load(*a)) or loaded[-1])
        mp.setattr(ckpt, "load_behavior_checkpoint",
                   lambda path, b: heads.append(path) or load_heads(path, b))
        stats = cli_eval.main(["--run-dir", str(run), "--device", "cpu",
                               "--episodes", "1", "--env-length", "4"])
    same(loaded[0])
    # the JAX heads at itr 2, newer than train_behavior's models_1.pt
    assert heads == [str(run / "behavior" / "models_2.msgpack")]
    assert stats["mean_steps"] == 4 and np.isfinite(stats["mean_return"])


# -- the reference .pth --------------------------------------------------------------


def _default_pair(over=()):
    """A JAX default-config model initialised from a seed (running stats
    moved off their init) and the port's model on the same weights."""
    jcfg = jax_compose(overrides=SMALL + ["rssm.remat=false", *over])
    jm = JaxWM.from_config(jcfg)
    rng = np.random.default_rng(0)
    T, B = 3, 2
    obs = {n: rng.uniform(-.5, .5, (T, B, *s)).astype(np.float32)
           for n, s in (("image_horizon", (64, 64, 3)), ("sound", (128, 20)))
           if n in jm.observation_names_enc}
    act = rng.normal(size=(T, B, 3)).astype(np.float32)
    variables = _np_tree(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(0), obs, act, None, None))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    port = WorldModel.from_config(compose(overrides=SMALL + list(over)))
    port.load_state_dict(state_dict_from_jax(variables["params"],
                                             variables["batch_stats"]))
    return jm, variables, port


def _assert_same_pth(got, want, path=""):
    assert type(got) is type(want), path
    if isinstance(want, dict):   # the keys in any order
        assert set(got) == set(want), path
        for k in want:
            _assert_same_pth(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("over", [(), ("rssm=unimodal",),
                                  ("rssm.normalization=InstanceNorm",)])
def test_pth_equals_the_jax_export_and_reads_back(over, tmp_path):
    """The port's ``.pth`` against JAX ``save_reference_checkpoint`` on the
    same weights, key for key and tensor for tensor (the fresh
    ``model_optimizer``'s group and parameter counts included); the JAX
    importer reads it back to the JAX variables; the port's loader to its
    own ``state_dict``."""
    jm, variables, port = _default_pair(over)
    ours, theirs = tmp_path / "port.pth", tmp_path / "jax.pth"
    save_reference_checkpoint(str(ours), port, lr=3e-4, eps=1e-7)
    jexport.save_reference_checkpoint(str(theirs), jm, variables, lr=3e-4,
                                      eps=1e-7)
    got = torch.load(ours, weights_only=True)
    want = torch.load(theirs, weights_only=True)
    _assert_same_pth(got, want)
    if "rssm=unimodal" not in over:
        groups = got["model_optimizer"]["param_groups"]
        assert len(groups) == 1 and groups[0]["lr"] == 3e-4
        assert len(groups[0]["params"]) == len(list(port.parameters()))
    else:
        assert "model_optimizer" not in got
    back = jimport.load_reference_checkpoint(str(ours), jm)
    for tree in ("params", "batch_stats"):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               _np_tree(back[tree]), variables[tree])
    again = WorldModel.from_config(compose(overrides=SMALL + list(over)))
    ckpt.load_model_weights(str(ours), again)
    for k, v in port.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


@pytest.mark.parametrize("over,error", [
    (("rssm.latent_dist=categorical", "rssm.categorical_params.variables=4",
      "rssm.categorical_params.classes=4"), ValueError),
    (("rssm.multimodal_params.expert_dist=q(st|ot)",), NotImplementedError)])
def test_pth_export_refuses_what_the_reference_schema_lacks(over, error):
    port = WorldModel.from_config(compose(overrides=SMALL + list(over)))
    with pytest.raises(error):
        reference_state_dict(port)


@pytest.mark.parametrize("source", ["pt", "msgpack"])
def test_export_torch_cli(source, pose_models, tmp_path):
    """``cli.export_torch`` from a port ``models_{itr}.pt`` and from a JAX
    run's ``models_{itr}.msgpack``: the file the JAX CLI writes from the
    same weights (lr 0 under a warm-up schedule)."""
    jm, jcfg, variables, cfg = pose_models
    run = tmp_path / "run_0"
    run.mkdir()
    cfg.rssm.learning_rate_schedule = 10
    save_config(cfg, str(run / "hydra_config.yaml"))
    model = WorldModel.from_config(cfg)
    ckpt.load_model_weights(FIXTURE, model)
    if source == "pt":
        opt, sched = tr.build_optimizer(cfg, model)
        ckpt.save_checkpoint(str(run), 1, model, opt, sched)
    else:
        os.link(FIXTURE, run / "models_1.msgpack")
    out = cli_export.main(["--run-dir", str(run)])
    assert out == str(run / "torch_export" / "models_1.pth")
    want = tmp_path / "jax.pth"
    jexport.save_reference_checkpoint(str(want), jm, variables, lr=0.0)
    _assert_same_pth(torch.load(out, weights_only=True),
                     torch.load(want, weights_only=True))
    with pytest.raises(FileNotFoundError, match="models_7"):
        cli_export.main(["--run-dir", str(run), "--itr", "7"])


# -- the cross-check CLI ---------------------------------------------------------------


def test_crosscheck_helpers_and_missing_reference(tmp_path):
    """``compare`` / ``verdict`` on made-up outputs of both models (images
    channels-last for ours, channels-first for the reference), and the
    CLI's exit without the reference checkout."""
    rng = np.random.default_rng(0)
    T, H = 10, 4
    states = {k: rng.normal(size=(T, 1, 8)) for k in ("beliefs",
                                                     "posterior_means")}
    ref_states = {k: v + 1e-4 for k, v in states.items()}
    targets = {"image_horizon": rng.normal(size=(T, 1, 8, 8, 3)),
               "sound": rng.normal(size=(T, 1, 128, 20))}
    ours = {k: v[3:3 + H] + 0.01 for k, v in targets.items()}
    ref = {k: cli_cross.to_channels_first(v - 0.01) for k, v in ours.items()}
    result = cli_cross.compare(states, ref_states, ours, ref, targets, 2, H,
                               {"image_horizon": 1e-4, "sound": 1e-4})
    for k in ("beliefs", "posterior_means"):
        assert result["latent_max_abs_diff"][k] == pytest.approx(1e-4)
    for name in targets:
        assert result["imagination_cross_framework_mse"][name] == \
            pytest.approx(1e-4)
        assert result["imagination_mse_vs_gt"]["torch"][name] == \
            pytest.approx(0.0, abs=1e-20)
    assert json.loads(json.dumps(result)) == result
    assert cli_cross.verdict(result, 5e-3, 1e-3)[0]
    ok, line = cli_cross.verdict(result, 5e-3, 5e-5)
    assert not ok and line.startswith("MISMATCH")
    with pytest.raises(SystemExit, match="reference checkout not found at"):
        cli_cross.require_reference(str(tmp_path / "absent"))


# -- the run archive, histograms and the profile trace -----------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("bridges_data")
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(root / "train"), 2, 30, shapes)
    write_synthetic_dataset(str(root / "val"), 1, 30, shapes, seed=9)
    return root


def _train(root, *extra):
    return cli_train.main(SMALL + [
        f"train.train_data_path=[{root}/train]",
        f"train.validation_data_path=[{root}/val]", "train.batch_size=2",
        "train.chunk_size=4", "train.experience_size=200",
        "train.validation_interval=3", *extra, "--device", "cpu", "--cwd",
        str(root)])


@pytest.mark.parametrize("feed", ["true", "false"])
def test_histograms_leave_training_bit_equal(data_dir, feed):
    """6 steps with ``train.histogram_interval=2`` end with every tensor of
    the model and the optimizer bit-equal to 6 steps without; the
    histogram lines are there, per top-level module."""
    runs = [_train(data_dir, "train.train_iteration=6",
                   f"train.device_replay={feed}", *extra)
            for extra in (("train.histogram_interval=2",), ())]
    for k, v in runs[0]["model"].state_dict().items():
        assert torch.equal(v, runs[1]["model"].state_dict()[k]), k
    with open(os.path.join(runs[0]["results_dir"], "metrics.jsonl")) as f:
        hist = [r for r in map(json.loads, f)
                if any(k.endswith("/hist") for k in r)]
    assert [r["step"] for r in hist] == [2, 2, 4, 4, 6, 6]
    mods = ("transition_model", "encoder", "observation_model",
            "reward_model")
    assert set(hist[0]) - {"step", "time"} == {
        f"params_{m}/hist" for m in mods}
    assert set(hist[1]) - {"step", "time"} == {f"grads_{m}/hist" for m in mods}


def test_histogram_values_match_jax_log_histograms(tmp_path):
    """The port's records against JAX ``log_histograms`` on the same
    weights and gradients, the JAX tree regrouped by the port's top-level
    modules (``core`` is ``transition_model``), and the all-NaN case."""
    jm, variables, port = _default_pair()
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32),
        variables["params"])
    grads["reward_model"] = jax.tree_util.tree_map(
        lambda x: np.full_like(x, np.nan), grads["reward_model"])
    grads["core"]["cell"]["rnn"]["wi"][0, :3] = np.inf
    port_grads = state_dict_from_jax(grads, None)
    names = {"core": "transition_model"}
    jlog = jmetrics.MetricLogger(str(tmp_path / "jax"))
    jlog.log_histograms(variables["params"], 1, "params")
    jlog.log_histograms(grads, 1, "grads")
    jlog.finish()
    os.makedirs(tmp_path / "port")
    with MetricLogger(str(tmp_path / "port")) as plog:
        loop.log_histograms(plog, port, port_grads, 1)
    read = [list(map(json.loads, open(tmp_path / d / "metrics.jsonl")))
            for d in ("jax", "port")]
    for jrec, prec in zip(*read):
        assert jrec["step"] == prec["step"] == 1
        keys = {k for k in jrec if k.endswith("/hist")}
        assert len(keys) == 4
        for k in keys:
            prefix, mod = k[:-len("/hist")].split("_", 1)
            want, got = jrec[k], prec[f"{prefix}_{names.get(mod, mod)}/hist"]
            assert set(got) == set(want), k
            assert (got["count"], got["nonfinite"]) == (
                want["count"], want["nonfinite"]), k
            if "bin_counts" in want:
                assert got["bin_counts"] == want["bin_counts"], k
                np.testing.assert_allclose(
                    [got[s] for s in ("min", "max", "mean", "std")],
                    [want[s] for s in ("min", "max", "mean", "std")],
                    rtol=1e-5, err_msg=k)
                np.testing.assert_allclose(got["bin_edges"],
                                           want["bin_edges"], rtol=1e-6)
    nan = read[1][1]["grads_reward_model/hist"]
    assert nan == {"count": nan["count"], "nonfinite": nan["count"]}


@pytest.mark.parametrize("kind", ["normal", "on_edges", "tiny", "constant",
                                  "with_nonfinite"])
def test_histogram_record_bins_as_numpy_does(kind):
    """The record's bins, computed with torch, against ``np.histogram`` on
    the finite values: values on the edges, values near 1e-12 and a
    constant array (NumPy widens its range by 0.5) included."""
    rng = np.random.default_rng(len(kind))
    x = {"normal": rng.normal(size=5000),
         "on_edges": np.concatenate([rng.integers(-8, 9, 3000),
                                     np.linspace(-8, 8, 17)]),
         "tiny": rng.normal(size=2000) * 1e-12,
         "constant": np.full(300, 3.0),
         "with_nonfinite": np.concatenate([rng.uniform(-1, 1, 999),
                                           [np.nan, np.inf, -np.inf]])}[kind]
    x = x.astype(np.float32)
    rec = histogram_record(torch.from_numpy(x))
    finite = x[np.isfinite(x)]
    counts, edges = np.histogram(finite, bins=16)
    assert rec["bin_counts"] == counts.tolist()
    assert rec["bin_edges"] == [float(e) for e in edges]
    assert (rec["count"], rec["nonfinite"]) == (x.size, x.size - finite.size)
    assert (rec["min"], rec["max"]) == (float(finite.min()),
                                        float(finite.max()))
    np.testing.assert_allclose([rec["mean"], rec["std"]],
                               [finite.mean(), finite.std()], rtol=1e-5)


def test_profile_dir_writes_a_chrome_trace(data_dir, tmp_path):
    """``train.profile_dir`` traces steps 10-15 into a Chrome trace (a run
    shorter than the window closes it at its last step), with the window's
    summary in the run's result."""
    out = tmp_path / "prof"
    result = _train(data_dir, "train.train_iteration=12",
                    f"train.profile_dir={out}")
    assert result["profile_trace"] == str(out / "trace_steps_10-12.json")
    with open(result["profile_trace"]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names), sorted(names)[:20]
    window = result["profile"]   # core/profiling.ProfilerWindow's summary
    assert window["wall_ms"] > 0 and window["kernel_ms"] > 0
    assert window["launches"] == {}   # K1's plain version counts nothing


def test_run_archive_records_the_git_hash(data_dir, tmp_path):
    """``main.git_hash`` in the run's ``hydra_config.yaml``: the checkout's
    short hash here; None outside a checkout."""
    result = _train(data_dir, "train.train_iteration=1",
                    "train.validation_interval=1")
    want = subprocess.check_output(["git", "rev-parse", "--short", "HEAD"],
                                   cwd=REPO).strip().decode()
    assert load_run_config(result["results_dir"]).main.git_hash == want
    assert get_git_hash(str(tmp_path)) is None


# -- the config keys the port checks only (ROADMAP queue 3, F1) ----------------------


@pytest.mark.parametrize("override", [
    "train.mesh.data=4", "train.mesh.data=-1", "train.mesh.model=2",
    "train.mesh.slice=2"])
def test_a_mesh_other_than_one_device_raises(data_dir, override):
    """What a CPU command cannot start raises before any rank does: 4 data
    ranks for a batch of 2 (naming the batch, the ranks and grad_accum),
    ``data=-1`` and a slice or a model axis beside ``data=0`` (every rank
    left: there is no world to count without torchrun or GPUs).
    ``data=2`` trains (tests/test_torch_port_parallel.py), and
    ``data=1 model=2`` (tests/test_torch_port_model_axis.py)."""
    error, match = {
        "train.mesh.data=4": (ValueError, "batch_size=2 .* 4 ranks .*"
                              "grad_accum=1"),
        "train.mesh.data=-1": (ValueError, "every rank left"),
        "train.mesh.model=2": (ValueError, "every rank left"),
        "train.mesh.slice=2": (ValueError, "every rank left")}[override]
    with pytest.raises(error, match=match):
        _train(data_dir, "train.train_iteration=1", override)


@pytest.mark.parametrize("override,match", [
    ("rssm.convt_impl=im2col", "convt_impl"),
    ("rssm.scan_unroll=-1", "scan_unroll")])
def test_bad_lowering_keys_raise(override, match):
    with pytest.raises(ValueError, match=match):
        WorldModel.from_config(compose(overrides=SMALL + [override]))
    jcfg = jax_compose(overrides=SMALL + [override])
    with pytest.raises(ValueError):
        jm = JaxWM.from_config(jcfg)
        rng = np.random.default_rng(0)
        jm.init(jax.random.PRNGKey(0),
                {"image_horizon": rng.normal(size=(2, 1, 64, 64, 3)).astype(
                    np.float32), "sound": rng.normal(
                        size=(2, 1, 128, 20)).astype(np.float32)},
                np.zeros((2, 1, 3), np.float32), None, None, train=False)


def test_the_jax_config_keys_are_in_the_port_config_and_defaults_train(
        data_dir):
    """Every key the JAX package's config tree has is in the port's, at
    the same default for the four the port checks only; the defaults (and
    ``convt_impl=phased``, ``scan_unroll=4``, ``mesh.data=1``) train."""
    def keys(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and v:
                out.update(keys(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    for over in ([], ["rssm=unimodal"]):
        jkeys = keys(jax_compose(overrides=over).to_dict())
        pkeys = keys(compose(overrides=over).to_dict())
        assert set(jkeys) <= set(pkeys), set(jkeys) - set(pkeys)
        for k in jkeys:
            if k.startswith(("train.mesh.", "train.xla_options.",
                             "rssm.convt_impl", "rssm.scan_unroll")):
                assert pkeys[k] == jkeys[k], k
    for extra in ((), ("rssm.convt_impl=phased", "rssm.scan_unroll=4",
                       "train.mesh.data=1")):
        result = _train(data_dir, "train.train_iteration=1",
                        "train.validation_interval=1", *extra)
        assert np.isfinite(result["metrics"]["loss"])


if __name__ == "__main__":   # rewrite the committed fixture
    write_fixture(FIXTURE_DIR)
