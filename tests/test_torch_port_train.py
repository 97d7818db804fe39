"""PyTorch port, training slice: the ELBO, its gradients and one optimizer
step held against the JAX package's ``make_loss_fn`` + ``build_optimizer``
on the same weights and batch; the port's replay, input pipeline, train CLI
and import hygiene.

Tolerances:
- loss and metrics at rtol 1e-4, atol 1e-6 x the value: float32 sums over
  the whole batch, ordered differently by each library;
- gradients at rtol 1e-4, atol 1e-5 x the tensor's largest magnitude: both
  packages' float32 gradients differ from a float64 run of the port by up
  to 4.6e-6 x that magnitude (large reductions over batch and positions);
- parameters after one clipped Adam step at rtol 1e-5, atol 2e-5 (2% of
  one lr step), except where the clipped gradient is within 100 x eps of
  zero: Adam's first step lr * g / (|g| + eps) amplifies the gradients'
  difference there, so those few entries are held to the 2 lr bound;
- the optimizer alone on given gradients at rtol 1e-6 (elementwise math);
- the replay and the quantised input pipeline exactly (integer gathers,
  power-of-two arithmetic).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.ops.image import normalize_image_deterministic as jax_det
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import ConfigDict, compose
from multimodal_rssm_torch.core.device import resolve_device
from multimodal_rssm_torch.data import buffer as port_buffer
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops import cuda_kernels
from multimodal_rssm_torch.ops.image import normalize_image_deterministic
from multimodal_rssm_torch.train import trainer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]
L, B, A = 4, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol_scale, name):
    want = np.asarray(want)
    atol = atol_scale * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=name)


# -- (e) the slice as a whole -----------------------------------------------------


@pytest.fixture(scope="module")
def slice_run():
    """One JAX loss/grad/optimizer step and the port's, on the same weights
    and the same prepared batch (deterministic: key=None / generator=None)."""
    jcfg = jax_compose(overrides=SMALL + ["rssm.remat=false"])
    cfg = compose(overrides=SMALL)
    jm = JaxWorldModel.from_config(jcfg)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (L, B, 64, 64, 3), dtype=np.uint8)
    sound = rng.normal(size=(L, B, 128, 20)).astype(np.float32)
    act = rng.normal(size=(L, B, A)).astype(np.float32)
    rew = rng.normal(size=(L, B)).astype(np.float32)
    nt = np.ones((L, B, 1), np.float32)
    nt[2, 1] = 0.0
    obs = {"image_horizon": np.asarray(jax_det(jnp.asarray(img), 5)),
           "sound": sound}
    jbatch = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(act),
              jnp.asarray(rew), jnp.asarray(nt))
    init = jax.jit(functools.partial(jm.init, train=False))
    variables = _np_tree(init(jax.random.PRNGKey(1),
                              {k: v[1:] for k, v in jbatch[0].items()},
                              jbatch[1][:-1], None, None))
    params, stats = variables["params"], variables["batch_stats"]

    loss_fn = jtr.make_loss_fn(jm, jcfg)
    (jloss, (jstats, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True), static_argnums=(3, 4))(
            params, stats, jbatch, None, True)
    optimizer = jtr.build_optimizer(jcfg)
    updates, _ = optimizer.update(jgrads, optimizer.init(params), params)
    jmetrics = {k: float(v) for k, v in jmetrics.items()}
    jmetrics["grad_norm"] = float(optax.global_norm(jgrads))
    for mod, sub in jgrads.items():
        jmetrics[f"grad_norm_{mod}"] = float(optax.global_norm(sub))

    model = WorldModel.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(params, stats))
    opt, sched = tr.build_optimizer(cfg, model)
    batch = ({"image_horizon": normalize_image_deterministic(_t(img), 5),
              "sound": _t(sound)}, _t(act), _t(rew), _t(nt))
    loss, metrics = tr.make_loss_fn(model, cfg)(batch, None, True)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    metrics.update(tr.apply_gradients(model, opt, sched,
                                      float(cfg.rssm.grad_clip_norm)))
    return {
        "jax": {"loss": float(jloss), "metrics": jmetrics,
                "grads": state_dict_from_jax(_np_tree(jgrads), None),
                "stats": state_dict_from_jax(params, _np_tree(jstats)),
                "params": state_dict_from_jax(
                    _np_tree(optax.apply_updates(params, updates)), None)},
        "port": {"loss": float(loss.detach()), "metrics": {k: float(v) for k, v in
                                                  metrics.items()},
                 "grads": grads, "model": model},
    }


def test_loss_and_metrics_match_jax(slice_run):
    j, p = slice_run["jax"], slice_run["port"]
    assert set(p["metrics"]) == set(j["metrics"])
    _close(p["loss"], j["loss"], 1e-4, 1e-6, "loss")
    for k, v in j["metrics"].items():
        _close(p["metrics"][k], v, 1e-4, 1e-6, k)
    assert j["metrics"]["grad_norm"] > 100.0   # the clip is exercised


def test_gradients_match_jax(slice_run):
    j, p = slice_run["jax"], slice_run["port"]
    assert set(p["grads"]) == set(j["grads"])
    for name, g in p["grads"].items():
        _close(g.numpy(), j["grads"][name].numpy(), 1e-4, 1e-5, name)


def test_running_stats_and_params_after_one_step_match_jax(slice_run):
    """Parameters after the clipped Adam step.  Where the clipped gradient
    is within 100 x eps of zero, lr * g / (|g| + eps) turns a float32
    gradient difference into a step difference of up to 2 lr; there the
    check is that bound, elsewhere rtol 1e-5, atol 2e-5."""
    j, model = slice_run["jax"], slice_run["port"]["model"]
    clip = 100.0 / j["metrics"]["grad_norm"]
    n_steep = n_all = 0
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), j["params"][name].numpy()
        steep = np.abs(j["grads"][name].numpy()) * clip < 100 * 1e-7
        assert np.all(np.abs(got - want)[steep] <= 2e-3 + 1e-7), name
        np.testing.assert_allclose(got[~steep], want[~steep], rtol=1e-5,
                                   atol=2e-5, err_msg=name)
        if np.any(j["grads"][name].numpy()):
            n_steep += int(steep.sum())
            n_all += steep.size
    assert n_steep < 0.01 * n_all   # 0.45% at these weights
    for name, v in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            _close(v.numpy(), j["stats"][name].numpy(), 1e-4, 1e-6, name)


@pytest.mark.parametrize("schedule", [0, 3])
def test_optimizer_matches_optax(schedule):
    """Clip-by-global-norm (optax's rule) + Adam + the linear warm-up, over
    four steps of given gradients, two of them above the clip norm."""
    cfg = ConfigDict({"rssm": {"model_learning_rate": 1e-3,
                               "learning_rate_schedule": schedule,
                               "adam_epsilon": 1e-7, "grad_clip_norm": 10.0}})
    rng = np.random.default_rng(7)
    w0 = {"a": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    module = torch.nn.Module()
    for k, v in w0.items():
        module.register_parameter(k, torch.nn.Parameter(_t(v)))
    opt, sched = tr.build_optimizer(cfg, module)
    optimizer = jtr.build_optimizer(cfg)
    jparams = {k: jnp.asarray(v) for k, v in w0.items()}
    jstate = optimizer.init(jparams)
    for step, scale in enumerate((30.0, 0.5, 20.0, 1.0)):
        g = {k: (rng.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in w0.items()}
        updates, jstate = optimizer.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.named_parameters():
            p.grad = _t(g[k])
        norm = tr.global_norm([p.grad for p in module.parameters()])
        tr.clip_by_global_norm_([p.grad for p in module.parameters()], norm,
                                10.0)
        opt.step()
        if sched is not None:
            sched.step()
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {k}")


# -- input pipeline and replay -------------------------------------------------------


def test_kernel_normalize_switch():
    mk = lambda v: ConfigDict({"train": {"pallas_normalize": v}})
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tr.kernel_normalize_enabled(mk(True), cpu) is True
    assert tr.kernel_normalize_enabled(mk(False), cuda) is False
    assert tr.kernel_normalize_enabled(mk("auto"), cuda) is True
    assert tr.kernel_normalize_enabled(mk("auto"), cpu) is False
    with pytest.raises(ValueError):
        tr.kernel_normalize_enabled(mk("sometimes"), cpu)


@pytest.mark.parametrize("kernel", [True, False])
def test_prepare_observations_quantised_part_matches_jax(kernel, monkeypatch):
    """Both normalise routes give the JAX package's quantised image plus
    noise in [0, 1/32), the kernel route through the kernel's wrapper;
    non-image modalities pass through as float32."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (L, B, 64, 64, 3), dtype=np.uint8)
    sound = rng.normal(size=(L, B, 128, 20)).astype(np.float32)
    spec = tr.AugSpec(modalities=(("image_horizon", tr.ModalityAugSpec(
        out_size=(64, 64), needs_crop=False, noise=False, pca=False,
        normalize=True)),))
    calls = []
    wrapper = cuda_kernels.normalize_image
    monkeypatch.setattr(cuda_kernels, "normalize_image",
                        lambda *a: calls.append(a) or wrapper(*a))
    out = tr.prepare_observations(
        {"image_horizon": _t(img), "sound": _t(sound)}, spec,
        {"image_horizon": {}}, 5, torch.Generator().manual_seed(0), kernel)
    assert len(calls) == int(kernel)
    noise = out["image_horizon"].numpy() - np.asarray(jax_det(jnp.asarray(img), 5))
    assert noise.min() >= 0.0 and noise.max() < 1 / 32
    np.testing.assert_array_equal(out["sound"].numpy(), sound)


def test_replay_sampling_matches_jax(tmp_path):
    """Same dataset, same seed: the port's numpy replay returns the JAX
    package's chunks exactly."""
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(tmp_path), 3, 30, shapes)
    over = ["train.experience_size=200"]
    jD = jax_buffer.build_buffer(jax_compose(overrides=over), seed=3)
    jD.load_dataset(str(tmp_path))
    pD = port_buffer.build_buffer(compose(overrides=over), seed=3)
    port_buffer.load_dataset(str(tmp_path), pD, ".")
    for _ in range(2):
        want, got = jD.sample(4, 6), pD.sample(4, 6)
        for k in want[0]:
            np.testing.assert_array_equal(got[0][k], want[0][k])
        for w, g in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(g, w)
    moved = port_buffer.to_device(got, torch.device("cpu"))
    assert moved[0]["image_horizon"].dtype == torch.uint8


def test_crop_and_pca_augmentation_match_jax(tmp_path):
    """With the crop margin and the PCA colour shift on: the same stored
    shape, PCA fit, augmentation spec and host draws as the JAX package,
    and the same cropped, shifted and clipped images (normalise off, so the
    comparison is exact: slicing and one float32 add and clip)."""
    # episodes larger than the stored 68 x 68 (64 plus the crop margin)
    shapes = {"image_horizon": [3, 72, 72], "sound": [128, 20]}
    write_synthetic_dataset(str(tmp_path), 3, 30, shapes)
    over = ["train.experience_size=200", "train.augmentation.n_crop=9",
            "train.augmentation.dh_base=2", "train.augmentation.dw_base=2",
            "train.augmentation.pca_scales=[0.5]"]
    jD = jax_buffer.build_buffer(jax_compose(overrides=over), seed=4)
    jD.load_dataset(str(tmp_path))
    pD = port_buffer.build_buffer(compose(overrides=over), seed=4)
    port_buffer.load_dataset(str(tmp_path), pD, ".")
    assert pD.observations["image_horizon"].shape[1:] == (68, 68, 3)
    assert pD.idx == jD.idx == 90
    np.testing.assert_array_equal(pD.observations["image_horizon"][:90],
                                  jD.observations["image_horizon"][:90])
    np.testing.assert_allclose(pD.p_eigen_vectors["image_horizon"],
                               jD.p_eigen_vectors["image_horizon"], rtol=1e-6)
    jspec, spec = jtr.build_aug_spec(jD), tr.build_aug_spec(pD)
    assert tuple(spec) == tuple(jspec)
    (name, mspec), = spec.modalities
    assert mspec.needs_crop and mspec.pca and not mspec.noise
    spec = tr.AugSpec(((name, mspec._replace(normalize=False)),))
    jspec = jtr.AugSpec(((name, jspec.modalities[0][1]._replace(
        normalize=False)),))
    jdraws = jtr.HostAugmentDraws(jD, jspec, seed=5)
    pdraws = tr.HostAugmentDraws(pD, spec, seed=5)
    for _ in range(3):
        jd, pd = jdraws.draw(), pdraws.draw()
        for k in jd[name]:
            np.testing.assert_array_equal(pd[name][k], jd[name][k])
        raw = jD.sample(2, 3)[0]
        want = jtr.prepare_observations(
            {k: jnp.asarray(v) for k, v in raw.items()}, jspec,
            {name: {k: jnp.asarray(v) for k, v in jd[name].items()}}, 5,
            jax.random.PRNGKey(0))
        got = tr.prepare_observations({k: _t(v) for k, v in raw.items()},
                                      spec, pd, 5, torch.Generator())
        assert got[name].shape == (3, 2, 64, 64, 3)
        for k in raw:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# -- (f) the train CLI ----------------------------------------------------------------


def test_train_cli_runs_on_cpu_with_plain_normalise(tmp_path, monkeypatch):
    """Three steps through the port's entry point with the kernel switch
    on: on the CPU the wrapper takes the plain version (counted by a spy)
    and launches nothing; every logged loss is finite."""
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(tmp_path / "train"), 2, 30, shapes)
    write_synthetic_dataset(str(tmp_path / "val"), 1, 30, shapes, seed=9)
    calls = []
    plain = cuda_kernels.normalize_image_plain

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(cuda_kernels, "normalize_image_plain", spy)
    cuda_kernels.reset_launch_counts()
    result = cli_train.main(SMALL + [
        f"train.train_data_path=[{tmp_path}/train]",
        f"train.validation_data_path=[{tmp_path}/val]",
        "train.batch_size=2", "train.chunk_size=4", "train.train_iteration=3",
        "train.validation_interval=3", "train.experience_size=200",
        "train.pallas_normalize=true", "--device", "cpu",
        "--cwd", str(tmp_path)])
    assert len(calls) == 4 and calls[0] == (4, 2, 64, 64, 3)
    assert cuda_kernels.launch_counts() == dict.fromkeys(
        cuda_kernels.KERNELS, 0)
    assert np.isfinite(list(result["metrics"].values())).all()
    assert np.isfinite(list(result["validation_metrics"].values())).all()
    with open(os.path.join(result["results_dir"], "metrics.jsonl")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 3 + 1 + 1   # train steps, validation, perf


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(SMALL)
    assert resolve_device("cpu") == torch.device("cpu")


# -- (g) import hygiene -----------------------------------------------------------------


# the training run's feed and persistence, and the native gather's source
FEED_MODULES = [f"multimodal_rssm_torch.{m}" for m in (
    "core.runtime", "data.native", "data.device_buffer", "train.prefetch",
    "io.checkpoint", "train.loop", "cli.train")]
# offline evaluation and its entry points
EVAL_MODULES = [f"multimodal_rssm_torch.{m}" for m in (
    "eval.state_estimation", "eval.imagination", "eval.metrics",
    "eval.streaming", "eval.visualize", "cli.estimate_state",
    "cli.check_model")]


# the model variants' own modules
VARIANT_MODULES = [f"multimodal_rssm_torch.{m}" for m in (
    "ops.categorical", "losses.overshoot")]
# the codecs, norms and training options
CODEC_MODULES = [f"multimodal_rssm_torch.{m}" for m in (
    "models.layers", "models.remat", "models.encoders", "models.decoders",
    "io.jax_weights")]


# control: the policy heads, behavior learning, the planner, the agents,
# the online loop, the environments and their entry points
CONTROL_MODULES = [f"multimodal_rssm_torch.{m}" for m in (
    "ops.returns", "models.policy", "train.behavior", "train.agent",
    "train.planner", "train.online", "eval.policy", "envs", "envs.synthetic",
    "envs.peg", "envs.zoo", "cli.train_behavior", "cli.train_online",
    "cli.eval_policy")]
# the file bridges: the dataset tools, the .msgpack reader, the .pth export
BRIDGE_MODULES = [f"multimodal_rssm_torch.{m}" for m in (
    "data.pose", "data.dataset_builder", "cli.make_synthetic_dataset",
    "cli.collect_sim_data", "io.flax_msgpack", "io.torch_export",
    "io.metrics", "cli.export_torch", "cli.crosscheck_torch")]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor, at import, scikit-learn, PIL, matplotlib or msgpack, which the
    card's machine lacks (the eval CLIs import PIL and matplotlib only
    where they write images, and skip those without them; the dataset
    builder and the .msgpack reader need neither PIL nor msgpack)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimodal_rssm_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'sklearn', 'PIL', "
        "'matplotlib', 'msgpack') or m.startswith(('jax.', 'jaxlib', "
        "'flax', 'optax', 'msgpack.', 'PIL.', 'multimodal_rssm_tpu'))]\n"
        f"missing = [m for m in "
        f"{FEED_MODULES + EVAL_MODULES + VARIANT_MODULES + CODEC_MODULES + CONTROL_MODULES + BRIDGE_MODULES!r} "
        "if m not in sys.modules]\n"
        "print(len(sys.modules), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "multimodal_rssm_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh", ".cpp", ".yaml"))]
    for path in files:
        with open(path) as f:
            text = f.read()
        assert "multimodal_rssm_tpu" not in text, path
        assert "import jax" not in text and "from jax" not in text, path
    assert os.path.join(REPO, "multimodal_rssm_torch", "csrc",
                        "gather.cpp") in files
