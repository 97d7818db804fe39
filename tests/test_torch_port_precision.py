"""PyTorch port, mixed precision: ``train.use_amp=true`` held against the
JAX package, which turns it into an explicit dtype per module
(``WorldModel.from_config(cfg, dtype)``, each Dense / Conv / norm casting
with ``astype(self.dtype)``).  The port does the same with each layer's
``compute_dtype`` (``models/layers.py``), no autocast.

1. Each entry point builds and runs its world model in the JAX package's
   dtype: bf16 under ``use_amp`` where the JAX entry point passes
   ``dtype=tr.compute_dtype(cfg)``, float32 where it builds
   ``from_config(cfg)`` (``ENTRY_POINTS``; the JAX lines are read from
   its source, the port's entry points run on a tiny ``use_amp`` run and
   record every GRU step's dtype and every world model they build).
2. The layer dtype map of one train-mode forward is the JAX package's,
   name for name: for every module that owns parameters, the dtypes of its
   outputs, and the dtype of every leaf of ``train_forward``'s outputs;
   every gradient is float32.  The JAX map is read while
   ``jax.eval_shape`` traces the forward, by ``flax.linen.intercept_methods``
   (``capture_intermediates`` drops what the ``nn.scan``'d RSSM cell
   records: flax carries out of a scan only the collections it names), and
   keyed by the port's module names through the weight bridge
   (``state_dict_from_jax`` of a tree whose leaves hold their own index:
   each port tensor names the JAX modules whose weights it holds, so the
   MXU reformulations and the split Dense layers are compared at the
   port's layer that holds their weight).  The maps are made at
   ``MAP_WIDTHS``, narrow but with full width's modules (an image
   embedding of 1024, so no image ``fc``), for ``MAP_CONFIGS``; the JAX
   ones are committed in ``torch_port_fixtures/dtype_map.json`` for the
   card, which has no JAX (``chip_smoke.py`` phase ``precision``), and a
   test regenerates them and fails if the file differs.  Rewrite it with
   ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_precision.py``.
3. The bf16 step against the JAX package's bf16 step on the same weights
   and batch (``SMALL`` widths, L 6 x B 4, the deterministic path), for
   the default and the categorical config.  bf16 moves every quantity
   away from float32 in both packages by rounding that neither can match
   bit for bit, so the port is held to the JAX package's bf16 effect.
   Per quantity (the loss, every metric, every gradient), |.| the largest
   absolute difference over the tensor, f32 the JAX package's float32
   step, floor 1e-6 of the f32 tensor's largest magnitude:

       |port_bf16 - jax_bf16| <= C[config] * max(|jax_bf16 - f32|, floor)

   and ``effect_share``, the geometric mean over those quantities of the
   port's bf16 effect |port_bf16 - f32| over the JAX package's, lies in
   ``EFFECT_SHARE[config]``: about 1 when both round alike, near 0 for a
   port that computes in float32.  Readings of seeds 0-5
   (``--ratios``):

       default      ratio 5.29 / 5.75 / 2.25 / 30.82 / 4.01 / 6.06
                    share 0.969 / 0.761 / 0.911 / 0.871 / 0.884 / 0.870
       categorical  ratio 9.03 / 2.10 / 3.04 / 1.60 / 1.70 / 11.19
                    share 1.418 / 0.451 / 0.764 / 0.943 / 0.951 / 0.820

   C is 1.25 times the largest ratio, rounded up, and the share's limits
   are half the smallest reading and twice the largest, rounded down to
   two decimals; a limit is never widened (the default's lower 0.39 and
   the categorical upper 2.8 stay from the readings before the norms and
   the GLU rounded as the JAX program does).  The largest ratios are
   scalar sums (the gradient norms, the losses), whose bf16 effect in the
   JAX package can be small by cancellation, so they jump from seed to
   seed (default seed 3's 30.82 is ``grad_norm_core``; seed 6, outside
   the six, reads 22.12).  The categorical latent is the argmax of its
   logits, and bf16 flips some of them in either package, not the same
   ones (one-hot entries moved by bf16, seeds 0-2, of 320: the port's
   posterior 2 / 0 / 0 and prior 0 / 4 / 2, the JAX package's 0 / 2 / 0
   and 0 / 0 / 2); a flip moves what follows it far more than rounding
   does.

   The reference step is the JAX package's with its bf16 sums accumulated
   in float32 (``float32_sums``).  XLA's CPU backend reduces a bf16 tensor
   over several axes in bf16: a bias's cotangent summed over batch and
   space stalls once the sum outgrows the addends (an isolated flax
   ``ConvTranspose`` bias cotangent of 821.8 sums to 64.0; the image
   decoder's last bias gradient, 792 in float32, moved by 550).  The
   port's sums accumulate in float32 on the CPU and on CUDA, and rounding
   once is what the JAX package's program asks of a sum (a deliberate
   difference, ROADMAP.md).  Otherwise XLA rounds a bf16 program after
   every op, an elementwise chain too, and skips only the rounding of an
   op whose result the program converts straight to float32
   (``--hlo`` prints the compiled backward of the JAX InstanceNorm + GLU:
   a ``convert`` to bf16 after each op).  The port's norms and GLU round
   where that program does (``models/layers.py``; 4. below); its other
   ops round as PyTorch's do (the GRU's gates, a conv's or a matmul's
   order of accumulation), so the two steps still part by rounding.
   How bf16 scales each sound encoder conv weight's gradient norm against
   float32 (``sound_encoder_norms``) moves from seed to seed in either
   package (the JAX package's 0.944-1.036 over default seeds 0-17); the
   port's lies within 0.028 of the JAX package's at every one of those
   seeds (0.060 before its norms and GLU rounded as the JAX program does:
   default seed 0 read 0.940-0.944 against 0.997-1.001), and the test
   holds ``SCALE_GAP``, 1.25 times that.
   The clipped Adam step is float32 in both packages: fed the JAX
   package's bf16 gradients, the port's step leaves every parameter where
   the JAX package's update puts it, to ``ADAM_RTOL`` / ``ADAM_ATOL``.
   The layer maps (2.) hold each layer's dtype exactly; these readings
   hold how far bf16 takes the step.  The tests run seeds 0 and 1 of each
   config.
4. A norm's bf16 forward and backward against the JAX package's on the
   same bf16 inputs (``test_norm_bf16_backward_matches_jax``): an
   InstanceNorm over [24, 32, 4] with per-instance offsets 20 times its
   spread and without, a BatchNorm, and the sound encoder's last norm as
   the port's bf16 step feeds it.  The JAX program takes the mean and
   E[x^2] from two float32 conversions of ``x``, so the mean's and the
   variance's cotangents reach ``x`` each rounded to bf16, summed to the
   direct ``dy * a`` in bf16; it sums the coefficients' cotangents
   ``dy * x`` unrounded in float32 and rounds the sum once; and its
   sigmoid rounds after each op.  The port used to sum the two paths in
   float32 and round once, round each product, and round its sigmoid
   once: 0.15 / 0.49 / 0.63 / 0.50 of dx bit-equal in the four cases.
   Neither rounding is the more accurate: against float64 on the same
   inputs the JAX package's dx strays 0.162 / 0.0057 / 0.0036 / 0.0071
   and the port's old one 0.195 / 0.0055 / 0.0029 / 0.0053 (offsets far
   from zero cancel in either).  Now at least
   ``NORM_BIT_SHARE`` of y and dx are bit-equal to the JAX package's, and
   followed by a GLU the port's dx strays from float32 as far as the JAX
   package's does (``NORM_ERROR_RATIO``).
"""

import contextlib
import functools
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax._src.interpreters import mlir
from jax._src.lax import lax as lax_internal

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models import dtype_map as dm
from multimodal_rssm_torch.models import layers
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.train import trainer as tr
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "torch_port_fixtures",
                       "dtype_map.json")
NARROW = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
          "rssm.embedding_size.sound=32", "rssm.embedding_size.fusion=64",
          "rssm.embedding_size.other=16"]
SMALL = NARROW + ["rssm.embedding_size.image=64"]
MAP_WIDTHS = NARROW + ["rssm.embedding_size.image=1024"]
MAP_CONFIGS = {"default": [], "categorical": ["rssm.latent_dist=categorical"],
               "groupnorm64": ["rssm.normalization=GroupNorm"]}
STEP_CONFIGS = {"default": [],
                "categorical": ["rssm.latent_dist=categorical",
                                "rssm.categorical_params.variables=4",
                                "rssm.categorical_params.classes=4"]}
C = {"default": 39.0, "categorical": 14.0}
FLOOR = 1e-6
EFFECT_SHARE = {"default": (0.39, 1.93), "categorical": (0.22, 2.8)}
# the sound encoder's bf16 gradient scale, port against JAX: 1.25 times
# the largest gap over default seeds 0-17 (0.028, the docstring's 3.)
SCALE_GAP = 0.035
# a norm's bf16 backward against the JAX package's program on the same
# inputs (test_norm_bf16_backward_matches_jax)
NORM_BIT_SHARE, NORM_PARAM_RTOL, NORM_ERROR_RATIO = 0.99, 1e-5, 1.25
# the parameters after the step: lr 1e-3, and optax's Adam divides by its
# bias correction 1 - 0.999 in float32 (1.3e-5 off; torch's in float64),
# so its first update differs from torch's by up to 6.4e-6 of lr
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-8
L, B, A = 6, 4, 3
BF16, F32 = "bfloat16", "float32"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, length, batch, image=64):
    """Prepared inputs made from ``seed`` with NumPy: frames in
    [-0.5, 0.5), sound, actions, rewards, one terminal."""
    rng = np.random.default_rng(seed)
    obs = {"image_horizon": rng.uniform(-0.5, 0.5, (
        length, batch, image, image, 3)).astype(np.float32),
        "sound": rng.normal(size=(length, batch, 128, 20)).astype(np.float32)}
    act = rng.normal(size=(length, batch, A)).astype(np.float32)
    rew = rng.normal(size=(length, batch)).astype(np.float32)
    nt = np.ones((length, batch, 1), np.float32)
    nt[length // 2, batch - 1] = 0.0
    return obs, act, rew, nt


def _jax_batch(arrays):
    obs, act, rew, nt = arrays
    return ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(act),
            jnp.asarray(rew), jnp.asarray(nt))


def _port_batch(arrays):
    obs, act, rew, nt = arrays
    return ({k: _t(v) for k, v in obs.items()}, _t(act), _t(rew), _t(nt))


# -- 1. the entry points ----------------------------------------------------

# JAX entry point (file under multimodal_rssm_tpu/) -> its world model's
# dtype under use_amp, and the port's entry point that mirrors it
ENTRY_POINTS = {
    "train": ("train/loop.py", BF16),
    "train_online": ("train/online.py", BF16),
    "eval_policy": ("cli/eval_policy.py", BF16),
    "train_behavior": ("cli/train_behavior.py", BF16),
    "export_model": ("cli/export_model.py", F32),
    "check_model": ("cli/check_model.py", F32),
    "export_torch": ("cli/export_torch.py", F32),
    "crosscheck_torch": ("cli/crosscheck_torch.py", F32),
    "estimate_state": ("eval/state_estimation.py", F32),
}


def _jax_entry_dtype(path):
    """The dtype the JAX entry point's ``WorldModel.from_config`` line
    gives its world model under ``use_amp``."""
    with open(os.path.join(REPO, "multimodal_rssm_tpu", path)) as f:
        (line,) = [x for x in f if "WorldModel.from_config(" in x]
    if "dtype=tr.compute_dtype(cfg)" in line:
        return BF16
    assert line.strip().endswith("WorldModel.from_config(cfg)"), line
    return F32


class _Seen:
    """The dtypes the port computed in while a block ran: each world model
    built (``from_config``) and each GRU step."""

    def __init__(self, monkeypatch):
        self.built, self.gru = [], []
        build, step = WorldModel.from_config, layers.GRUCell.forward

        def from_config(cfg, dtype=torch.float32):
            model = build(cfg, dtype)
            self.built.append(dm.dtype_name(torch.empty(0, dtype=dtype)))
            return model

        def forward(cell, x, h):
            out = step(cell, x, h)
            self.gru.append(dm.dtype_name(out))
            return out

        monkeypatch.setattr(WorldModel, "from_config",
                            staticmethod(from_config))
        monkeypatch.setattr(layers.GRUCell, "forward", forward)

    def clear(self):
        self.built.clear()
        self.gru.clear()


TINY_RUN = SMALL + ["train.use_amp=true", "train.batch_size=2",
                    "train.chunk_size=4", "train.experience_size=200",
                    "rssm.predict_reward=true"]


@pytest.fixture(scope="module")
def amp_run(tmp_path_factory):
    """A tiny ``use_amp`` run through the port's CLIs (2 world-model steps
    with a checkpoint, 1 behavior iteration), each entry point's dtypes
    recorded as it ran."""
    from multimodal_rssm_torch.cli import (
        check_model, crosscheck_torch, estimate_state, eval_policy,
        export_model, export_torch, train, train_behavior, train_online)
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

    root = str(tmp_path_factory.mktemp("amp_run"))
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(os.path.join(root, "train"), 2, 30, shapes)
    write_synthetic_dataset(os.path.join(root, "val"), 1, 30, shapes, seed=9)
    mp = pytest.MonkeyPatch()
    seen, out = _Seen(mp), {}

    def record(name, fn, *args, catch=()):
        seen.clear()
        try:
            result = fn(*args)
        except catch:
            result = None
        out[name] = (list(seen.built), sorted(set(seen.gru)))
        return result

    try:
        run = record("train", train.main, TINY_RUN + [
            "train.train_iteration=2", "train.validation_interval=2",
            "train.checkpoint_interval=2",
            f"train.train_data_path=[{root}/train]",
            f"train.validation_data_path=[{root}/val]",
            "--device", "cpu", "--cwd", root])["results_dir"]
        record("train_behavior", train_behavior.main, [
            "--run-dir", run, "--cwd", root, "--device", "cpu",
            "behavior.train_iteration=1", "behavior.horizon=3"])
        record("eval_policy", eval_policy.main, [
            "--run-dir", run, "--episodes", "1", "--env-length", "3",
            "--device", "cpu"])
        record("export_model", export_model.main, [
            "--run-dir", run, "--out", os.path.join(root, "exported"),
            "--device", "cpu"])
        record("check_model", check_model.main, [
            "--run", run, "--itr", "2", "--t-start", "2", "--horizon", "3",
            "--cwd", root, "--device", "cpu"])
        record("estimate_state", estimate_state.main, [
            "--targets", os.path.dirname(run), "--itr", "2", "--cwd", root,
            "--device", "cpu"])
        record("export_torch", export_torch.main, ["--run-dir", run])
        # no reference checkout here: the port's half runs, then the
        # reference's import fails
        record("crosscheck_torch", crosscheck_torch.main, [
            "--run-dir", run, "--itr", "2", "--t-start", "2", "--horizon",
            "3", "--cwd", root, "--device", "cpu", "--reference",
            os.path.join(root, "no_reference")],
            catch=SystemExit)
        record("train_online", train_online.main, TINY_RUN + [
            "online.seed_episodes=2", "online.episodes=1",
            "online.collect_interval=1", "behavior.horizon=3",
            "train.chunk_size=4", "--env", "synthetic", "--env-length", "8",
            "--device", "cpu", "--cwd", os.path.join(root, "online")])
    finally:
        mp.undo()
    return {"run": run, "root": root, "seen": out}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_computes_in_the_jax_dtype(amp_run, entry):
    """Under ``train.use_amp=true`` each of the port's entry points builds
    its world model in the dtype the JAX package's counterpart gives its
    own, and (but ``export_torch``, which only converts weights) runs its
    RSSM in it."""
    path, want = ENTRY_POINTS[entry]
    assert _jax_entry_dtype(path) == want
    built, gru = amp_run["seen"][entry]
    assert built and set(built) == {want}, built
    if entry != "export_torch":
        assert gru == [want], gru


def test_export_model_of_an_amp_run_says_float32(amp_run):
    """The served artifacts of a ``use_amp`` run compute in float32, as the
    JAX package's ``export_model`` builds its model, and say so."""
    from multimodal_rssm_torch.io import export as ex

    out = os.path.join(amp_run["root"], "exported")
    names = sorted(f for f in os.listdir(out) if f.endswith(".pt2"))
    assert names == ["agent_step.pt2", "decode.pt2", "filter_step.pt2"]
    for name in names:
        _, meta = ex.load_exported(os.path.join(out, name))
        assert meta["compute_dtype"] == F32, name


def test_quality_gate_hands_overrides_to_its_train_run(monkeypatch,
                                                      tmp_path):
    """``cli/quality_gate.py``'s trailing ``key=value`` overrides (how a
    gate cell runs at ``train.use_amp=false``) reach its train run, after
    the config's own."""
    from multimodal_rssm_torch.cli import quality_gate as qg

    class Stop(Exception):
        pass

    cmds = []

    def run(cmd):
        cmds.append(list(cmd))
        if "multimodal_rssm_torch.cli.train" in cmd:
            raise Stop

    monkeypatch.setattr(qg, "run", run)
    args = qg.parse_args(["--config", "categorical", "--seed", "2",
                          "--workdir", str(tmp_path), "train.use_amp=false"])
    assert args.overrides == ["train.use_amp=false"]
    with pytest.raises(Stop):
        qg.train_and_eval(args)
    train = cmds[-1]
    tail = train[train.index("main.experiment_name=qgate") + 1:]
    assert tail == ["rssm.latent_dist=categorical", "train.use_amp=false",
                    "--cwd", os.path.join(str(tmp_path),
                                          "qgate_run_categorical_seed2"),
                    "--device", "cuda"]


# -- 2. the layer dtype maps -----------------------------------------------


def _bridge_names(param_shapes):
    """{JAX module path: the port's module name} through
    ``state_dict_from_jax``: every leaf filled with its own index."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(param_shapes)
    owner, ids = {}, []
    for i, (path, leaf) in enumerate(leaves, start=1):
        owner[i] = tuple(k.key for k in path[:-1])
        ids.append(np.full(leaf.shape, i, np.float32))
    names = {}
    sd = state_dict_from_jax(jax.tree_util.tree_unflatten(treedef, ids))
    for key, t in sd.items():
        for i in np.unique(t.numpy()):
            path = owner[int(i)]
            assert names.setdefault(path, key.rsplit(".", 1)[0]) == \
                key.rsplit(".", 1)[0], path
    return names


def _jax_flat(tree):
    return {".".join(str(k.key) for k in path): str(np.dtype(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_dtype_map(overrides, amp=True):
    """The JAX package's dtype map of one train-mode forward at
    ``MAP_WIDTHS`` (``as_dict`` form, port names), and its gradients'
    dtypes; traced by ``jax.eval_shape``, nothing computed."""
    jcfg = jax_compose(overrides=MAP_WIDTHS + overrides + [
        f"train.use_amp={amp}", "rssm.remat=false"])
    jm = JaxWorldModel.from_config(jcfg, dtype=jtr.compute_dtype(jcfg))
    obs, act, rew, nt = _jax_batch(_batch(0, 3, 2))
    target = {k: v[1:] for k, v in obs.items()}
    shapes = jax.eval_shape(lambda k: jm.init(
        k, target, act[:-1], None, None, train=False), jax.random.PRNGKey(0))
    seen = {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        module = context.module
        if context.method_name == "__call__" and any(
                not isinstance(v, dict) for v in
                module.variables.get("params", {}).values()):
            seen.setdefault(module.path, set()).add(str(np.dtype(out.dtype)))
        return out

    def forward(variables):
        with fnn.intercept_methods(intercept):
            out, _ = jm.apply(variables, target, act[:-1], nt[:-1], None,
                              False, method=JaxWorldModel.train_forward,
                              mutable=["batch_stats"])
        return out

    outputs = jax.eval_shape(forward, shapes)
    names = _bridge_names(shapes["params"])
    layers_ = {}
    for path, dtypes in seen.items():
        layers_.setdefault(names[path], set()).update(dtypes)
    loss_fn = jtr.make_loss_fn(jm, jcfg)
    grads = jax.eval_shape(jax.grad(lambda p, s: loss_fn(
        p, s, (obs, act, rew, nt), None, True)[0]),
        shapes["params"], shapes["batch_stats"])
    return ({"layers": {k: sorted(v) for k, v in sorted(layers_.items())},
             "outputs": dict(sorted(_jax_flat(dict(zip(
                 dm.OUTPUT_GROUPS, outputs))).items()))},
            set(_jax_flat(grads).values()))


def port_dtype_map(overrides, amp=True):
    """The port's dtype map of one train-mode loss step at
    ``MAP_WIDTHS`` on the CPU, and its gradients' dtypes."""
    cfg = compose(overrides=MAP_WIDTHS + overrides + [f"train.use_amp={amp}"])
    model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
    got, grads, _ = dm.loss_step_map(model, cfg, _port_batch(_batch(0, 3, 2)))
    return got, set(grads)


def fixture_maps():
    return {name: jax_dtype_map(o)[0] for name, o in MAP_CONFIGS.items()}


@pytest.mark.parametrize("amp", [True, False])
@pytest.mark.parametrize("config", sorted(MAP_CONFIGS))
def test_layer_dtype_map_matches_jax(config, amp):
    """Name for name, every parameterised layer's output dtype and every
    forward output's dtype are the JAX package's; every gradient is float32
    in both (``use_amp`` true, and false: float32 throughout)."""
    want, jax_grads = jax_dtype_map(MAP_CONFIGS[config], amp)
    got, port_grads = port_dtype_map(MAP_CONFIGS[config], amp)
    assert dm.mismatches(got, want) == []
    assert jax_grads == port_grads == {F32}
    layer_dtypes = {d for v in got["layers"].values() for d in v}
    assert layer_dtypes == {BF16 if amp else F32}
    assert set(got["outputs"].values()) == {F32}


def test_dtype_map_fixture_is_fresh():
    """The committed JAX maps, which the card holds the port to, are the
    JAX package's as it stands."""
    with open(FIXTURE) as f:
        committed = json.load(f)
    assert committed["widths"] == MAP_WIDTHS
    assert {k: v["overrides"] for k, v in committed["configs"].items()} \
        == MAP_CONFIGS
    assert {k: {"layers": v["layers"], "outputs": v["outputs"]}
            for k, v in committed["configs"].items()} == fixture_maps()


# -- 3. the bf16 step -------------------------------------------------------


@contextlib.contextmanager
def float32_sums():
    """Inside the block, XLA programs lowered from JAX sum a bf16 tensor in
    float32 and round the sum once to bf16 (in place of XLA's CPU
    reduction in bf16); the JAX package's code is untouched."""
    rule = mlir._lowerings[lax_internal.reduce_sum_p]

    def upcast(x, **params):
        return lax_internal.reduce_sum_p.bind(
            x.astype(jnp.float32), **params).astype(x.dtype)

    upcast_rule = mlir.lower_fun(upcast, multiple_results=False)

    def lowering(ctx, x, **params):
        if ctx.avals_in[0].dtype == jnp.bfloat16:
            return upcast_rule(ctx, x, **params)
        return rule.rule(ctx, x, **params)

    mlir._lowerings[lax_internal.reduce_sum_p] = mlir.LoweringRuleEntry(
        lowering, rule.inline)
    try:
        yield
    finally:
        mlir._lowerings[lax_internal.reduce_sum_p] = rule


def xla_bf16_bias_sum():
    """An image decoder's last bias cotangent ([20, 64, 64, 3], made from
    seed 0) summed over batch and space by a bf16 flax ``ConvTranspose``'s
    gradient: (the float32 sum, the bf16 sum as XLA's CPU backend takes
    it, the same inside ``float32_sums``), channel 0."""
    rng = np.random.default_rng(0)
    ct = jnp.asarray(rng.normal(0.01, 0.01, (20, 64, 64, 3)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(20, 32, 32, 8)), jnp.float32)

    def bias_grad(dtype):
        layer = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), dtype=dtype)
        params = layer.init(jax.random.PRNGKey(0), x)
        return float(jax.jit(jax.grad(lambda p: jnp.sum(
            layer.apply(p, x).astype(jnp.float32) * ct)))(
                params)["params"]["bias"][0])

    plain = bias_grad(jnp.bfloat16)
    with float32_sums():
        summed = bias_grad(jnp.bfloat16)
    return bias_grad(jnp.float32), plain, summed


def test_float32_sums_round_a_bf16_sum_once():
    """The reference's bf16 sums: inside ``float32_sums`` a bf16 bias
    cotangent sums to its float32 sum rounded once to bf16."""
    f32, plain, summed = xla_bf16_bias_sum()
    print("float32", f32, "bf16", plain, "float32_sums", summed)
    assert summed == float(jnp.asarray(f32, jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _jax_step_fns(config, amp):
    jcfg = jax_compose(overrides=SMALL + STEP_CONFIGS[config] + [
        f"train.use_amp={amp}", "rssm.remat=false"])
    jm = JaxWorldModel.from_config(jcfg, dtype=jtr.compute_dtype(jcfg))
    grad_fn = jax.jit(jax.value_and_grad(jtr.make_loss_fn(jm, jcfg),
                                         has_aux=True),
                      static_argnums=(3, 4))
    optimizer = jtr.build_optimizer(jcfg)
    update = jax.jit(lambda g, p: optimizer.update(g, optimizer.init(p), p))
    return jcfg, jm, grad_fn, update


def _jax_step(config, amp, variables, batch):
    _, _, grad_fn, update = _jax_step_fns(config, amp)
    params, stats = variables["params"], variables["batch_stats"]
    (loss, (_, metrics)), grads = grad_fn(params, stats, batch, None, True)
    updates, _ = update(grads, params)
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["grad_norm"] = float(optax.global_norm(grads))
    for mod, sub in grads.items():
        metrics[f"grad_norm_{mod}"] = float(optax.global_norm(sub))
    metrics["loss"] = float(loss)
    return {"metrics": metrics,
            "grads": state_dict_from_jax(_np_tree(grads)),
            "change": state_dict_from_jax(_np_tree(updates))}


def _port_model(config, amp, variables):
    cfg = compose(overrides=SMALL + STEP_CONFIGS[config] + [
        f"train.use_amp={amp}"])
    model = WorldModel.from_config(cfg, tr.compute_dtype(cfg))
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    return cfg, model


def _port_step(config, amp, variables, batch):
    cfg, model = _port_model(config, amp, variables)
    loss, metrics = tr.make_loss_fn(model, cfg)(batch, None, True)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    metrics.update(tr.apply_gradients(model, *tr.build_optimizer(cfg, model),
                                      float(cfg.rssm.grad_clip_norm)))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads}


def _port_adam_step(config, variables, grads):
    """Every parameter after the port's clipped Adam step from ``grads``
    (port names)."""
    cfg, model = _port_model(config, True, variables)
    for n, p in model.named_parameters():
        p.grad = torch.as_tensor(np.asarray(grads[n])).clone()
    tr.apply_gradients(model, *tr.build_optimizer(cfg, model),
                       float(cfg.rssm.grad_clip_norm))
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _init(config, seed):
    _, jm, _, _ = _jax_step_fns(config, False)
    arrays = _batch(seed, L, B)
    jbatch = _jax_batch(arrays)
    variables = _np_tree(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.PRNGKey(seed), {k: v[1:] for k, v in jbatch[0].items()},
        jbatch[1][:-1], None, None))
    return variables, jbatch, _port_batch(arrays)


@functools.lru_cache(maxsize=None)
def bf16_steps(config, seed):
    """(the JAX package's float32 step, its bf16 step, the port's bf16
    step), the JAX steps' bf16 sums in float32; and the weights (cached:
    callers read them)."""
    variables, jbatch, pbatch = _init(config, seed)
    with float32_sums():
        f32 = _jax_step(config, False, variables, jbatch)
        jbf = _jax_step(config, True, variables, jbatch)
    return (f32, jbf, _port_step(config, True, variables, pbatch)), variables


def readings(steps):
    """{quantity: (|port_bf16 - jax_bf16|, |jax_bf16 - f32|,
    |port_bf16 - f32|, floor)} over the loss, the metrics and the
    gradients, |.| the largest absolute difference over the tensor."""
    f32, jbf, pbf = steps
    out = {}
    for part in ("metrics", "grads"):
        assert set(pbf[part]) == set(jbf[part]) == set(f32[part]), part
        for name, ref in f32[part].items():
            ref = np.asarray(ref, np.float64)
            j, p = (np.asarray(x[part][name], np.float64) for x in (jbf, pbf))
            out[f"{part} {name}"] = tuple(float(np.max(np.abs(x), initial=0))
                                          for x in (p - j, j - ref, p - ref,
                                                    FLOOR * ref))
    return out


def gap_ratio(gap, effect_j, effect_p, floor):
    """|port_bf16 - jax_bf16| / max(|jax_bf16 - f32|, floor)."""
    return gap / max(effect_j, floor) if gap else 0.0


def effect_share(readings_):
    """The geometric mean of the port's bf16 effect over the JAX package's
    (each floored): about 1 when both round alike, 0 for a port that
    ignores bf16."""
    logs = [math.log(max(ep, fl) / max(ej, fl))
            for _, ej, ep, fl in readings_.values() if max(ej, ep, fl) > 0]
    return math.exp(sum(logs) / len(logs))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("config", sorted(STEP_CONFIGS))
def test_bf16_step_within_c_of_jax(config, seed):
    """The port's bf16 loss, metrics and gradients lie within ``C`` of the
    JAX package's bf16 effect, the port's bf16 effect is the JAX
    package's in size (``EFFECT_SHARE``), and its clipped Adam step from
    the JAX package's bf16 gradients is the JAX package's."""
    steps, variables = bf16_steps(config, seed)
    got = readings(steps)
    ratios = {k: gap_ratio(*v) for k, v in got.items()}
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
    share = effect_share(got)
    print(config, seed, worst, f"effect share {share:.3f}")
    assert max(ratios.values()) <= C[config], worst
    assert EFFECT_SHARE[config][0] <= share <= EFFECT_SHARE[config][1], share
    _, jbf, _ = steps
    stepped = _port_adam_step(config, variables, jbf["grads"])
    before = state_dict_from_jax(variables["params"])
    for name, update in jbf["change"].items():
        want = before[name].numpy() + np.asarray(update, np.float32)
        np.testing.assert_allclose(stepped[name], want, rtol=ADAM_RTOL,
                                   atol=ADAM_ATOL, err_msg=name)


def one_hot_flips(config, seed):
    """One-hot entries of the posterior and prior states that bf16 moves by
    more than 0.5 from the JAX package's float32 forward: {package:
    (posterior, prior)}, and the entries' count."""
    variables, (obs, act, _, nt), pbatch = _init(config, seed)
    target = {k: v[1:] for k, v in obs.items()}
    states = {}
    for amp in (False, True):
        _, jm, _, _ = _jax_step_fns(config, amp)
        (st, _, _), _ = jm.apply(variables, target, act[:-1], nt[:-1], None,
                                 False, train=True,
                                 method=JaxWorldModel.train_forward,
                                 mutable=["batch_stats"])
        states[amp] = st
    _, model = _port_model(config, True, variables)
    with torch.no_grad():
        pst, _, _ = model.train_forward(
            {k: v[1:] for k, v in pbatch[0].items()}, pbatch[1][:-1],
            pbatch[3][:-1])
    keys = ("posterior_states", "prior_states")
    f32 = {k: np.asarray(states[False][k]) for k in keys}
    count = {"jax": tuple(int((np.abs(np.asarray(states[True][k]) - f32[k])
                               > 0.5).sum()) for k in keys),
             "port": tuple(int((np.abs(pst[k].float().numpy() - f32[k])
                                > 0.5).sum()) for k in keys)}
    return count, f32[keys[0]].size


def weight_norms(steps, prefix):
    """{conv weight under ``prefix``: (|jax_bf16| / |f32|, |port_bf16| /
    |f32|)}, |.| the gradient's L2 norm: how bf16 scales each package's
    gradient."""
    f32, jbf, pbf = steps
    out = {}
    for name, ref in f32["grads"].items():
        if (name.startswith(prefix) and name.endswith(".weight")
                and np.ndim(ref) >= 3):
            ref = np.linalg.norm(np.asarray(ref, np.float64))
            out[name] = tuple(float(np.linalg.norm(np.asarray(
                x["grads"][name], np.float64)) / ref) for x in (jbf, pbf))
    return out


def sound_encoder_norms(steps):
    """``weight_norms`` of the sound encoder's five convs."""
    return weight_norms(steps, "encoder.sound.")


CODECS = ("encoder.image_horizon.", "encoder.sound.",
          "observation_model.image_horizon.", "observation_model.sound.")



@pytest.mark.parametrize("seed", [0, 1])
def test_sound_encoder_bf16_gradient_scale_matches_jax(seed):
    """bf16 scales each sound encoder conv weight's gradient norm (against
    the JAX package's float32 step) by what it does in the JAX package, to
    ``SCALE_GAP``: the bf16 rounding of the whole step moves either
    package's ratio by up to 0.06 from seed to seed (the docstring's 3.),
    and no norm of the port adds a scale of its own
    (``test_norm_bf16_backward_matches_jax``)."""
    norms = sound_encoder_norms(bf16_steps("default", seed)[0])
    print(seed, {k: (round(j, 4), round(p, 4)) for k, (j, p) in
                 norms.items()})
    assert len(norms) == 5
    for name, (jax_ratio, port_ratio) in norms.items():
        assert abs(port_ratio - jax_ratio) <= SCALE_GAP, name


# -- 4. the norms' bf16 backward --------------------------------------------


@functools.lru_cache(maxsize=None)
def sound_encoder_norm_inputs(seed=0):
    """The input and output cotangent of ``encoder.sound.down_conversion.1``
    (InstanceNorm over 4 positions) in the port's bf16 step (default
    config, ``seed``), and its scale and bias, as float32 tensors."""
    variables, _, pbatch = _init("default", seed)
    cfg, model = _port_model("default", True, variables)
    norm = model.encoder.sound.down_conversion[1]
    seen = {}
    hooks = [norm.register_forward_hook(
                 lambda m, args, out: seen.update(x=args[0].detach())),
             norm.register_full_backward_hook(
                 lambda m, gin, gout: seen.update(dy=gout[0].detach()))]
    loss, _ = tr.make_loss_fn(model, cfg)(pbatch, None, True)
    loss.backward()
    for h in hooks:
        h.remove()
    return (seen["x"].float(), seen["dy"].float(), norm.weight.detach(),
            norm.bias.detach())


def norm_case(case):
    """(kind, x, cotangent of the norm's output, cotangent of the GLU
    after it or None, scale, bias): ``x`` and the cotangents
    bf16-representable float32, channels on axis 1.  "offset": per-instance
    offsets 20 times the spread, as a conv's output can have; "unit": no
    offset; "batchnorm": a BatchNorm over [8, 16, 6, 6] with offset 3;
    "sound_encoder": the sound encoder's last norm in the port's bf16 step
    (``sound_encoder_norm_inputs``)."""
    if case == "sound_encoder":
        x, dy, scale, bias = sound_encoder_norm_inputs()
        return "instance", x, dy, None, scale, bias
    rng = np.random.default_rng(0)
    kind = "batch" if case == "batchnorm" else "instance"
    shape = (8, 16, 6, 6) if kind == "batch" else (24, 32, 4)
    offset = {"offset": 20.0 * rng.normal(size=shape[:2] + (1,)),
              "unit": 0.0, "batchnorm": 3.0}[case]
    bf16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16(
        ).float()
    x = bf16(rng.normal(size=shape) + offset)
    dy = bf16(rng.normal(size=shape))
    glu_dy = bf16(rng.normal(size=(shape[0], shape[1] // 2) + shape[2:]))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, shape[1]).astype(
        np.float32))
    bias = torch.from_numpy(rng.normal(size=shape[1]).astype(np.float32))
    return kind, x, dy, glu_dy, scale, bias


def jax_norm(kind, x, ct, scale, bias, dtype, glu=False):
    """The JAX package's norm (and ``glu`` after it) on port-layout ``x``:
    (y, dx, dscale, dbias) as float32 port-layout tensors, the cotangent
    ``ct`` pulled back through the program jitted with ``float32_sums``."""
    from multimodal_rssm_tpu.models import layers as jl

    perm = (0,) + tuple(range(2, x.ndim)) + (1,)
    norm = (jl.InstanceNorm(track_running_stats=False, dtype=dtype)
            if kind == "instance" else jl.BatchNorm(dtype=dtype))
    variables = {"params": {"scale": jnp.asarray(scale.numpy()),
                            "bias": jnp.asarray(bias.numpy())}}
    if kind == "batch":
        variables["batch_stats"] = {"mean": jnp.zeros(x.shape[1]),
                                    "var": jnp.ones(x.shape[1])}

    def f(params, xx):
        y = norm.apply({**variables, "params": params}, xx,
                       mutable=["batch_stats"])[0]
        return jl.glu(y, axis=-1) if glu else y

    def pull(params, xx, cc):
        y, vjp = jax.vjp(f, params, xx)
        return (y, *vjp(cc))

    to_jax = lambda t: jnp.asarray(t.numpy().transpose(perm)).astype(dtype)
    with float32_sums():
        y, dp, dx = jax.jit(pull)(variables["params"], to_jax(x), to_jax(ct))
    back = lambda a: torch.from_numpy(np.asarray(
        a.astype(jnp.float32)).transpose(np.argsort(perm)).copy())
    return (back(y), back(dx), _t(dp["scale"]), _t(dp["bias"]))


def port_norm(kind, x, ct, scale, bias, dtype, glu=False):
    """The port's norm (``models/layers.py``; and its ``glu``): (y, dx,
    dscale, dbias) as float32 tensors."""
    norm = (layers.InstanceNorm(x.shape[1], track_running_stats=False)
            if kind == "instance" else layers.BatchNorm(x.shape[1]))
    norm.compute_dtype = dtype
    with torch.no_grad():
        norm.weight.copy_(scale)
        norm.bias.copy_(bias)
    xt = x.to(dtype).requires_grad_(True)
    y = norm(xt)
    if glu:
        y = layers.glu(y, dim=1)
    y.backward(ct.to(dtype))
    return (y.detach().float(), xt.grad.float(), norm.weight.grad,
            norm.bias.grad)


def _rel(a, b):
    return float((a - b).double().norm() / b.double().norm())


@pytest.mark.parametrize("case", ["offset", "unit", "batchnorm",
                                  "sound_encoder"])
def test_norm_bf16_backward_matches_jax(case):
    """The port's bf16 InstanceNorm / BatchNorm rounds where the JAX
    package's program does, forward and backward: on the same bf16 inputs
    at least ``NORM_BIT_SHARE`` of the output's and of dx's elements are
    bit-equal to the JAX package's (XLA's float32 ``rsqrt`` and the
    port's can part in the last bit), the scale and bias gradients within
    ``NORM_PARAM_RTOL``; followed by a GLU, the port's dx strays from the
    float32 dx no more than ``NORM_ERROR_RATIO`` times the JAX package's
    does."""
    kind, x, dy, glu_dy, scale, bias = norm_case(case)
    want = jax_norm(kind, x, dy, scale, bias, jnp.bfloat16)
    got = port_norm(kind, x, dy, scale, bias, torch.bfloat16)
    equal = [float((g == w).float().mean()) for g, w in zip(got[:2], want)]
    params = [_rel(g, w) for g, w in zip(got[2:], want[2:])]
    print(case, "bit-equal y, dx", equal, "dscale, dbias", params)
    assert min(equal) >= NORM_BIT_SHARE, equal
    assert max(params) <= NORM_PARAM_RTOL, params
    if glu_dy is not None:
        f32 = jax_norm(kind, x, glu_dy, scale, bias, jnp.float32, glu=True)
        errors = [_rel(out[1], f32[1]) for out in (
            jax_norm(kind, x, glu_dy, scale, bias, jnp.bfloat16, glu=True),
            port_norm(kind, x, glu_dy, scale, bias, torch.bfloat16,
                      glu=True))]
        print(case, "dx error against float32: jax, port", errors)
        assert errors[1] <= NORM_ERROR_RATIO * errors[0], errors

def _write_fixture():
    maps = fixture_maps()
    payload = {
        "about": "The JAX package's dtype map of one train-mode forward "
                 "under train.use_amp=true, keyed by the port's module "
                 "names; written by tests/test_torch_port_precision.py.",
        "widths": MAP_WIDTHS,
        "configs": {k: {"overrides": MAP_CONFIGS[k], **maps[k]}
                    for k in MAP_CONFIGS}}
    with open(FIXTURE, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {FIXTURE}")


def _print_readings():
    """The docstring's readings as JSON lines: each config and seed 0-5's
    largest ratio and effect share, the categorical flips of seeds 0-2,
    each default seed's codec conv-weight norms (``weight_norms``), the
    bias sum, and seed 0's default step without ``float32_sums``."""
    for config in STEP_CONFIGS:
        for seed in range(6):
            steps = bf16_steps(config, seed)[0]
            got = readings(steps)
            name, ratio = max(((k, gap_ratio(*v)) for k, v in got.items()),
                              key=lambda kv: kv[1])
            line = {"config": config, "seed": seed, "ratio": ratio,
                    "worst": name, "share": effect_share(got)}
            if config == "categorical" and seed < 3:
                line["flips"] = one_hot_flips(config, seed)
            if config == "default":
                line["codec_norms"] = {
                    k: [round(x, 4) for x in v] for prefix in CODECS
                    for k, v in weight_norms(steps, prefix).items()}
            print(json.dumps(line), flush=True)
    print(json.dumps({"bias_sum": xla_bf16_bias_sum()}))
    _jax_step_fns.cache_clear()   # compiled inside float32_sums above
    variables, jbatch, _ = _init("default", 0)
    name = "observation_model.image_horizon.conv.9.bias"
    f32, jbf = (_jax_step("default", amp, variables, jbatch)["grads"][
        name].numpy() for amp in (False, True))
    print(json.dumps({"unsummed": name, "float32": float(np.abs(f32).max()),
                      "moved": float(np.abs(jbf - f32).max())}))


def norm_glu_backward_hlo():
    """XLA's compiled CPU program of the JAX package's bf16 InstanceNorm
    (no running stats, [20, 4, 16]: the sound encoder's last norm at
    ``SMALL`` widths) followed by its ``glu``, pulled back inside
    ``float32_sums``: where it rounds (each ``convert`` to bf16)."""
    from multimodal_rssm_tpu.models import layers as jl

    norm = jl.InstanceNorm(track_running_stats=False, dtype=jnp.bfloat16)
    x = jnp.zeros((20, 4, 16), jnp.bfloat16)
    params = norm.init(jax.random.PRNGKey(0), x)

    def pull(p, xx, ct):
        _, vjp = jax.vjp(lambda q, z: jl.glu(norm.apply(q, z), axis=-1),
                         p, xx)
        return vjp(ct)

    with float32_sums():
        return jax.jit(pull).lower(params, x, x[..., :8]).compile().as_text()


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    if "--ratios" in sys.argv:
        _print_readings()
    elif "--hlo" in sys.argv:
        print(norm_glu_backward_hlo())
    else:
        _write_fixture()
