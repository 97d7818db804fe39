"""PyTorch port, the world model's remaining codecs and training options
held against the JAX package: the image codecs at 64 / 84 / 128 / 256 px
under every norm (BatchNorm, InstanceNorm, GroupNorm, none), the symbolic
and label heads, sound v1, ``Mixer`` / ``EncoderNN``, the weight bridge
and a reference ``.pth`` for such models, ``rssm.remat``, the refusals
(``train.grad_accum`` too), and a train -> estimate_state -> check_model
round trip on a 128 px + pose run.  At the ``bench.py --small`` widths in
float32, on weights carried over by ``state_dict_from_jax`` /
``codec_state_dict``.

Tolerances:
- the weight converter is exact (a relayout, no arithmetic);
- module outputs and running stats at rtol 1e-5, atol 5e-5, as
  ``test_torch_port_model.py``: the same float32 math, sums taken in
  another order.  GroupNorm needs no more: flax takes its variance as
  max(E[x^2] - E[x]^2, 0) in float32 over each group, ``nn.GroupNorm`` as
  the mean squared deviation, so they differ by the float32 rounding of
  E[x^2] against the variance, about 1e-7 x E[x^2] / var relative; at
  these inputs (conv outputs of centred weights, E[x^2] / var under 10)
  the largest difference seen is 3.9e-6;
- a remat step against the same step without remat exactly: the
  recompute repeats the forward's float32 operations on the CPU.

``test_torch_port_codecs_step.py`` holds the loss step of each new
configuration and ``train.grad_accum`` against the JAX package.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.io.torch_export import (
    export_world_model, save_reference_checkpoint)
from multimodal_rssm_tpu.models import decoders as jdec
from multimodal_rssm_tpu.models import encoders as jenc
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.ops.image import normalize_image_deterministic as jax_det
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.cli import check_model, estimate_state
from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io.jax_weights import (
    codec_state_dict, state_dict_from_jax)
from multimodal_rssm_torch.models import decoders as pdec
from multimodal_rssm_torch.models import encoders as penc
from multimodal_rssm_torch.models.layers import GroupNorm
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops import cuda_kernels
from multimodal_rssm_torch.train import trainer as tr

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]
ONE = dict(rtol=1e-5, atol=5e-5)
SIZES = (64, 84, 128, 256)
NORMS = ("BatchNorm", "InstanceNorm", "GroupNorm", None)
ACT = {"cnn": "relu", "dense": "relu", "fusion": "relu"}
EMB = {"image": 64, "sound": 32, "other": 16, "fusion": 64}
H, S, HID = 16, 8, 32       # belief, state, hidden of the module tests


def _names(names):
    return f"[{','.join(names)}]"


def _codec_config(enc, rec=None, extra=()):
    rec = enc if rec is None else rec
    return [f"rssm.observation_names_enc={_names(enc)}",
            f"rssm.observation_names_rec={_names(rec)}", *extra]


# the configurations of this slice (chip_smoke.py's phase codecs, at small
# widths): the COBOTTA 128 px camera with the pose as an observation; 256 px
# with GroupNorm; InstanceNorm with the draw_target label head; 84 px with
# no norm (a shape the COBOTTA schema lacks)
CONFIGS = {
    "cobotta128": _codec_config(("image_horizon_128", "sound",
                                 "pose_quat_v2")),
    "img256_groupnorm": _codec_config(("image_horizon_256", "sound"),
                                      extra=["rssm.normalization=GroupNorm"]),
    "img64_instancenorm_label": _codec_config(
        ("image_horizon", "sound"), ("image_horizon", "sound", "draw_target"),
        ["rssm.normalization=InstanceNorm",
         "env.observation_shapes.draw_target=[2]"]),
    "img84_nonorm": _codec_config(
        ("image_horizon_84", "sound"),
        extra=["rssm.normalization=None",
               "env.observation_shapes.image_horizon_84=[3,84,84]"]),
}
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


def _moved_stats(variables, rng):
    """Running stats moved off their init, so eval mode reads them."""
    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
            out["batch_stats"])
    return out


def _port_stats(module):
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _check_module(jm, variables, port, args, train, kind, out_key=None):
    """``jm`` (flax) and ``port`` on the same weights and inputs in one
    mode: outputs, and in train mode the updated running stats."""
    port.load_state_dict(codec_state_dict(kind, variables["params"],
                                          variables.get("batch_stats")))
    port.train(train)
    jargs = [jnp.asarray(a) for a in args]
    if train and "batch_stats" in variables:
        want, mutated = jm.apply(variables, *jargs, True,
                                 mutable=["batch_stats"])
    else:
        want, mutated = jm.apply(variables, *jargs, train), None
    with torch.no_grad():
        got = port(*(_t(a) for a in args))
    if out_key is not None:
        got, want = got[out_key], want[out_key]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ONE)
    if mutated is not None:
        stats = codec_state_dict(kind, variables["params"],
                                 _np_tree(mutated["batch_stats"]))
        assert _port_stats(port)
        for k, v in _port_stats(port).items():
            np.testing.assert_allclose(v.numpy(), stats[k].numpy(), **ONE,
                                       err_msg=k)


# -- the modules ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _image_encoder_vars(size, norm):
    rng = np.random.default_rng(size)
    x = rng.uniform(-0.5, 0.5, (3, size, size, 3)).astype(np.float32)
    jm = jenc.build_image_encoder((3, size, size), EMB["image"], "relu", norm,
                                  jnp.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    return jm, _moved_stats(variables, rng), x


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("size", SIZES)
def test_image_encoder_matches_jax(size, norm, train):
    """Every image encoder the JAX package builds: output, and the running
    stats in train mode (the eval mode reads them)."""
    jm, variables, x = _image_encoder_vars(size, norm)
    port = penc.build_image_encoder((3, size, size), EMB["image"], "relu",
                                    norm)
    assert isinstance(port, penc.IMAGE_ENCODERS[size])
    if norm == "GroupNorm":
        assert isinstance(port.conv[1], GroupNorm)
    _check_module(jm, variables, port, (x,), train, "image_encoder")


@functools.lru_cache(maxsize=None)
def _image_decoder_vars(size, norm):
    rng = np.random.default_rng(size + 1)
    h = rng.normal(size=(2, 2, H)).astype(np.float32)
    s = rng.normal(size=(2, 2, S)).astype(np.float32)
    shapes = {"image_horizon": (3, size, size)}
    jm = jdec.build_observation_model("image_horizon", shapes, H, S, HID, EMB,
                                      ACT, norm, jnp.float32)
    variables = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(h),
                                 jnp.asarray(s), False))
    return jm, _moved_stats(variables, rng), (h, s)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("size", SIZES)
def test_image_decoder_matches_jax(size, norm, train):
    """Every image decoder the JAX package builds: the [T, B, H, W, C] mean
    and the running stats in train mode; the 84 px decoder's Linear is
    ``fc``, the others' ``fc1``."""
    jm, variables, args = _image_decoder_vars(size, norm)
    port = pdec.build_observation_model(
        "image_horizon", {"image_horizon": (3, size, size)}, H, S, HID, EMB,
        ACT, norm)
    assert hasattr(port, "fc" if size == 84 else "fc1")
    _check_module(jm, variables, port, args, train, "image_decoder",
                  out_key="loc")


@pytest.mark.parametrize("train", [True, False])
def test_sound_v1_codecs_match_jax(train):
    """SoundEncoder and SoundDecoder v1 (GLU + BatchNorm; no factory builds
    them): output and running stats; the decoder reads [state, belief]."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 128, 20)).astype(np.float32)
    jm = jenc.SoundEncoder(embedding_size=250)
    v = _moved_stats(_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                      False)), rng)
    _check_module(jm, v, penc.SoundEncoder(250), (x,), train,
                  "sound_encoder_v1")
    jm = jenc.SoundEncoder(embedding_size=32)          # with its fc
    v = _moved_stats(_np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                      False)), rng)
    _check_module(jm, v, penc.SoundEncoder(32), (x,), train,
                  "sound_encoder_v1")
    h = rng.normal(size=(2, 3, H)).astype(np.float32)
    s = rng.normal(size=(2, 3, S)).astype(np.float32)
    jm = jdec.SoundDecoder()
    v = _moved_stats(_np_tree(jm.init(jax.random.PRNGKey(2), jnp.asarray(h),
                                      jnp.asarray(s), False)), rng)
    port = pdec.SoundDecoder(H, S)
    _check_module(jm, v, port, (h, s), train, "sound_decoder_v1",
                  out_key="loc")
    assert port(_t(h), _t(s))["loc"].shape == (2, 3, 128, 20)


def test_symbolic_dense_and_label_heads_match_jax():
    """SymbolicEncoder (pose as an observation), DenseDecoder and the
    Discriminator, built by the factories as the JAX package's; the
    Discriminator's ``get_mse`` / ``get_log_prob`` are the soft-target
    cross-entropy over the class axis, as JAX's."""
    rng = np.random.default_rng(4)
    shapes = {"pose_quat_v2": (3,), "draw_target": (2,)}
    x = rng.normal(size=(5, 3)).astype(np.float32)
    jm = jenc.build_encoder("pose_quat_v2", shapes, EMB, ACT, "BatchNorm",
                            jnp.float32)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    port = penc.build_encoder("pose_quat_v2", shapes, EMB, ACT, "BatchNorm")
    assert isinstance(port, penc.SymbolicEncoder)
    _check_module(jm, v, port, (x,), True, "symbolic_encoder")

    h = rng.normal(size=(3, 2, H)).astype(np.float32)
    s = rng.normal(size=(3, 2, S)).astype(np.float32)
    target = jax.nn.softmax(rng.normal(size=(3, 2, 2)).astype(np.float32))
    for name, kind, cls in (("pose_quat_v2", "dense_decoder",
                             pdec.DenseDecoder),
                            ("draw_target", "discriminator",
                             pdec.Discriminator)):
        jm = jdec.build_observation_model(name, shapes, H, S, HID, EMB, ACT,
                                          "BatchNorm", jnp.float32)
        v = _np_tree(jm.init(jax.random.PRNGKey(1), jnp.asarray(h),
                             jnp.asarray(s), False))
        port = pdec.build_observation_model(name, shapes, H, S, HID, EMB, ACT,
                                            "BatchNorm")
        assert type(port) is cls
        _check_module(jm, v, port, (h, s), True, kind, out_key="loc")
        o = np.asarray(target) if name == "draw_target" else rng.normal(
            size=(3, 2, 3)).astype(np.float32)
        for method in ("get_mse", "get_log_prob"):
            want = jm.apply(v, jnp.asarray(h), jnp.asarray(s), jnp.asarray(o),
                            method=getattr(type(jm), method))
            got = getattr(port, method)(_t(h), _t(s), _t(o))
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       **ONE, err_msg=f"{name} {method}")
    assert port.fc1.out_features == HID    # the label head is hidden wide


@pytest.mark.parametrize("train", [True, False])
def test_mixer_and_encoder_nn_match_jax(train):
    """EncoderNN: every modality's encoder, then the Mixer's concat +
    Linear + activation into one fusion-wide vector."""
    rng = np.random.default_rng(5)
    names = ("image_horizon_128", "sound", "pose_quat_v2")
    shapes = {"image_horizon_128": (3, 128, 128), "sound": (128, 20),
              "pose_quat_v2": (3,)}
    obs = {"image_horizon_128": rng.uniform(-.5, .5, (3, 128, 128, 3)),
           "sound": rng.normal(size=(3, 128, 20)),
           "pose_quat_v2": rng.normal(size=(3, 3))}
    obs = {k: v.astype(np.float32) for k, v in obs.items()}
    jm = jenc.EncoderNN(observation_names_enc=names, observation_shapes=shapes,
                        embedding_size=EMB, activation_function=ACT,
                        normalization="BatchNorm")
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    v = _moved_stats(_np_tree(jm.init(jax.random.PRNGKey(0), jobs, False)),
                     rng)
    port = penc.EncoderNN(names, shapes, EMB, ACT, "BatchNorm")
    port.load_state_dict(codec_state_dict("encoder_nn", v["params"],
                                          v["batch_stats"]))
    port.train(train)
    if train:
        want, mutated = jm.apply(v, jobs, True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jobs, False)
    with torch.no_grad():
        got = port({k: _t(x) for k, x in obs.items()})
    assert got.shape == (3, EMB["fusion"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ONE)
    if train:
        stats = codec_state_dict("encoder_nn", v["params"],
                                 _np_tree(mutated["batch_stats"]))
        for k, t in _port_stats(port).items():
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(), **ONE,
                                       err_msg=k)


# -- the weight bridge -------------------------------------------------------------

BRIDGE = {
    "img84_batchnorm": _codec_config(
        ("image_horizon_84", "sound"),
        extra=["env.observation_shapes.image_horizon_84=[3,84,84]"]),
    "img128_instancenorm": _codec_config(
        ("image_horizon_128", "sound"),
        extra=["rssm.normalization=InstanceNorm"]),
    "img256_groupnorm": CONFIGS["img256_groupnorm"],
    "img64_none": _codec_config(("image_horizon", "sound"),
                                extra=["rssm.normalization=None"]),
    "pose_and_label": CONFIGS["cobotta128"][:1] + [
        "rssm.observation_names_rec=[image_horizon_128,pose_quat_v2,"
        "draw_target]", "env.observation_shapes.draw_target=[2]"],
}


def _observations(rng, shapes, names, T, Bn):
    """Inputs in each modality's training range: normalised images, a
    spectrogram, poses, soft class targets."""
    out = {}
    for n in names:
        shape = tuple(shapes[n])
        if "image" in n:
            img = rng.integers(0, 256, (T, Bn, *shape[1:], shape[0]), np.uint8)
            out[n] = np.asarray(jax_det(jnp.asarray(img), 5))
        elif n == "draw_target":
            out[n] = np.asarray(jax.nn.softmax(
                rng.normal(size=(T, Bn, *shape)).astype(np.float32)))
        else:
            out[n] = rng.normal(size=(T, Bn, *shape)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _bridged(case_overrides):
    over = SMALL + list(case_overrides)
    jcfg = jax_compose(overrides=over + ["rssm.remat=false"])
    cfg = compose(overrides=over)
    jm = JaxWorldModel.from_config(jcfg)
    rng = np.random.default_rng(0)
    obs = _observations(rng, cfg.env.observation_shapes,
                        cfg.rssm.observation_names_enc, 3, B)
    act = rng.normal(size=(3, B, A)).astype(np.float32)
    init = jax.jit(functools.partial(jm.init, train=False))
    variables = _moved_stats(_np_tree(init(jax.random.PRNGKey(0), obs, act,
                                           None, None)), rng)
    return jcfg, cfg, jm, variables


def _flatten_export(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = prefix if k == "main" else (f"{prefix}.{k}" if prefix else k)
        if isinstance(v, dict):
            out.update(_flatten_export(v, key))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("case", list(BRIDGE))
def test_state_dict_from_jax_matches_exporter(case):
    """Leaf for leaf against the JAX package's torch exporter, exactly, and
    strictly loadable into the port's model of the same configuration."""
    _, cfg, jm, variables = _bridged(tuple(BRIDGE[case]))
    want = _flatten_export(export_world_model(jm, variables))
    got = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == tuple(np.shape(v)), k
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    port = WorldModel.from_config(cfg)
    assert set(port.state_dict()) == set(want)
    port.load_state_dict(got, strict=True)


def test_reference_pth_of_a_128px_pose_model_loads(tmp_path):
    """A ``.pth`` the JAX package's ``save_reference_checkpoint`` wrote for
    a 128 px + pose model loads into the port's model, equal to
    ``state_dict_from_jax`` of the same variables."""
    _, cfg, jm, variables = _bridged(tuple(CONFIGS["cobotta128"]))
    path = str(tmp_path / "models_100.pth")
    save_reference_checkpoint(path, jm, variables)
    port = WorldModel.from_config(cfg)
    ckpt.load_reference_checkpoint(path, port)
    want = state_dict_from_jax(variables["params"], variables["batch_stats"])
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# -- batches ---------------------------------------------------------------------


def _batch(cfg, seed, Bn=B):
    """A deterministic raw batch for ``cfg``'s modalities (images prepared
    by the JAX package's deterministic normalise) as (JAX, port) tuples."""
    rng = np.random.default_rng(seed)
    names = sorted(set(cfg.rssm.observation_names_enc)
                   | set(cfg.rssm.observation_names_rec))
    obs = _observations(rng, cfg.env.observation_shapes, names, L, Bn)
    act = rng.normal(size=(L, Bn, A)).astype(np.float32)
    rew = rng.normal(size=(L, Bn)).astype(np.float32)
    nt = np.ones((L, Bn, 1), np.float32)
    nt[2, 1] = 0.0
    jbatch = ({k: jnp.asarray(v) for k, v in obs.items()}, jnp.asarray(act),
              jnp.asarray(rew), jnp.asarray(nt))
    pbatch = ({k: _t(v) for k, v in obs.items()}, _t(act), _t(rew), _t(nt))
    return jbatch, pbatch


# -- train.grad_accum ---------------------------------------------------------------


def test_grad_accum_refuses_bad_values():
    """``train.grad_accum`` below 1, or one that does not divide the batch,
    raises ``ValueError`` (as the JAX package's ``resolve_grad_accum`` /
    ``accumulated_value_and_grad``), before a step; 1 and null take the
    whole batch."""
    model = WorldModel.from_config(compose(overrides=SMALL))
    opt, sched = tr.build_optimizer(compose(overrides=SMALL), model)
    cpu = torch.device("cpu")
    for value in ("1", "null", "2", "5", "25"):
        cfg = compose(overrides=SMALL + [f"train.grad_accum={value}"])
        tr.make_train_step(model, cfg, opt, sched, tr.AugSpec(()), cpu)
    for value, match in (("0", ">= 1"), ("-2", ">= 1"), ("3", "divisible")):
        cfg = compose(overrides=SMALL + [f"train.grad_accum={value}"])
        with pytest.raises(ValueError, match=match):
            tr.make_train_step(model, cfg, opt, sched, tr.AugSpec(()), cpu)
        if match == ">= 1":
            with pytest.raises(ValueError, match=match):
                jtr.resolve_grad_accum(jax_compose(
                    overrides=[f"train.grad_accum={value}"]))
    _, pbatch = _batch(compose(overrides=SMALL), 0, Bn=2)
    with pytest.raises(ValueError, match="not divisible"):
        tr.accumulated_backward(tr.make_loss_fn(model, compose(
            overrides=SMALL)), model, pbatch, None, 4)


@pytest.mark.parametrize("size", SIZES)
def test_step_reserve_counts_the_image_codecs_activations(size):
    """``step_reserve_bytes``: the default's 40 GiB for one 64 px codec;
    ``image_codec_elements`` equals the image plus every conv and ConvT
    output of one sample through the port's codec; each element beyond
    one 64 px codec costs ``_BYTES_PER_CODEC_ELEMENT`` per micro-batch
    sample (``train.grad_accum`` divides the samples)."""
    from multimodal_rssm_torch.data import device_buffer as db

    shape = (3, size, size)
    counted = [3 * size * size]
    hook = lambda m, i, o: counted.append(o[0].numel())  # noqa: E731
    enc = penc.build_image_encoder(shape, 64, "relu", None)
    dec = pdec.build_observation_model("image_horizon", {"image_horizon":
                                                         shape}, H, S, HID,
                                       EMB, ACT, None)
    for m in (*enc.modules(), *dec.modules()):
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        enc(torch.zeros(1, size, size, 3))
        dec(torch.zeros(1, 1, H), torch.zeros(1, 1, S))
    assert db.image_codec_elements(shape) == sum(counted)
    name = "image_horizon" if size == 64 else f"image_horizon_{size}"
    over = [f"env.observation_shapes.{name}=[3,{size},{size}]",
            *_codec_config((name, "sound"))]
    extra = db.image_codec_elements(shape) - db.image_codec_elements(
        (3, 64, 64))
    for accum in (1, 2):
        cfg = compose(overrides=over + [f"train.grad_accum={accum}"])
        assert db.step_reserve_bytes(cfg) == (40 << 30) + (
            50 * 49 // accum * extra * db._BYTES_PER_CODEC_ELEMENT)


# -- rssm.remat -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _remat_step(remat):
    """One port step of ``cobotta128`` (BatchNorm image, InstanceNorm sound,
    a symbolic modality) at ``rssm.remat=remat``: loss, metrics, gradients,
    buffers and post-Adam parameters."""
    _, cfg, _, variables = _bridged(tuple(CONFIGS["cobotta128"]))
    cfg = compose(overrides=SMALL + CONFIGS["cobotta128"]
                  + [f"rssm.remat={str(remat).lower()}"])
    _, pbatch = _batch(cfg, 1)
    model = WorldModel.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables["batch_stats"]))
    opt, sched = tr.build_optimizer(cfg, model)
    loss, metrics = tr.make_loss_fn(model, cfg)(pbatch, None, True)
    loss.backward()
    grads = {n: (p.grad.clone() if p.grad is not None else None)
             for n, p in model.named_parameters()}
    metrics.update(tr.apply_gradients(model, opt, sched, 100.0))
    return model, metrics, grads


@pytest.mark.parametrize("remat", [True, "decoders", "conv", "decoders_conv"])
def test_remat_step_equals_the_step_without_it(remat):
    """Each ``rssm.remat`` value checkpoints the codecs the JAX package's
    does and leaves the same loss, metrics, gradients, running stats (each
    updated once: ``num_batches_tracked`` is 1) and post-Adam parameters as
    the step without remat."""
    model, metrics, grads = _remat_step(remat)
    base, base_metrics, base_grads = _remat_step(False)
    enc = model.encoder
    dec = model.observation_model
    want_enc = {True: "full", "conv": "conv"}.get(remat)
    want_dec = {True: "full", "decoders": "full"}.get(remat, "conv")
    assert enc["image_horizon_128"].remat_mode == want_enc
    assert enc["sound"].remat_mode == want_enc
    assert dec["image_horizon_128"].remat_mode == want_dec
    assert dec["sound"].remat_mode == want_dec
    assert base.encoder["sound"].remat_mode is None
    assert set(metrics) == set(base_metrics)
    for k, v in base_metrics.items():
        assert torch.equal(metrics[k], v), k
    for k, g in base_grads.items():
        assert (grads[k] is None and g is None) or torch.equal(grads[k], g), k
    state, base_state = model.state_dict(), base.state_dict()
    for k, v in base_state.items():
        assert torch.equal(state[k], v), k
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k


def test_remat_recompute_runs_under_frozen_running_stats(monkeypatch):
    """The recompute does run the norms' forward again (the trap): counted
    here, its running-stat updates are the ones ``frozen_running_stats``
    drops."""
    from multimodal_rssm_torch.models import layers

    calls = {"frozen": 0, "live": 0}
    update = layers._Norm._update

    def spy(self, mean, var):
        calls["frozen" if self.frozen else "live"] += 1
        return update(self, mean, var)

    monkeypatch.setattr(layers._Norm, "_update", spy)
    cfg = compose(overrides=SMALL + ["rssm.remat=true"])
    model = WorldModel.from_config(cfg)
    _, pbatch = _batch(cfg, 0)
    loss, _ = tr.make_loss_fn(model, cfg)(pbatch, None, True)
    live = calls["live"]
    loss.backward()
    assert calls["live"] == live and calls["frozen"] == live > 0
    assert not any(m.frozen for m in model.modules()
                   if isinstance(m, layers._Norm))


# -- refusals ---------------------------------------------------------------------


@pytest.mark.parametrize("override,match", [
    ("rssm.remat=sometimes", "rssm.remat"),
    ("rssm.remat=encoders", "rssm.remat"),
    ("rssm.normalization=LayerNorm", "rssm.normalization"),
])
def test_bad_remat_and_normalization_raise(override, match):
    """A ``rssm.remat`` outside (true, false, decoders, conv,
    decoders_conv), as the JAX package's ``_check_remat``, or a norm the JAX
    package does not build raises ``ValueError``."""
    with pytest.raises(ValueError, match=match):
        WorldModel.from_config(compose(overrides=SMALL + [override]))
    if "remat" in override:
        with pytest.raises(ValueError, match=match):
            JaxWorldModel.from_config(jax_compose(overrides=SMALL + [override]))


# -- the entry points on a 128 px + pose run ----------------------------------------------


def test_cli_round_trip_on_a_128px_pose_run(tmp_path, monkeypatch):
    """train -> estimate_state -> check_model through the port's CLIs on the
    CPU for a 128 px + sound + pose run (BatchNorm, grad_accum 2): K1's
    plain version once per train / validation step and, in each eval CLI,
    once per episode for the one non-bin image modality; image grids and
    SSIM only for the image, MSE and PSNR for every modality."""
    shapes = {"image_horizon_128": [3, 128, 128], "sound": [128, 20],
              "pose_quat_v2": [3]}
    write_synthetic_dataset(str(tmp_path / "train"), 2, 30, shapes)
    write_synthetic_dataset(str(tmp_path / "val"), 1, 30, shapes, seed=9)
    calls = []
    plain = cuda_kernels.normalize_image_plain
    monkeypatch.setattr(cuda_kernels, "normalize_image_plain",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    result = cli_train.main(SMALL + CONFIGS["cobotta128"] + [
        f"train.train_data_path=[{tmp_path}/train]",
        f"train.validation_data_path=[{tmp_path}/val]",
        "train.batch_size=2", "train.chunk_size=4", "train.train_iteration=2",
        "train.validation_interval=2", "train.checkpoint_interval=2",
        "train.experience_size=200", "train.pallas_normalize=true",
        "train.grad_accum=2", "--device", "cpu", "--cwd", str(tmp_path)])
    assert calls == [(4, 2, 128, 128, 3)] * 3
    assert np.isfinite(list(result["metrics"].values())).all()
    assert "observation_pose_quat_v2_loss" in result["metrics"]
    run_dir = result["results_dir"]
    calls.clear()
    saved = estimate_state.main(["--targets", os.path.dirname(run_dir),
                                 "--itr", "2", "--cwd", str(tmp_path),
                                 "--device", "cpu"])
    assert calls == [(30, 1, 128, 128, 3)] * 2
    states = np.load(saved[0], allow_pickle=True).item()
    assert len(states) == 2
    for s in states.values():
        assert s["posterior_means"].shape == (29, 1, 16)
        assert set(s["expert_means"]) == {"prior_expert", *shapes}
    calls.clear()
    report = check_model.main(["--run", run_dir, "--itr", "2", "--t-start",
                               "5", "--horizon", "10", "--cwd", str(tmp_path),
                               "--device", "cpu"])
    assert calls == [(30, 1, 128, 128, 3)] * 2
    grids = [f for f in report["files"] if f.startswith(
        ("reconstruction_", "imagination_")) and not f.endswith(".json")]
    assert sorted(os.path.splitext(f)[0] for f in grids) == [
        "imagination_image_horizon_128", "reconstruction_image_horizon_128"]
    assert set(report["metrics"]) == set(shapes)
    assert "ssim" in report["metrics"]["image_horizon_128"]
    for name in ("sound", "pose_quat_v2"):
        assert "ssim" not in report["metrics"][name]
    assert np.isfinite([v for m in report["metrics"].values()
                        for v in m.values()]).all()


def _run_84px(tmp_path, extra):
    return cli_train.main(SMALL + CONFIGS["img84_nonorm"] + [
        f"train.train_data_path=[{tmp_path}/train]",
        f"train.validation_data_path=[{tmp_path}/val]", "train.batch_size=2",
        "train.chunk_size=4", "train.train_iteration=1",
        "train.validation_interval=1", "train.experience_size=200", *extra,
        "--device", "cpu", "--cwd", str(tmp_path)])


def test_84px_run_needs_the_crop_off(tmp_path):
    """As in the JAX package: the default ``train.augmentation.n_crop=1``
    crops every image to its name's crop size at load (64 px for
    ``image_horizon_84``), which does not fit the 84 px replay and raises
    there; with the crop off the run trains."""
    shapes = {"image_horizon_84": [3, 84, 84], "sound": [128, 20]}
    write_synthetic_dataset(str(tmp_path / "train"), 1, 30, shapes)
    write_synthetic_dataset(str(tmp_path / "val"), 1, 30, shapes, seed=9)
    with pytest.raises(ValueError, match="broadcast"):
        _run_84px(tmp_path, [])
    result = _run_84px(tmp_path, ["train.augmentation.n_crop=null"])
    assert np.isfinite(list(result["metrics"].values())).all()
