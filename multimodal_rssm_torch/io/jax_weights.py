"""JAX ``{params, batch_stats}`` trees -> the port's ``state_dict``.

Takes the trees of the JAX package's ``WorldModel`` (any variant) as
nested dicts of numpy arrays and returns a flat dict for
``WorldModel.load_state_dict(..., strict=True)``.  Its keys are the
reference torch schema's, with ``transition_model.main.*`` flattened into
``transition_model.*``.  The
layout inversions are the port's own copy of the JAX package's torch
exporter:

- Linear [in, out] -> [out, in]; split Linears (``fc_sa_s`` + ``fc_sa_a``,
  ``obs_<m>_fc1_h`` + ``obs_proj_<m>``) re-joined over their input blocks;
- Conv HWIO -> OIHW; ConvTranspose (kh, kw, Cin, Cout) -> (Cin, Cout, kh, kw);
- 1x1 Conv1d: Dense [in, out] -> [out, in, 1]; the sound decoder's
  ``up_conversion`` columns are stored (h, w, c) and go back to (c, h, w);
- GRU [in, 3H] -> [3H, in];
- norms: scale/bias -> weight/bias, mean/var -> running_mean/running_var,
  ``num_batches_tracked`` = 0 (GroupNorm has no running stats);
- the 84 px image decoder's Linear is ``fc``, the others' ``fc1``; the
  dense decoders and the ``draw_target`` head share ``fc1..fc3``.

``codec_state_dict`` converts one codec on its own, the codecs no world
model builds (sound v1, ``EncoderNN``) too.  ``policy_state_dict_from_jax``
converts the policy heads (``models/policy.py``), whose JAX parameter
paths are the port's module names.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_SOUND_SEED = (32, 4)  # the sound decoder's up_conversion map (H, W)


def _dense(p: Mapping) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _join_dense(a: Mapping, b: Mapping) -> Dict[str, np.ndarray]:
    w = np.concatenate([np.asarray(a["kernel"]), np.asarray(b["kernel"])], 0).T
    out = {"weight": w}
    if "bias" in a:
        out["bias"] = np.asarray(a["bias"])
    return out


def _conv(p: Mapping) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _conv_transpose(p: Mapping) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["kernel"]).transpose(2, 3, 0, 1)}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"])
    return out


def _conv1d(p: Mapping) -> Dict[str, np.ndarray]:
    return {"weight": np.asarray(p["kernel"]).T[:, :, None]}


def _conv1d_cols_hwc(p: Mapping, C: int, H: int, W: int) -> Dict[str, np.ndarray]:
    k = np.asarray(p["kernel"])                       # [in, out (h, w, c)]
    # permute within each input row (contiguous), then transpose as a view,
    # as _conv1d does: a strided transpose of the whole matrix costs ~10x
    w = np.ascontiguousarray(k.reshape(-1, H, W, C).transpose(0, 3, 1, 2))
    return {"weight": w.reshape(len(k), C * H * W).T[:, :, None]}


def _norm(p: Mapping, stats: Optional[Mapping]) -> Dict[str, np.ndarray]:
    out = {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}
    if stats is not None:
        out["running_mean"] = np.asarray(stats["mean"])
        out["running_var"] = np.asarray(stats["var"])
        out["num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    return out


def _gru(p: Mapping) -> Dict[str, np.ndarray]:
    return {"weight_ih": np.asarray(p["wi"]).T, "weight_hh": np.asarray(p["wh"]).T,
            "bias_ih": np.asarray(p["bi"]), "bias_hh": np.asarray(p["bh"])}


def _emit(into: Dict, prefix: str, leaf: Mapping) -> None:
    for k, v in leaf.items():
        into[f"{prefix}.{k}"] = v


def _count(prefix: str, tree: Mapping) -> int:
    return sum(1 for k in tree if k.startswith(prefix) and k[len(prefix):].isdigit())


def _image_encoder(sd, prefix, params, stats):
    n = _count("conv", params)
    step = 3 if "norm0" in params else 2
    for i in range(n):
        _emit(sd, f"{prefix}.conv.{i * step}", _conv(params[f"conv{i}"]))
        if step == 3:
            _emit(sd, f"{prefix}.conv.{i * step + 1}",
                  _norm(params[f"norm{i}"], stats.get(f"norm{i}")))
    if "fc" in params:
        _emit(sd, f"{prefix}.fc", _dense(params["fc"]))


def _sound_encoder(sd, prefix, params, stats):
    _emit(sd, f"{prefix}.down_sample_1.0", _conv(params["down1_conv"]))
    for i in (2, 3, 4):
        _emit(sd, f"{prefix}.down_sample_{i}.0", _conv(params[f"down{i}_conv"]))
        _emit(sd, f"{prefix}.down_sample_{i}.1",
              _norm(params[f"down{i}_norm"], stats.get(f"down{i}_norm")))
    _emit(sd, f"{prefix}.down_conversion.0", _conv1d(params["down_conversion"]))
    _emit(sd, f"{prefix}.down_conversion.1",
          _norm(params["down_conversion_norm"], None))


def _image_decoder(sd, prefix, params, stats):
    n = _count("deconv", params)
    step = 3 if "norm0" in params else 2
    # the 84 px decoder, the only one whose first ConvT is 3 x 3, keeps the
    # reference's name for its Linear
    fc = "fc" if np.shape(params["deconv0"]["kernel"])[0] == 3 else "fc1"
    _emit(sd, f"{prefix}.{fc}", _dense(params["fc1"]))
    for i in range(n):
        _emit(sd, f"{prefix}.conv.{i * step}", _conv_transpose(params[f"deconv{i}"]))
        if step == 3 and i < n - 1:
            _emit(sd, f"{prefix}.conv.{i * step + 1}",
                  _norm(params[f"norm{i}"], stats.get(f"norm{i}")))


def _mlp(sd, prefix, params, stats):
    for k in ("fc1", "fc2", "fc3"):
        _emit(sd, f"{prefix}.{k}", _dense(params[k]))


def _sound_encoder_v1(sd, prefix, params, stats):
    for i in range(_count("conv", params)):
        _emit(sd, f"{prefix}.conv.{i * 3}", _conv(params[f"conv{i}"]))
        _emit(sd, f"{prefix}.conv.{i * 3 + 1}",
              _norm(params[f"norm{i}"], stats.get(f"norm{i}")))
    if "fc" in params:
        _emit(sd, f"{prefix}.fc", _dense(params["fc"]))


def _sound_decoder_v1(sd, prefix, params, stats):
    _emit(sd, f"{prefix}.fc1.0", _dense(params["fc1_0"]))
    _emit(sd, f"{prefix}.fc1.2", _dense(params["fc1_1"]))
    n = _count("deconv", params)
    for i in range(n):
        _emit(sd, f"{prefix}.conv.{i * 3}", _conv_transpose(params[f"deconv{i}"]))
        if i < n - 1:
            _emit(sd, f"{prefix}.conv.{i * 3 + 1}",
                  _norm(params[f"norm{i}"], stats.get(f"norm{i}")))


def _encoder_nn(sd, prefix, params, stats):
    enc, enc_stats = params["multimodal_encoder"], stats.get("multimodal_encoder", {})
    for name, p in enc.items():
        _encoder_for(name)(sd, f"{prefix}.multimodal_encoder.{name}", p,
                           enc_stats.get(name, {}))
    _emit(sd, f"{prefix}.mixer.fc", _dense(params["mixer"]["fc"]))


def _encoder_for(name: str) -> Callable:
    if "image" in name:
        return _image_encoder
    return _sound_encoder if "sound" in name else _mlp


def _decoder_for(name: str) -> Callable:
    if "image" in name:
        return _image_decoder
    return _sound_decoder if "sound" in name else _mlp


def _sound_decoder(sd, prefix, params, stats):
    C = np.asarray(params["up0_deconv"]["kernel"]).shape[2]
    _emit(sd, f"{prefix}.up_conversion",
          _conv1d_cols_hwc(params["up_conversion"], C, *_SOUND_SEED))
    for i in (0, 1, 2):
        _emit(sd, f"{prefix}.up_sample_{i}.0",
              _conv_transpose(params[f"up{i}_deconv"]))
        _emit(sd, f"{prefix}.up_sample_{i}.1",
              _norm(params[f"up{i}_norm"], stats.get(f"up{i}_norm")))
    _emit(sd, f"{prefix}.out", _conv(params["out"]))


def state_dict_from_jax(params: Mapping, batch_stats: Optional[Mapping] = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX ``WorldModel``'s ``params`` /
    ``batch_stats`` trees, for every variant: multimodal (any fusion;
    ``q(st|ht,ot)`` experts in the core, or ``q(st|ot)`` heads in the
    encoder, ``encoder.<name>_head``), or unimodal in the reference's flat
    schema (``encoder`` and ``observation_model`` the one modality's
    modules, ``transition_model.obs_encoder`` its posterior head).  A
    categorical model has the Gaussian one's names, its heads' ``fc2`` V * K
    wide."""
    stats = batch_stats or {}
    sd: Dict[str, np.ndarray] = {}
    core, cell = params["core"], params["core"]["cell"]
    tm = "transition_model"
    _emit(sd, f"{tm}.fc_embed_state_action",
          _join_dense(cell["fc_sa_s"], core["fc_sa_a"]))
    _emit(sd, f"{tm}.rnn", _gru(cell["rnn"]))
    _emit(sd, f"{tm}.stochastic_state_model.fc1", _dense(cell["ssm_fc1"]))
    _emit(sd, f"{tm}.stochastic_state_model.fc2", _dense(cell["ssm_fc2"]))
    enc_stats = stats.get("encoder", {})
    dec_stats = stats.get("observation_model", {})

    def encoder(prefix, name, p):
        _encoder_for(name)(sd, prefix, p, enc_stats.get(name, {}))

    def decoder(prefix, key, p):
        _decoder_for(key)(sd, prefix, p, dec_stats.get(key, {}))

    if "obs_proj_fused" in core:   # unimodal
        _emit(sd, f"{tm}.obs_encoder.fc1",
              _join_dense(cell["obs_fc1_h"], core["obs_proj_fused"]))
        _emit(sd, f"{tm}.obs_encoder.fc2", _dense(cell["obs_fc2"]))
        ((name, p),) = params["encoder"].items()
        encoder("encoder", name, p)
        ((key, p),) = params["observation_model"].items()
        decoder("observation_model", key, p)
    else:
        _emit(sd, f"{tm}.obs_encoder.prior_expert.fc1",
              _dense(cell["prior_expert_fc1"]))
        _emit(sd, f"{tm}.obs_encoder.prior_expert.fc2",
              _dense(cell["prior_expert_fc2"]))
        enc = params["encoder"]
        for name in (n for n in enc if f"obs_proj_{n}" in core):
            _emit(sd, f"{tm}.obs_encoder.{name}.fc1",
                  _join_dense(cell[f"obs_{name}_fc1_h"],
                              core[f"obs_proj_{name}"]))
            _emit(sd, f"{tm}.obs_encoder.{name}.fc2",
                  _dense(cell[f"obs_{name}_fc2"]))
            encoder(f"encoder.{name}", name, enc[name])
        for name in (n for n in enc if f"{n}_head" in enc):   # q(st|ot)
            for k in ("fc1", "fc2"):
                _emit(sd, f"encoder.{name}_head.{k}",
                      _dense(enc[f"{name}_head"][k]))
            encoder(f"encoder.{name}", name, enc[name])
        for key, p in params["observation_model"].items():
            decoder(f"observation_model.{key[len('models_'):]}", key, p)

    _mlp(sd, "reward_model", params["reward_model"], {})
    return _to_torch(sd)


def _to_torch(sd: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}


def _dense_tree(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Every Dense of a tree of Dense layers, keyed by its dotted path."""
    sd: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        key = f"{prefix}{name}"
        if "kernel" in p:
            _emit(sd, key, _dense(p))
        else:
            sd.update(_dense_tree(p, key + "."))
    return sd


def policy_state_dict_from_jax(actor_params: Mapping, value_params: Mapping
                               ) -> Tuple[Dict[str, torch.Tensor],
                                          Dict[str, torch.Tensor]]:
    """The ``state_dict``s of the port's ``ActorModel`` (``pie.fc1`` ...
    ``pie.fc5``) and ``ValueModel`` / ``TwoHotValueModel`` (``fc1`` ...
    ``fc4``) for the JAX heads' ``params`` trees (``PieEmb``: its own
    tree as the actor's)."""
    return (_to_torch(_dense_tree(actor_params)),
            _to_torch(_dense_tree(value_params)))


_CODECS = {"image_encoder": _image_encoder, "image_decoder": _image_decoder,
           "sound_encoder": _sound_encoder, "sound_decoder": _sound_decoder,
           "sound_encoder_v1": _sound_encoder_v1,
           "sound_decoder_v1": _sound_decoder_v1,
           "symbolic_encoder": _mlp, "dense_decoder": _mlp,
           "discriminator": _mlp, "encoder_nn": _encoder_nn}


def codec_state_dict(kind: str, params: Mapping,
                     batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of one codec from its JAX ``params`` /
    ``batch_stats`` subtrees; ``kind`` is a key of ``_CODECS`` (the image
    codecs at any size and norm, the sound codecs v1 and v2, the symbolic
    encoder, the dense decoder, the Discriminator, ``EncoderNN``)."""
    sd: Dict[str, np.ndarray] = {}
    _CODECS[kind](sd, "", params, batch_stats or {})
    return _to_torch({k[1:]: v for k, v in sd.items()})
