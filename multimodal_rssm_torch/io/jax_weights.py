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
  ``num_batches_tracked`` = 0.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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
    w = np.asarray(p["kernel"]).T                     # [out (h, w, c), in]
    w = w.reshape(H, W, C, -1).transpose(2, 0, 1, 3).reshape(C * H * W, -1)
    return {"weight": w[:, :, None]}


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
    _emit(sd, f"{prefix}.fc1", _dense(params["fc1"]))
    for i in range(n):
        _emit(sd, f"{prefix}.conv.{i * step}", _conv_transpose(params[f"deconv{i}"]))
        if step == 3 and i < n - 1:
            _emit(sd, f"{prefix}.conv.{i * step + 1}",
                  _norm(params[f"norm{i}"], stats.get(f"norm{i}")))


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
        build = _image_encoder if "image" in name else _sound_encoder
        build(sd, prefix, p, enc_stats.get(name, {}))

    def decoder(prefix, key, p):
        build = _image_decoder if "image" in key else _sound_decoder
        build(sd, prefix, p, dec_stats.get(key, {}))

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

    for k in ("fc1", "fc2", "fc3"):
        _emit(sd, f"reward_model.{k}", _dense(params["reward_model"][k]))
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
