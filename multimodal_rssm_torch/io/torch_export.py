"""The port's model -> a reference ``models_{itr}.pth``.

The inverse of ``io/checkpoint.py::load_reference_checkpoint``: the port's
``state_dict`` already has the reference's names, with
``transition_model.main.*`` flattened into ``transition_model.*``, so the
export only nests it back into the schema the reference's own ``load_model``
reads (the JAX package's ``io/torch_export.py`` writes the same from its
variables):

- multimodal (``MRSSM_base.get_state_dict``, algos/MRSSM/base/algo.py:
  328-335): ``{transition_model: {main, obs_encoder: {prior_expert,
  <mod>...}}, observation_model: {<mod>...}, reward_model, encoder:
  {<mod>...}, model_optimizer}``.  ``model_optimizer`` is a fresh torch Adam
  state over as many parameters as the reference's ``param_list``
  (base/algo.py:313-322): the reference validates its group and parameter
  counts on load, then replaces it (base/algo.py:51-54).
- unimodal (``RSSM.get_state_dict``, the algo module's flat ``state_dict()``,
  algos/MRSSM/RSSM/algo.py:48-49): the port's flat ``state_dict`` as it is,
  with no optimizer entry.

Like the JAX exporter it refuses what the reference schema cannot hold: a
categorical latent (``ValueError``) and ``q(st|ot)`` experts
(``NotImplementedError``).  ``num_batches_tracked`` goes out as the model
holds it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

_BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def nest_reference(flat: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's multimodal ``state_dict`` -> the reference's nested
    ``model_dicts`` (without ``model_optimizer``)."""
    nested: Dict[str, Dict] = {
        "transition_model": {"main": {}, "obs_encoder": {}},
        "observation_model": {}, "reward_model": {}, "encoder": {}}
    for key, value in flat.items():
        top, rest = key.split(".", 1)
        if top == "transition_model":
            if rest.startswith("obs_encoder."):
                mod, leaf = rest[len("obs_encoder."):].split(".", 1)
                nested[top]["obs_encoder"].setdefault(mod, {})[leaf] = value
            else:
                nested[top]["main"][rest] = value
        elif top in ("observation_model", "encoder"):
            mod, leaf = rest.split(".", 1)
            nested[top].setdefault(mod, {})[leaf] = value
        elif top == "reward_model":
            nested[top][rest] = value
        else:
            raise ValueError(f"{key}: not in the reference's schema")
    return nested


def fresh_optimizer_state(n_params: int, lr: float, eps: float) -> Dict:
    """A fresh torch Adam ``state_dict`` over ``n_params`` parameters."""
    dummies = [torch.nn.Parameter(torch.zeros(1)) for _ in range(n_params)]
    return torch.optim.Adam(dummies, lr=lr, eps=eps).state_dict()


def reference_state_dict(model, lr: float = 1e-3, eps: float = 1e-7
                         ) -> Dict:
    """The object the reference's ``torch.save`` would hold for ``model``
    (tensors on the CPU; see the module docstring for the two schemas)."""
    if model.latent_dist != "gaussian":
        raise ValueError(
            "the reference state-dict schema is Gaussian-latent only; "
            f"cannot export a latent_dist={model.latent_dist!r} model")
    flat = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    if not model.multimodal:
        return flat
    if model.transition_model.expert_dist != "q(st|ht,ot)":
        raise NotImplementedError(
            "the reference schema holds the expert_dist 'q(st|ht,ot)' only; "
            f"cannot export {model.transition_model.expert_dist!r} experts")
    model_dicts = nest_reference(flat)
    # the reference's Adam param_list: every tensor but the norms' buffers
    model_dicts["model_optimizer"] = fresh_optimizer_state(
        sum(not k.endswith(_BUFFER_SUFFIXES) for k in flat), lr, eps)
    return model_dicts


def save_reference_checkpoint(path: str, model, lr: float = 1e-3,
                              eps: float = 1e-7) -> None:
    """Write a ``models_{itr}.pth`` the reference's ``load_model`` accepts.
    ``lr`` / ``eps``: the run's ``rssm.model_learning_rate`` /
    ``rssm.adam_epsilon``, lr 0 under a warm-up schedule (the reference's
    optimizer constructor, base/algo.py:40-42)."""
    torch.save(reference_state_dict(model, lr, eps), path)
