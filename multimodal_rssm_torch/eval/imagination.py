"""Open-loop imagination (video prediction) and reconstruction.

Port of the JAX package's ``eval/imagination.py`` (reference
check_model.ipynb cells 33-36 and 55-58):

- ``reconstruct``: decode the posterior states of an estimated chunk;
- ``imagine``: from (h, s) at ``t_start``, roll the prior open loop with the
  recorded actions ``t_start + 1 .. t_start + horizon`` (det: the means)
  and decode every modality;
- ``video_prediction_mse``: per-modality MSE of the imagined rollout
  against the normalised observations of the same steps;
- ``cross_modal_model``: the same parameters with a posterior over a subset
  of the modalities' experts.

Gaussian latents only, as the port's ``WorldModel``: the det state is the
mean (``*_means``, equal to ``*_states`` at zero noise).  Everything runs in
``eval()`` mode under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch


@torch.no_grad()
def reconstruct(model, states) -> Dict[str, Dict[str, torch.Tensor]]:
    """Decode (beliefs, posterior_states) of an estimated chunk."""
    model.eval()
    return model.decode(states["beliefs"], states["posterior_states"])


@torch.no_grad()
def imagine(model, states, actions: torch.Tensor, t_start: int,
            horizon: Optional[int] = None, det: bool = True,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[Dict[str, torch.Tensor],
                       Dict[str, Dict[str, torch.Tensor]]]:
    """Open-loop rollout from the posterior at ``t_start``.

    states: ``estimate_state`` over a chunk with T - 1 outputs; actions:
    the chunk's [T - 1, B, A] actions, aligned with the states.  Returns
    (the prior rollout's dict, the decoded predictions per modality), both
    over times ``t_start + 1 .. t_start + horizon``.  det: start from
    ``posterior_means`` and decode ``prior_means`` (pass the states of a
    det estimate); otherwise the samples, with the rollout's noise from
    ``generator``."""
    model.eval()
    T = actions.shape[0]
    horizon = horizon if horizon is not None else T - t_start - 1
    h0 = states["beliefs"][t_start]
    s0 = states["posterior_means" if det else "posterior_states"][t_start]
    acts = actions[t_start + 1: t_start + 1 + horizon]
    roll = model.rollout_prior(h0, s0, acts, None, None if det else generator)
    preds = model.decode(roll["beliefs"],
                         roll["prior_means" if det else "prior_states"])
    return roll, preds


def video_prediction_mse(preds: Mapping[str, Mapping[str, torch.Tensor]],
                         targets: Mapping[str, torch.Tensor], t_start: int,
                         horizon: int) -> Dict[str, float]:
    """Per-modality MSE of the imagined means against the targets of the
    imagination window."""
    return {name: float(torch.mean(torch.square(
                pred["loc"] - targets[name][t_start + 1: t_start + 1 + horizon])))
            for name, pred in preds.items()}


class CrossModalModel:
    """``model`` with a posterior over the encoders and experts of
    ``names`` only (and the prior expert): the posterior entry points pass
    ``names``, everything else is the model's own.  No module is copied, so
    every parameter and buffer is shared."""

    def __init__(self, model, names: Sequence[str]):
        self.model = model
        self.names = model.resolve_names(names)

    def __getattr__(self, attr):
        return getattr(self.model, attr)

    def estimate_state(self, *args, **kwargs):
        return self.model.estimate_state(*args, names=self.names, **kwargs)

    def estimate_state_from(self, *args, **kwargs):
        return self.model.estimate_state_from(*args, names=self.names,
                                              **kwargs)

    def filter_step(self, *args, **kwargs):
        return self.model.filter_step(*args, names=self.names, **kwargs)


def cross_modal_model(model, subset: Sequence[str]) -> CrossModalModel:
    """``model`` whose posterior uses only the experts of ``subset`` (and
    the prior expert), on the same parameters (the reference's
    ``calc_subset_states``)."""
    return CrossModalModel(model, subset)
