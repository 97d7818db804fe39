"""Streaming (online) posterior inference for deployment.

Port of the JAX package's ``eval/streaming.py``: the recursive filter a
controller runs, one observation frame in, one posterior out, carrying
(belief, state) between calls.  ``OnlineFilter`` calls
``WorldModel.filter_step`` (one step of ``estimate_state``: the same
parameters and numerics) and ``decode`` directly, in ``eval()`` mode under
``torch.no_grad``.

    filt = OnlineFilter(model)
    filt.reset(batch_size=1)
    for action, frame in stream:      # frame: {name: [B, ...]}, prepared
        post = filt.step(action, frame)   # like the training inputs
        recon = filt.decode()             # optional
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch


class OnlineFilter:
    """Per-frame posterior over a stream.  ``det=False`` draws the state
    noise from ``step``'s generator, else from the filter's own (seeded
    ``seed``, on the model's device)."""

    def __init__(self, model, det: bool = True, seed: int = 0):
        self.model = model
        self.det = det
        self.device = next(model.parameters()).device
        self.h: Optional[torch.Tensor] = None
        self.s: Optional[torch.Tensor] = None
        self._generator = torch.Generator(self.device).manual_seed(seed)

    def reset(self, batch_size: int = 1) -> None:
        """Zero belief and state, as at the start of ``estimate_state``."""
        self.h = torch.zeros(batch_size, self.model.belief_size,
                             device=self.device)
        self.s = torch.zeros(batch_size, self.model.state_size,
                             device=self.device)

    @torch.no_grad()
    def step(self, action: torch.Tensor,
             observations: Mapping[str, torch.Tensor],
             nonterminal: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Advance one frame (action [B, A], observations {name: [B, ...]});
        returns the step's state dict.  ``nonterminal`` [B, 1] zeroes the
        carried state at an episode start, as in training."""
        B = next(iter(observations.values())).shape[0]
        if self.h is None:
            self.reset(B)
        if nonterminal is None:
            nonterminal = torch.ones(B, 1, device=self.device)
        if not self.det and generator is None:
            generator = self._generator
        self.model.eval()
        out = self.model.filter_step(self.h, self.s, action, observations,
                                     nonterminal,
                                     None if self.det else generator)
        self.h, self.s = out["beliefs"], out["posterior_states"]
        return out

    @torch.no_grad()
    def decode(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Reconstructions {name: {loc [B, ...], scale}} of the current
        (belief, state)."""
        self.model.eval()
        out = self.model.decode(self.h[None], self.s[None])
        return {name: {k: (v[0] if isinstance(v, torch.Tensor) else v)
                       for k, v in d.items()} for name, d in out.items()}
