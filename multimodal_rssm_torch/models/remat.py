"""Activation rematerialisation of the codecs (``rssm.remat``).

The JAX package's ``nn.remat`` of each encoder and decoder
(``world_model.py`` ``_remat_enc`` / ``_remat_dec``) as
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` around the
codec's forward: the backward recomputes the codec instead of keeping its
activations.  By ``rssm.remat``:

- ``false``: nothing;
- ``true``: every encoder and decoder, recomputed whole;
- ``decoders``: the decoders only, whole;
- ``conv``: every encoder and decoder, keeping the conv, ConvTranspose and
  matmul outputs (a selective-checkpoint policy) and recomputing only the
  norm / GLU / activation tail;
- ``decoders_conv``: the decoders only, as ``conv``.

The recompute runs the norms' forward a second time; it runs inside
``layers.frozen_running_stats(codec)``, so the running stats are updated
once, by the forward, and a remat step equals the step without it.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from multimodal_rssm_torch.models.layers import frozen_running_stats

REMAT_VALUES = (True, False, "decoders", "conv", "decoders_conv")


def check_remat(value):
    """``rssm.remat`` as given; raises ``ValueError`` outside
    ``REMAT_VALUES``."""
    if value not in REMAT_VALUES:
        raise ValueError(f"rssm.remat={value!r} is not one of {REMAT_VALUES}")
    return value


def encoder_mode(remat) -> Optional[str]:
    """How the encoders are rematerialised: "conv", "full" or None."""
    if remat == "conv":
        return "conv"
    return "full" if remat is True else None


def decoder_mode(remat) -> Optional[str]:
    """How the decoders are rematerialised: "conv", "full" or None."""
    if remat in ("conv", "decoders_conv"):
        return "conv"
    return "full" if remat is True or remat == "decoders" else None


# the outputs the "conv" policy keeps: convolutions (Conv1d / Conv2d /
# ConvTranspose2d) and the matmuls of nn.Linear
_SAVED_OPS = frozenset({torch.ops.aten.convolution.default,
                        torch.ops.aten.mm.default,
                        torch.ops.aten.addmm.default,
                        torch.ops.aten.bmm.default})


def _conv_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_OPS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


class Rematerialised(nn.Module):
    """A codec whose forward is checkpointed when ``remat_mode`` is set
    ("full" or "conv", by its factory) and gradients are being recorded."""

    remat_mode: Optional[str] = None

    def __call__(self, *args):
        if self.remat_mode is None or not torch.is_grad_enabled():
            return super().__call__(*args)
        calls = []

        def run(*inputs):
            calls.append(None)
            if len(calls) == 1:   # the forward
                return nn.Module.__call__(self, *inputs)
            with frozen_running_stats(self):   # the backward's recompute
                return nn.Module.__call__(self, *inputs)

        context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                        _conv_policy)
                      if self.remat_mode == "conv" else ckpt.noop_context_fn)
        return ckpt.checkpoint(run, *args, use_reentrant=False,
                               context_fn=context_fn)
