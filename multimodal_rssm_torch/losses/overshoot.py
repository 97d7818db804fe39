"""Latent overshooting as one batched prior rollout (reference
algos/MRSSM/base/algo.py:111-148; MoPoE variant
algos/MRSSM/MRSSM_MoPoE/algo.py:69-108; the JAX package's
``losses/overshoot.py``).

Every overshoot start t in [1, L-2] is a batch row of one prior rollout of
fixed length D from (belief, prior state) at t - 1; validity masks
reproduce the reference's zero padding past the chunk's end (masked rows
clamp to free nats and count in the mean, as in the reference).  The
targets are the posterior (PoE / NN) or every expert subset's product
(MoPoE), without gradient; for MoPoE every subset's KL is taken against
the one shared rollout, and the reward term comes from that rollout.
Gaussian and categorical latents.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from multimodal_rssm_torch.ops import categorical, fusion, gaussian


def overshooting_losses(prior_rollout_fn: Callable,
                        reward_fn: Optional[Callable],
                        states: Dict[str, torch.Tensor],
                        actions: torch.Tensor, rewards: torch.Tensor,
                        nonterminals: torch.Tensor, chunk_size: int,
                        distance: int, free_nats: float,
                        overshooting_reward_scale: float,
                        generator: Optional[torch.Generator],
                        fusion_method: str = "PoE",
                        latent_dist: str = "gaussian"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kl_overshoot, reward_overshoot), before their betas; the reward
    term carries the reference's (1 / D) * scale * (L - 1) factor.

    ``actions`` / ``rewards`` / ``nonterminals`` are the whole [L, B, .]
    chunk; ``states`` the posterior rollout's outputs [L - 1, B, .].
    ``prior_rollout_fn(h0, s0, actions, nonterminals, noise)`` is the
    core's ``prior_rollout``; ``generator=None`` rolls out at zero noise
    (the deterministic path)."""
    L, B = actions.shape[:2]
    D, N = int(distance), L - 2
    device = actions.device
    is_cat = latent_dist == "categorical"
    noise_tail = (tuple(states["prior_logits"].shape[-2:]) if is_cat
                  else (states["prior_states"].shape[-1],))

    ts = torch.arange(1, L - 1, device=device)                 # [N]
    seg_idx = ts[:, None] + torch.arange(D, device=device)[None]  # [N, D]
    valid = (seg_idx < L - 1).float()
    cidx = torch.clamp(seg_idx, max=L - 2)
    vmask = valid[:, :, None, None]                            # [N, D, 1, 1]

    def flat(x):   # [N, D, B, ...] -> [D, N*B, ...]
        return x.transpose(0, 1).reshape(D, N * B, *x.shape[3:])

    act_f = flat(actions[cidx] * vmask)
    nonterm_f = flat(nonterminals[cidx] * vmask)
    mask_f = flat(vmask.expand(N, D, B, 1))                    # [D, N*B, 1]
    init_h = states["beliefs"][ts - 1].reshape(N * B, -1)
    init_s = states["prior_states"][ts - 1].reshape(N * B, -1)
    shape = (D, N * B, *noise_tail)
    if generator is None:
        eps = torch.zeros(shape, device=device)
    elif is_cat:
        eps = categorical.gumbel_noise(generator, shape)
    else:
        eps = torch.randn(shape, generator=generator, device=device)
    roll = prior_rollout_fn(init_h, init_s, act_f, nonterm_f, eps)

    def free_nats_mean(div):   # div [D, N*B, latent] -> masked, summed
        return torch.clamp((div * mask_f).sum(-1), min=free_nats).mean()

    if is_cat:
        prior_logits = roll["prior_logits"]

        def masked_kl(target_logits):
            return free_nats_mean(categorical.kl_categorical(
                flat(target_logits[cidx]), prior_logits))

        if fusion_method == "MoPoE":
            stacked = states["expert_logits_stacked"].detach().movedim(1, 0)
            kl = torch.stack([masked_kl(lg) for lg in
                              categorical.subset_poe_logits(stacked)]).mean()
        else:
            kl = masked_kl(states["posterior_logits"].detach())
    else:
        prior_mean, prior_std = roll["prior_means"], roll["prior_std_devs"]

        def masked_kl(target_mean, target_std):
            # padded rows: mean 0, std 1 (ref :135)
            tm = flat(target_mean[cidx] * vmask)
            tstd = flat(torch.where(vmask > 0, target_std[cidx],
                                    torch.ones_like(target_std[cidx])))
            return free_nats_mean(gaussian.kl_normal(tm, tstd, prior_mean,
                                                     prior_std))

        if fusion_method == "MoPoE":
            means, stds = fusion.subset_poe_states(
                states["expert_means_stacked"].detach().movedim(1, 0),
                states["expert_std_devs_stacked"].detach().movedim(1, 0))
            kl = torch.stack([masked_kl(m, sd)
                              for m, sd in zip(means, stds)]).mean()
        else:
            kl = masked_kl(states["posterior_means"].detach(),
                           states["posterior_std_devs"].detach())

    reward_os = torch.zeros((), device=device)
    if overshooting_reward_scale != 0 and reward_fn is not None:
        pred = reward_fn(roll["beliefs"], roll["prior_states"])["loc"]
        target = flat((rewards[cidx] * valid[:, :, None])[..., None])[..., 0]
        mse = torch.square(pred * mask_f[..., 0] - target).mean()
        reward_os = (1.0 / D) * overshooting_reward_scale * mse * (
            chunk_size - 1)
    return kl, reward_os
