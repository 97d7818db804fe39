"""Optimizer, input pipeline, ELBO and the train / eval steps.

Port of the JAX package's ``train/trainer.py``:

- Adam (eps from the config) after clipping by global norm with optax's
  rule ``g * max_norm / ||g||`` when ``||g|| >= max_norm``
  (``clip_grad_norm_`` would divide by ``||g|| + 1e-6``), with the
  reference's linear warm-up when ``learning_rate_schedule`` is set;
- mixed precision = bf16 ``torch.autocast`` around the model's forward,
  float32 parameters, optimizer state and loss;
- the device half of the input pipeline (crop / noise / PCA / clip, then
  the bit-depth normalise, through the hand-written kernel when
  ``train.pallas_normalize`` is on or the caller asks for it);
- metric names of the reference's wandb keys plus ``grad_norm`` and
  ``grad_norm_<module>`` (the JAX package's module names);
- ``train.grad_accum``: the prepared batch split into equal micro-batches
  along axis 1, their gradients and metrics averaged before one clip and
  one Adam step.

Randomness comes from an explicit ``torch.Generator`` on the data's device;
``generator=None`` in the loss is the deterministic path (posterior and
prior samples collapse to their means).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from multimodal_rssm_torch.data import augment as aug
from multimodal_rssm_torch.data.device_buffer import gather_batch
from multimodal_rssm_torch.losses import elbo
from multimodal_rssm_torch.losses.overshoot import overshooting_losses
from multimodal_rssm_torch.models.layers import frozen_running_stats
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.ops import cuda_kernels
from multimodal_rssm_torch.ops.image import normalize_image

# the JAX package's top-level parameter groups, for grad_norm_<module>
GRAD_GROUPS = {"encoder": "encoder", "transition_model": "core",
               "observation_model": "observation_model",
               "reward_model": "reward_model"}


def compute_dtype(cfg) -> torch.dtype:
    """bf16 compute when ``train.use_amp`` (ref train.yaml:29)."""
    return torch.bfloat16 if cfg.train.use_amp else torch.float32


def autocast(device: torch.device, dtype: torch.dtype):
    """bf16 autocast on ``device``, or nothing for float32."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


# -- optimizer ---------------------------------------------------------------


def build_optimizer(cfg, model: torch.nn.Module):
    """Adam at the config's lr/eps plus, when ``learning_rate_schedule`` is
    set, a linear ramp from 0 (optax's ``linear_schedule``: the first step
    uses lr 0).  Returns (optimizer, scheduler or None)."""
    lr = float(cfg.rssm.model_learning_rate)
    opt = torch.optim.Adam(model.parameters(), lr=lr,
                           eps=float(cfg.rssm.adam_epsilon))
    steps = int(cfg.rssm.learning_rate_schedule or 0)
    sched = (torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: min(c, steps) / steps) if steps else None)
    return opt, sched


def global_norm(grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares (optax.global_norm); None counts as 0."""
    sq = [torch.sum(torch.square(g.float())) for g in grads if g is not None]
    if not sq:
        return torch.zeros(())
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def clip_by_global_norm_(grads: List[Optional[torch.Tensor]],
                         norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: keep g when ||g|| < max_norm,
    else g / ||g|| * max_norm.  No host sync."""
    keep = norm < max_norm
    for g in grads:
        if g is not None:
            g.copy_(torch.where(keep, g, g / norm * max_norm))


# -- augmentation plumbing ---------------------------------------------------


class ModalityAugSpec(NamedTuple):
    """Augmentation structure of one image modality."""

    out_size: Tuple[int, int]
    needs_crop: bool
    noise: bool
    pca: bool
    normalize: bool


class AugSpec(NamedTuple):
    modalities: Tuple[Tuple[str, ModalityAugSpec], ...]

    def get(self, name: str) -> Optional[ModalityAugSpec]:
        for n, spec in self.modalities:
            if n == name:
                return spec
        return None


def build_aug_spec(buffer) -> AugSpec:
    """The augmentation structure implied by a buffer's configuration."""
    mods = []
    for name in buffer.observation_names:
        if "image" not in name:
            continue
        stored_hw = tuple(buffer.observations[name].shape[1:3])
        out_size = (aug.crop_size_for(name) if buffer.n_crop is not None
                    else stored_hw)
        noise = ("bin" not in name and buffer.noise_scales is not None
                 and any(s > 0 for s in buffer.noise_scales))
        pca = ("bin" not in name and buffer.pca_scales is not None
               and any(s > 0 for s in buffer.pca_scales)
               and buffer.p_eigen_vectors.get(name) is not None)
        mods.append((name, ModalityAugSpec(
            out_size=out_size, needs_crop=stored_hw != out_size, noise=noise,
            pca=pca, normalize="bin" not in name)))
    return AugSpec(modalities=tuple(mods))


class HostAugmentDraws:
    """Per-batch augmentation choices drawn on the host (ref
    data_augment.py:178-208): crop offsets, a noise scale, a PCA vector."""

    def __init__(self, buffer, spec: AugSpec, seed: int = 0):
        self.buffer = buffer
        self.spec = spec
        self.rng = np.random.default_rng(seed)

    def draw(self) -> Dict[str, Dict[str, np.ndarray]]:
        b = self.buffer
        out: Dict[str, Dict[str, np.ndarray]] = {}
        pca_rand = None
        for name, mspec in self.spec.modalities:
            entry: Dict[str, np.ndarray] = {}
            if mspec.needs_crop:
                crop_idx = int(self.rng.integers(0, b.n_crop))
                dh, dw = aug.idx_to_offsets(
                    crop_idx, b.observations[name].shape[1:3],
                    mspec.out_size, b.dh_base, b.dw_base)
                entry["crop"] = np.asarray([dh, dw], np.int32)
            if mspec.noise:
                entry["noise"] = np.float32(b.noise_scales[
                    int(self.rng.integers(0, len(b.noise_scales)))])
            if mspec.pca:
                if pca_rand is None:
                    scale = float(b.pca_scales[
                        int(self.rng.integers(0, len(b.pca_scales)))])
                    pca_rand = (self.rng.standard_normal(3).astype(np.float32)
                                * scale if scale > 0
                                else np.zeros(3, np.float32))
                entry["pca"] = aug.pca_delta(
                    b.p_eigen_vectors[name], b.lambd_eigen_values[name],
                    pca_rand).astype(np.float32)
            out[name] = entry
        return out


def kernel_normalize_enabled(cfg, device: torch.device) -> bool:
    """Resolve ``train.pallas_normalize`` (false | true | auto): whether the
    hand-written normalise kernel replaces ``ops/image.normalize_image`` in
    the step.  "auto" = on when the step runs on CUDA.  On a CPU tensor the
    kernel's wrapper runs its plain version."""
    mode = str(cfg.train.get("pallas_normalize", "auto")).lower()
    if mode in ("true", "false"):
        return mode == "true"
    if mode != "auto":
        raise ValueError(
            f"train.pallas_normalize={mode!r} not in (false, true, auto)")
    return device.type == "cuda"


def prepare_observations(observations: Mapping[str, torch.Tensor],
                         spec: AugSpec,
                         draws: Mapping[str, Mapping[str, np.ndarray]],
                         bit_depth: int, generator: torch.Generator,
                         kernel_normalize: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Device half of the input pipeline (ref memory.py:189-209): crop /
    noise / PCA / clip for images, then the bit-depth normalise ("bin"
    images: no normalise).  ``kernel_normalize`` routes the normalise
    through ``cuda_kernels.normalize_image`` with a seed drawn on the
    device from ``generator`` (no host sync)."""
    out = {}
    for name, arr in observations.items():
        mspec = spec.get(name)
        if mspec is None:
            out[name] = arr.float()
            continue
        entry = draws.get(name, {})
        img = arr.float()
        if mspec.needs_crop:
            dh, dw = (int(v) for v in entry["crop"])
            oh, ow = mspec.out_size
            img = img[:, :, dh:dh + oh, dw:dw + ow]
        delta = None
        if mspec.noise:
            delta = torch.randn(img.shape, generator=generator,
                                device=img.device) * (float(entry["noise"]) * 255.0)
        if mspec.pca:
            pca = torch.as_tensor(entry["pca"], device=img.device)
            delta = pca if delta is None else delta + pca
        if delta is not None:
            img = torch.clamp(img + delta, 0.0, 255.0)
        if mspec.normalize:
            if kernel_normalize:
                seed = torch.randint(0, 2 ** 62, (), generator=generator,
                                     device=img.device, dtype=torch.int64)
                img = cuda_kernels.normalize_image(img, bit_depth, seed)
            else:
                img = normalize_image(img, bit_depth, generator)
        out[name] = img
    return out


# -- loss ---------------------------------------------------------------------


def make_loss_fn(model: WorldModel, cfg) -> Callable:
    """The ELBO over a prepared batch: ``loss_fn(batch, generator, train)``
    -> (total, metrics).  The model's forward runs under the configured
    autocast; ``train`` selects batch statistics (and updates the running
    stats) or the running statistics.  Every branch of the JAX package's
    loss: the KL by fusion and latent (MoPoE: the mean over subset
    products; PoE / NN and unimodal: balanced by ``kl_balancing_alpha``),
    the global KL, latent overshooting and the log-prob reconstruction and
    reward terms.  The overshooting rollout draws its noise from the
    step's generator after the posterior rollout's: the JAX package splits
    its key instead, but a torch generator is a stream already, and
    seeding a second one from a device generator would synchronise the
    host every step."""
    rssm = cfg.rssm
    use_log_prob = bool(rssm.worldmodel_LogProbLoss)
    kl_alpha = rssm.get("kl_balancing_alpha")
    kl_alpha = None if kl_alpha is None else float(kl_alpha)
    free_nats = float(rssm.free_nats)
    global_kl_beta = float(rssm.global_kl_beta)
    kl_beta = float(rssm.kl_beta)
    overshooting_kl_beta = float(rssm.overshooting_kl_beta or 0)
    chunk_size = int(cfg.train.chunk_size)
    # the reference clamps the distance to the chunk (utils/logger.py:42-43)
    overshooting_distance = min(int(rssm.overshooting_distance or 0),
                                chunk_size)
    overshooting_reward_scale = float(rssm.overshooting_reward_scale or 0)
    predict_reward = bool(rssm.predict_reward)
    mopoe = model.multimodal and (
        rssm.multimodal_params.fusion_method == "MoPoE")
    categorical = model.latent_dist == "categorical"
    overshoot = overshooting_kl_beta != 0 and overshooting_distance > 0
    dtype = compute_dtype(cfg)

    def loss_fn(batch, generator: Optional[torch.Generator], train: bool):
        observations, actions, rewards, nonterminals = batch
        obs_target = {k: v[1:] for k, v in observations.items()}
        model.train(train)
        with autocast(actions.device, dtype):
            states, per_elem, rew = model.train_forward(
                obs_target, actions[:-1], nonterminals[:-1], generator,
                use_log_prob)

        observations_loss = elbo.observation_losses(per_elem,
                                                    negate=use_log_prob)
        observations_loss_sum = sum(observations_loss.values())
        reward_l = elbo.reward_loss(rew["loc"], rew["scale"], rewards[:-1],
                                    use_log_prob)
        if not predict_reward:
            reward_l = torch.zeros_like(reward_l)
        if mopoe and categorical:
            kl_loss = elbo.mopoe_kl_categorical(
                states["expert_logits_stacked"], states["prior_logits"],
                free_nats)
        elif mopoe:
            kl_loss = elbo.mopoe_kl(
                states["expert_means_stacked"],
                states["expert_std_devs_stacked"], states["prior_means"],
                states["prior_std_devs"], free_nats)
        elif categorical:
            kl_loss = elbo.kl_balanced_categorical(
                states["posterior_logits"], states["prior_logits"], kl_alpha,
                free_nats)
        else:
            kl_loss = elbo.kl_balanced(
                states["posterior_means"], states["posterior_std_devs"],
                states["prior_means"], states["prior_std_devs"], kl_alpha,
                free_nats)
        kl_loss_sum = kl_loss
        if global_kl_beta != 0:
            kl_loss_sum = kl_loss_sum + global_kl_beta * (
                elbo.global_kl_categorical(states["posterior_logits"])
                if categorical else
                elbo.global_kl(states["posterior_means"],
                               states["posterior_std_devs"]))
        if overshoot:
            with autocast(actions.device, dtype):
                kl_os, reward_os = overshooting_losses(
                    model.transition_model.prior_rollout,
                    model.reward_model if overshooting_reward_scale != 0
                    else None, states, actions, rewards, nonterminals,
                    chunk_size, overshooting_distance, free_nats,
                    overshooting_reward_scale, generator,
                    "MoPoE" if mopoe else "PoE", model.latent_dist)
            kl_loss_sum = kl_loss_sum + overshooting_kl_beta * kl_os
            if predict_reward:
                reward_l = reward_l + reward_os
        total = observations_loss_sum + reward_l + kl_beta * kl_loss_sum

        metrics = {"observations_loss_sum": observations_loss_sum}
        for name, v in observations_loss.items():
            metrics[f"observation_{name}_loss"] = v
        metrics["reward_loss"] = reward_l
        metrics["kl_loss_sum"] = kl_loss_sum
        metrics["kl_loss"] = kl_loss
        metrics["loss"] = total
        return total, {k: v.detach() for k, v in metrics.items()}

    return loss_fn


# -- steps ----------------------------------------------------------------------


def grad_norms(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``grad_norm`` over all parameters and ``grad_norm_<module>`` per
    top-level module (the reference's wandb.watch analogue)."""
    out = {"grad_norm": global_norm([p.grad for p in model.parameters()])}
    for child, group in GRAD_GROUPS.items():
        out[f"grad_norm_{group}"] = global_norm(
            [p.grad for p in getattr(model, child).parameters()])
    return out


def apply_gradients(model: torch.nn.Module, optimizer, scheduler,
                    max_norm: float) -> Dict[str, torch.Tensor]:
    """Gradient norms of the accumulated ``.grad``s, then clip by global
    norm and one optimizer (and schedule) step.  Returns the norms."""
    norms = grad_norms(model)
    clip_by_global_norm_([p.grad for p in model.parameters()],
                         norms["grad_norm"], max_norm)
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return norms


def resolve_grad_accum(cfg) -> int:
    """``train.grad_accum``: the number of micro-batches a train step splits
    its batch into (1, or null: off); below 1 raises ``ValueError``."""
    raw = cfg.train.get("grad_accum", 1)
    accum = 1 if raw is None else int(raw)
    if accum < 1:
        raise ValueError(f"train.grad_accum={accum} must be >= 1")
    return accum


def slice_microbatch(batch, start: int, size: int):
    """Rows ``start:start + size`` of every tensor's batch axis (axis 1:
    [L, B, ...])."""
    observations, *rest = batch
    return ({k: v[:, start:start + size] for k, v in observations.items()},
            *(x[:, start:start + size] for x in rest))


def accumulated_backward(loss_fn: Callable, model: torch.nn.Module, batch,
                         generator: Optional[torch.Generator], accum: int
                         ) -> Dict[str, torch.Tensor]:
    """Backward of ``loss_fn`` over ``accum`` equal micro-batches of the
    (already prepared) batch, in order, into the parameters' ``.grad``,
    which end as the mean of the micro-batches' gradients; returns the
    metrics' mean over the micro-batches.  The crop, noise and PCA draws
    of the batch are shared; the norms' running stats thread through the
    micro-batches in order (the JAX package's
    ``accumulated_value_and_grad``).  Raises ``ValueError`` when ``accum``
    does not divide the batch."""
    B = batch[1].shape[1]
    if B % accum:
        raise ValueError(
            f"batch size {B} not divisible by train.grad_accum={accum}")
    if accum == 1:
        loss, metrics = loss_fn(batch, generator, True)
        loss.backward()
        return metrics
    mb = B // accum
    per_micro = []
    for i in range(accum):
        loss, metrics = loss_fn(slice_microbatch(batch, i * mb, mb),
                                generator, True)
        loss.backward()
        per_micro.append(metrics)
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
    return {k: torch.stack([m[k] for m in per_micro]).mean(0)
            for k in per_micro[0]}


def make_train_step(model: WorldModel, cfg, optimizer, scheduler,
                    aug_spec: AugSpec, device: torch.device,
                    kernel_normalize: Optional[bool] = None):
    """(train_step, eval_step), each ``step(raw_batch, draws, generator) ->
    metrics`` (0-d device tensors; nothing synchronises).  ``train_step``
    updates the parameters, the optimizer state and the norms' running
    stats in place, over ``train.grad_accum`` micro-batches (which must
    divide ``train.batch_size``: ``ValueError`` here otherwise).
    ``kernel_normalize`` routes the normalise through K1's wrapper, or not;
    None reads ``train.pallas_normalize``."""
    accum = resolve_grad_accum(cfg)
    if int(cfg.train.batch_size) % accum:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} not "
                         f"divisible by train.grad_accum={accum}")
    loss_fn = make_loss_fn(model, cfg)
    bit_depth = int(cfg.env.bit_depth)
    use_kernel = (kernel_normalize_enabled(cfg, device)
                  if kernel_normalize is None else kernel_normalize)
    max_norm = float(cfg.rssm.grad_clip_norm)

    def _prepare(raw_batch, draws, generator):
        observations, actions, rewards, nonterminals = raw_batch
        observations = prepare_observations(
            observations, aug_spec, draws, bit_depth, generator, use_kernel)
        return observations, actions, rewards, nonterminals

    def train_step(raw_batch, draws, generator):
        batch = _prepare(raw_batch, draws, generator)
        optimizer.zero_grad(set_to_none=True)
        metrics = accumulated_backward(loss_fn, model, batch, generator,
                                       accum)
        metrics.update(apply_gradients(model, optimizer, scheduler, max_norm))
        return metrics

    @torch.no_grad()
    def eval_step(raw_batch, draws, generator):
        batch = _prepare(raw_batch, draws, generator)
        _, metrics = loss_fn(batch, generator, False)
        return metrics

    return train_step, eval_step


def make_grad_fn(model: WorldModel, cfg, aug_spec: AugSpec,
                 device: torch.device):
    """``grad_fn(raw_batch, draws, generator) -> {name: gradient}``: one
    forward and backward of the train step's loss (the whole batch, its
    input pipeline and normalise path), for ``train.histogram_interval``'s
    gradient histograms (the JAX package's ``make_grad_fn``).  It observes
    only: the caller passes a generator of its own, no norm's running stats
    move (``frozen_running_stats``), and the gradients come from
    ``torch.autograd.grad``, so no ``.grad`` and no optimizer state is
    touched.  A parameter the loss does not reach gets a zero gradient."""
    loss_fn = make_loss_fn(model, cfg)
    bit_depth = int(cfg.env.bit_depth)
    use_kernel = kernel_normalize_enabled(cfg, device)
    named = list(model.named_parameters())

    def grad_fn(raw_batch, draws, generator):
        observations, actions, rewards, nonterminals = raw_batch
        observations = prepare_observations(
            observations, aug_spec, draws, bit_depth, generator, use_kernel)
        with frozen_running_stats(model):
            loss, _ = loss_fn((observations, actions, rewards, nonterminals),
                              generator, True)
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for (n, p), g in zip(named, grads)}

    return grad_fn


def make_device_resident_steps(model: WorldModel, cfg, optimizer, scheduler,
                               aug_spec: AugSpec, device: torch.device,
                               observation_names, row_shapes):
    """(train_step, eval_step) over a device-resident replay
    (``data/device_buffer.py``), each ``step(buffer_arrays, idxs, draws,
    generator) -> metrics``: the chunks are gathered on the device from
    the [n, L] index matrix, then the step is ``make_train_step``'s on the
    same raw batch layout."""
    train_raw, eval_raw = make_train_step(model, cfg, optimizer, scheduler,
                                          aug_spec, device)
    names = tuple(observation_names)

    def train_step(buffer_arrays, idxs, draws, generator):
        return train_raw(gather_batch(buffer_arrays, idxs, names, row_shapes),
                         draws, generator)

    def eval_step(buffer_arrays, idxs, draws, generator):
        return eval_raw(gather_batch(buffer_arrays, idxs, names, row_shapes),
                        draws, generator)

    return train_step, eval_step
