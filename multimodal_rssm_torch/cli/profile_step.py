"""Where one training step's time goes, on the GPU.

    python -m multimodal_rssm_torch.cli.profile_step [overrides ...] \\
        [--batch-size 50 --chunk-size 50 --small] [--override a.b=c ...] \\
        [--steps N] [--warmup N] [--trace PATH]

Builds the configured model (default: the shipped configuration with the
normalise kernel on, batch 50 x chunk 50; ``--small``: the JAX script's
seven narrow widths; ``--override`` and the positional overrides after
them) on random weights and one random uint8/float batch
(``cli/_profiling_common.build_step_setup``, which the other measurement
tools share), warms up, then over ``--steps`` steps prints JSON lines:

- ``phases``: device milliseconds per step of the input pipeline, the
  encoder, the RSSM time loop, the decoders (each forward only, from CUDA
  events recorded by module hooks), the whole loss forward, the backward
  and the optimizer step, plus the host-clock step time and the peak
  memory allocated;
- ``profile``: the device's idle share of the profiled window (one minus
  CUDA kernel time over wall time), the hand-written kernels' launches in
  it, and the kernels with the most device time (``torch.profiler``, in a
  ``core/profiling.ProfilerWindow`` that traces the card alone, as
  ``cli/op_profile``'s: quiet at both edges).

``--trace`` writes a Chrome trace of the profiled window (the card's
kernels and the runtime's launches).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch

from multimodal_rssm_torch.cli._profiling_common import build_step_setup
from multimodal_rssm_torch.core.profiling import ProfilerWindow
from multimodal_rssm_torch.train import trainer as tr


class _Spans:
    """CUDA events around module forwards and named regions, per step."""

    def __init__(self):
        self.events: Dict[str, List] = {}

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.setdefault(name, []).append(ev)

    def hook(self, module: torch.nn.Module, name: str) -> None:
        module.register_forward_pre_hook(lambda *_: self.mark(name + ":start"))
        module.register_forward_hook(lambda *_: self.mark(name + ":end"))

    def wrap(self, obj, method: str, name: str) -> None:
        """Span around a method that is not ``forward`` (hooks miss it)."""
        fn = getattr(obj, method)

        def timed(*args, **kwargs):
            self.mark(name + ":start")
            out = fn(*args, **kwargs)
            self.mark(name + ":end")
            return out

        setattr(obj, method, timed)

    def ms(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        out = {}
        for key, starts in self.events.items():
            if key.endswith(":start"):
                name = key[:-len(":start")]
                ends = self.events[name + ":end"]
                out[name] = sum(s.elapsed_time(e) for s, e in zip(starts, ends))
        self.events.clear()
        return out


# scripts/profile_step.py's --small: bench.py --small's widths without
# embedding_size.other
SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "train.use_amp=False"]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("overrides", nargs="*")
    parser.add_argument("--batch-size", type=int, default=50)
    parser.add_argument("--chunk-size", type=int, default=50)
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--override", action="append", default=[],
                        help="extra config overrides (repeatable), e.g. "
                             "--override rssm.latent_dist=categorical")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--trace", default=None)
    return parser.parse_args(argv)


def setup(args: argparse.Namespace, device: str = "cuda"):
    """The step ``args`` asks for (``build_step_setup``), K1 on."""
    return build_step_setup(
        args.batch_size, args.chunk_size,
        ["train.pallas_normalize=true", *(SMALL if args.small else []),
         *args.override, *args.overrides], device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Parse ``argv``, time and profile; prints the two JSON lines and
    returns them as {"phases", "profile"}."""
    args = parse_args(argv)
    (cfg, model, optimizer, scheduler, spec, _, raw, generator, device,
     _) = setup(args)
    loss_fn = tr.make_loss_fn(model, cfg)
    use_kernel = tr.kernel_normalize_enabled(cfg, device)

    spans = _Spans()
    spans.hook(model.encoder, "encoder")
    spans.hook(model.transition_model, "rssm_loop")
    spans.wrap(model.observation_model, "get_mse", "decoders")

    def step():
        spans.mark("prepare:start")
        obs = tr.prepare_observations(raw[0], spec, {}, int(cfg.env.bit_depth),
                                      generator, use_kernel)
        spans.mark("prepare:end")
        optimizer.zero_grad(set_to_none=True)
        spans.mark("loss_forward:start")
        loss, _ = loss_fn((obs, *raw[1:]), generator, True)
        spans.mark("loss_forward:end")
        spans.mark("backward:start")
        loss.backward()
        spans.mark("backward:end")
        spans.mark("optimizer:start")
        tr.apply_gradients(model, optimizer, scheduler,
                           float(cfg.rssm.grad_clip_norm))
        spans.mark("optimizer:end")
        return loss

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    spans.ms()

    per_step, host = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        float(step().detach())
        host.append((time.perf_counter() - t0) * 1e3)
        per_step.append(spans.ms())
    phases = {k: statistics.median(s[k] for s in per_step) for k in per_step[0]}
    result = {"phases_ms": phases, "host_step_ms": statistics.median(host),
              "max_memory_allocated_GiB":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "batch": int(cfg.train.batch_size),
              "chunk": int(cfg.train.chunk_size),
              "device": torch.cuda.get_device_name(0)}
    print(json.dumps(result), flush=True)

    with ProfilerWindow(device, cpu=False) as window:
        for _ in range(args.steps):
            step()
    summary = window.summary()
    kernels = sorted(window.kernels(), key=lambda k: k[1], reverse=True)
    profile = {
        "profile_steps": args.steps, "wall_ms": summary["wall_ms"],
        "device_busy_ms": summary["kernel_ms"],
        "device_idle_share": summary["device_idle_share"],
        "launches": summary["launches"],
        "hand_written_in_trace": summary["hand_written_in_trace"],
        "top_kernels": [{"name": name[:90], "calls": count,
                         "ms_per_step": us / 1e3 / args.steps}
                        for name, us, count in kernels[:20]]}
    print(json.dumps(profile), flush=True)
    if args.trace:
        profile["trace"] = window.export(args.trace)
    return {"phases": result, "profile": profile}


if __name__ == "__main__":
    main()
