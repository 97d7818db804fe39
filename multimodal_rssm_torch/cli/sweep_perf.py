"""Train-step throughput of config variants, each on the device-resident
replay.

    python -m multimodal_rssm_torch.cli.sweep_perf --variants remat,noremat --steps 20
        [--device cuda|cpu] [--override KEY=VALUE ...]

The port's counterpart of the JAX package's ``scripts/sweep_perf.py``.
``VARIANTS`` is the JAX script's table, verbatim.  Each variant composes
the packaged config with its overrides (and ``train.experience_size=
20000``), fills the replay with 4 synthetic episodes of 120 steps
(``cli/_profiling_common``), puts it on the device (``DeviceReplay``) and
takes the train step of ``make_device_resident_steps`` (the normalise
through K1 on the card): 3 warm-up steps, then ``--steps`` steps
synchronised at the end by reading the loss.  One row a variant, in the
JAX script's format; a variant that raises (e.g. out of memory at a large
batch) prints ``FAILED: <error>`` and the sweep goes on.

The ``unroll*`` rows set ``rssm.scan_unroll``, the unroll factor of the
JAX package's ``lax.scan`` over the 49 time steps.  The port accepts the
key and ignores it (its time loop is a Python loop), so those rows
measure the same program as ``remat``.  ``--xla`` sweeps XLA compiler
options (``train.xla_options``), which only the TPU build has: here it is
refused with a usage error.
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import Dict, List, Optional, Sequence

import torch

from multimodal_rssm_torch.cli._profiling_common import (
    add_device_argument, build_model, compose_config, fill_synthetic_buffer,
    setup_device, synchronize)

VARIANTS = {
    "remat": [],
    "noremat": ["rssm.remat=False"],
    "f32": ["train.use_amp=False"],
    "b100": ["train.batch_size=100"],
    "b128": ["train.batch_size=128"],
    "b100_conv": ["train.batch_size=100", "rssm.remat=decoders_conv"],
    "b128_conv": ["train.batch_size=128", "rssm.remat=decoders_conv"],
    "b128_full": ["train.batch_size=128", "rssm.remat=True"],
    "poe": ["rssm.multimodal_params.fusion_method=PoE"],
    "nonorm": ["rssm.normalization=None"],
    "groupnorm": ["rssm.normalization=GroupNorm"],
    # lax.scan unroll factor for the 49-step time loop (rssm.scan_unroll)
    "unroll2": ["rssm.scan_unroll=2"],
    "unroll7": ["rssm.scan_unroll=7"],
    "unroll49": ["rssm.scan_unroll=49"],
}


def measure(overrides: Sequence[str], steps: int, device: torch.device,
            episodes: int = 4, ep_len: int = 120):
    """(steps/s, ms a step, the last loss, frames a step) of ``steps``
    device-resident train steps after 3 warm-up steps."""
    from multimodal_rssm_torch.data.buffer import build_buffer
    from multimodal_rssm_torch.data.device_buffer import DeviceReplay
    from multimodal_rssm_torch.train import trainer as tr

    cfg = compose_config(["train.experience_size=20000", *overrides])
    D = fill_synthetic_buffer(build_buffer(cfg), cfg, episodes=episodes,
                              ep_len=ep_len)
    model, optimizer, scheduler = build_model(cfg, device)
    spec = tr.build_aug_spec(D)
    draws_src = tr.HostAugmentDraws(D, spec)
    generator = torch.Generator(device).manual_seed(0)
    B, L = int(cfg.train.batch_size), int(cfg.train.chunk_size)
    dev = DeviceReplay(D, device)
    train_step, _ = tr.make_device_resident_steps(
        model, cfg, optimizer, scheduler, spec, device, D.observation_names,
        dev.row_shapes)

    def run_step():
        return train_step(dev.arrays, dev.sample_indices(B, L),
                          draws_src.draw(), generator)

    for _ in range(3):
        metrics = run_step()
    float(metrics["loss"])
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = run_step()
    loss = float(metrics["loss"])
    el = time.perf_counter() - t0
    return steps / el, 1e3 * el / steps, loss, B * L


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    """Parse ``argv``, measure each variant, print a row each; returns the
    rows (``{"variant", "steps_per_s", "ms_per_step", "frames_per_s",
    "loss"}`` or ``{"variant", "failed"}``)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--variants", default="remat")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument(
        "--xla", action="append", default=None, metavar="SPEC",
        help="TPU-only (train.xla_options): XLA compiler option sets; "
             "refused here")
    parser.add_argument("--override", action="append", default=[],
                        help="overrides added to every variant")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    if args.xla is not None:
        parser.error("--xla is TPU-only: it sweeps XLA compiler options "
                     "(train.xla_options), which the PyTorch port ignores")

    device = setup_device(args.device)
    rows = []
    for name in args.variants.split(","):
        try:
            sps, ms, loss, frames = measure(
                [*VARIANTS[name], *args.override], args.steps, device)
        except Exception as e:  # out of memory at a large batch; a name
            # VARIANTS lacks (KeyError), as the JAX script reports it
            print(f"{name:10s} FAILED: {type(e).__name__}: "
                  f"{(str(e).splitlines() or [""])[0][:120]}", flush=True)
            rows.append({"variant": name,
                         "failed": f"{type(e).__name__}: {e}"[:400]})
        else:
            print(f"{name:10s} {sps:7.2f} steps/s  {ms:7.0f} ms/step  "
                  f"{sps * frames:9.0f} frames/s  loss {loss:.1f}",
                  flush=True)
            rows.append({"variant": name, "steps_per_s": sps,
                         "ms_per_step": ms, "frames_per_s": sps * frames,
                         "loss": loss})
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
