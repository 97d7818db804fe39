"""One ``torch.profiler`` window with quiet edges, shared by every tool that
traces: ``cli/op_profile``, ``cli/profile_step`` and the train loop's
``train.profile_dir`` trace (``train/loop.py::ProfileWindow``).

The profiler keeps a kernel only if its device timestamps fall inside the
window that the host clock opened and closed, and on an H100 the two clocks
part by up to ~3 ms: kernels launched at once after the window opened
were lost from 10 of 347 windows, none with 0.1 s of quiet at both edges
(``chip_smoke.py --profiler-edges``).  So a window keeps ``EDGE_GAP_S`` of
quiet at both edges.  Apart from that, in a process that has traced
before, a new trace can lose the first few dozen kernels it records,
whatever the quiet: a window of six full-width steps lost its first 25 of
130,560 kernels after 0.1 s of quiet, and its first 22 after 1 s; the
train loop's windows of runs made one after another lost 6 (the first
kernels of the window's first step) without the launches below, and 9 of
the launches with them (``chip_smoke.py --profiler-windows``).  So a
window opens with a warm-up cycle that the profiler traces and drops (the
caller's warm-up step, or one small op), and then, recording, launches
``WARMUP_LAUNCHES`` empty kernels (``torch.cuda._sleep(0)``: ATen's
``spin_kernel``, which nothing else in the port launches) before its
quiet, which take that loss.  In order: synchronise, open, warm up,
synchronise, record, launch the empty kernels, synchronise, sleep
``EDGE_GAP_S``, start the timed span; at the end synchronise, end the
timed span, sleep ``EDGE_GAP_S``, close.  The sleeps and the empty kernels
lie outside the timed span, and the kernels are left out of every
reported time and count.

It reports the kernels' self time (on the CPU: the operators' self CPU
time), the timed span's wall time, the device's idle share of that span
(one minus kernel time over wall time), and the launches that the port's
hand-written kernels' wrappers counted inside the window
(``ops/cuda_kernels.launch_counts``) beside the records of those kernels
in the window's trace.  Tracing the host's operators as well slows the
host and so raises the idle share: a window on the card that traces the
host reports it as ``device_idle_share_host_traced``, and the tools that
read the idle share (``cli/op_profile``, ``cli/profile_step``) trace the
card alone.  On the card the kernel times come from the
profiler's own records (``kineto_results``), which ``export`` writes to
the Chrome trace, not from ``key_averages``, which takes most of a minute
over a few traced full-width steps with host activity.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

EDGE_GAP_S = 0.1
WARMUP_LAUNCHES = 512   # 20 times the most records a trace lost first
_WARMUP_KERNEL = "spin_kernel"   # what torch.cuda._sleep launches


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ProfilerWindow:
    """A ``torch.profiler`` window on ``device`` with quiet edges (module
    docstring).  ``cpu``: also trace the host's operators (on a CUDA
    device; the CPU is always traced on the CPU).  ``open(warmup)`` runs
    ``warmup`` (default: one small op) in the cycle the profiler traces
    and drops.  After ``close()``: ``wall_ms``, ``launches``, ``kernels()``
    and ``summary()``."""

    def __init__(self, device: torch.device, cpu: bool = True):
        self.device = torch.device(device)
        activities = []
        if cpu or self.device.type != "cuda":
            activities.append(torch.profiler.ProfilerActivity.CPU)
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._activities = activities
        self._host_traced = cpu and self.device.type == "cuda"
        self.prof: Optional[torch.profiler.profile] = None
        self.wall_ms: Optional[float] = None
        self.launches: Dict[str, int] = {}
        self._t0 = 0.0
        self._counts: Dict[str, int] = {}

    def open(self, warmup: Optional[Callable[[], object]] = None
             ) -> "ProfilerWindow":
        from multimodal_rssm_torch.ops import cuda_kernels as ck

        _synchronize(self.device)
        self.prof = torch.profiler.profile(
            activities=self._activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1))
        self.prof.start()
        if warmup is None:
            torch.zeros(1, device=self.device).add_(1)
        else:
            warmup()
        _synchronize(self.device)
        self.prof.step()
        if self.device.type == "cuda":
            with torch.cuda.device(self.device):
                for _ in range(WARMUP_LAUNCHES):
                    torch.cuda._sleep(0)
            _synchronize(self.device)
        time.sleep(EDGE_GAP_S)
        self._counts = ck.launch_counts()
        self._t0 = time.perf_counter()
        return self

    def close(self) -> "ProfilerWindow":
        from multimodal_rssm_torch.ops import cuda_kernels as ck

        _synchronize(self.device)
        self.wall_ms = (time.perf_counter() - self._t0) * 1e3
        now = ck.launch_counts()
        self.launches = {k: n - self._counts.get(k, 0)
                         for k, n in now.items()
                         if n - self._counts.get(k, 0)}
        time.sleep(EDGE_GAP_S)
        self.prof.step()   # ends the recorded cycle
        self.prof.stop()
        return self

    def __enter__(self) -> "ProfilerWindow":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()

    def kernels(self) -> Iterator[Tuple[str, float, int]]:
        """(name, self microseconds, count) of every kernel in the timed
        span (on the CPU: every operator but the schedule's step span): the
        window's own empty warm-up kernels are left out."""
        if self.device.type == "cuda":
            totals: Dict[str, list] = {}
            for e in self.prof.profiler.kineto_results.events():
                # a record_function span (ProfilerStep#N among them) is
                # mirrored onto the device's timeline over the kernels it
                # holds: not a kernel, as key_averages leaves it out
                if (e.device_type() == torch.autograd.DeviceType.CUDA
                        and not _is_annotation(e)
                        and _WARMUP_KERNEL not in e.name()):
                    t = totals.setdefault(e.name(), [0.0, 0])
                    t[0] += e.duration_ns() / 1e3
                    t[1] += 1
            for name, (us, count) in totals.items():
                if us > 0:
                    yield name, us, count
            return
        for e in self.prof.key_averages():
            if not e.key.startswith("ProfilerStep") and e.self_cpu_time_total:
                yield e.key, e.self_cpu_time_total, e.count

    def ordered_kernels(self) -> list:
        """The names of the kernels in the timed span, in the order they
        ran (memory copies and sets, annotations and the window's own empty
        warm-up kernels left out); on the CPU, the operators that the
        thread of the span's first one ran, in the order they started."""
        events = sorted(self.prof.profiler.kineto_results.events(),
                        key=lambda e: e.start_ns())
        if self.device.type == "cuda":
            return [e.name() for e in events
                    if e.device_type() == torch.autograd.DeviceType.CUDA
                    and not _is_annotation(e)
                    and _WARMUP_KERNEL not in e.name()
                    and not e.name().startswith(("Memcpy", "Memset"))]
        ops = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CPU
               and not _is_annotation(e)
               and not e.name().startswith("ProfilerStep")]
        if not ops:
            return []
        thread = ops[0].start_thread_id()
        return [e.name() for e in ops if e.start_thread_id() == thread]

    def export(self, path: str) -> str:
        self.prof.export_chrome_trace(path)
        return path

    def summary(self) -> Dict:
        """The window's wall and kernel ms, the device's idle share (under
        ``device_idle_share_host_traced`` where the host's operators were
        traced on the card), and each hand-written kernel's launches by its
        wrapper and its records in the window (those ``export`` writes to
        the trace)."""
        kernels = list(self.kernels())
        kernel_ms = sum(us for _, us, _ in kernels) / 1e3
        idle = ("device_idle_share_host_traced" if self._host_traced
                else "device_idle_share")
        return {"wall_ms": self.wall_ms, "kernel_ms": kernel_ms,
                idle: 1.0 - kernel_ms / self.wall_ms,
                "launches": dict(self.launches),
                "hand_written_in_trace": {
                    n: sum(c for k, _, c in kernels if n in k)
                    for n in hand_written_names()
                    if any(n in k for k, _, _ in kernels)}}


def _is_annotation(event) -> bool:
    is_annotation = getattr(event, "is_user_annotation", None)
    return bool(is_annotation and is_annotation())


def hand_written_names() -> tuple:
    """The names of the port's hand-written kernels, as their CUDA symbols
    hold them (a wrapper counted as ``<name>_wgmma`` launches
    ``<name>_kernel``)."""
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    return tuple(sorted({n[:-len("_wgmma")] if n.endswith("_wgmma") else n
                         for n in ck._all_kernels()}))

