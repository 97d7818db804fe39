"""Ranks that a command starts itself, without ``torchrun``.

``spawn(fn, nprocs, args)`` runs ``fn(rank, *args)`` in ``nprocs`` fresh
processes (the ``spawn`` start method: no CUDA state is inherited) and
waits for them all.  A rank that raises or dies fails the call and the
others are terminated (``torch.multiprocessing``'s process context); a
world that outlives ``timeout`` seconds is killed and raises
``TimeoutError``, so a hung collective cannot hang the caller.  SIGTERM and
SIGINT sent to the caller while it waits are passed on to every rank
(each then stops as its loop agrees, ``train/loop.py``).

``file_rendezvous()`` gives the ranks an ``init_method``: a ``file://``
path in a fresh temporary directory, so concurrent worlds on one host
never collide on a port.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import signal
import tempfile
import time
from typing import Callable, Iterator, Optional, Sequence

import torch.multiprocessing as mp


@contextlib.contextmanager
def file_rendezvous() -> Iterator[str]:
    """A ``file://`` init method for one world; the directory is removed
    after the block."""
    root = tempfile.mkdtemp(prefix="mrssm_rendezvous_")
    try:
        yield "file://" + os.path.join(root, "store")
    finally:
        shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def _forward_signals(processes) -> Iterator[None]:
    """SIGTERM / SIGINT to this process go to each live rank instead."""
    def forward(signum, frame):
        for p in processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    previous = {}
    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            previous[s] = signal.signal(s, forward)
    except ValueError:   # not the main thread: nothing to forward
        previous = {}
    try:
        yield
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` for rank 0 .. ``nprocs - 1``, each in a fresh
    process, and wait for all of them (module docstring)."""
    context = mp.start_processes(fn, args=tuple(args), nprocs=int(nprocs),
                                 join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    with _forward_signals(context.processes):
        try:
            while not context.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nprocs} ranks still running after {timeout} s")
        finally:
            for p in context.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
