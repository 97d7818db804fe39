"""Cooperative preemption handling for the training loop."""

from __future__ import annotations

import signal


class GracefulShutdown:
    """SIGTERM / SIGINT as a flag the training loop polls.

    Cloud jobs are preempted with SIGTERM (maintenance, spot reclaims).
    Inside this context the handlers set ``.requested`` instead of killing
    the process; the loop polls the flag once per step, writes a checkpoint
    at the step it reached and returns, so ``--resume`` continues from
    there.

    A second SIGINT falls through to the original handler (normally
    ``KeyboardInterrupt``), so a user can still force-stop a run that is
    stuck before the poll point.

    Handlers can only be installed from the main thread; elsewhere (a test
    driving the loop from a worker thread) the context is a plain flag.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = signals
        self._prev = {}
        self.requested = False

    def _handler(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            prev = self._prev.get(signum)
            if callable(prev):
                return prev(signum, frame)
            raise KeyboardInterrupt
        self.requested = True

    def __enter__(self):
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handler)
        except ValueError:  # not in the main thread
            self._prev = {}
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False
