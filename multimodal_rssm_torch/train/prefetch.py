"""Host-side batch prefetcher for the host-streamed feed.

A worker thread keeps up to ``depth`` device-ready batches queued: it
samples and gathers the next batch on the host (the native gather releases
the interpreter lock) and copies it to the device while the loop's thread
queues the current step.

On a GPU the worker's copies run on a stream of its own and each item
carries an event recorded after them.  ``get()`` makes the caller's
current stream wait on that event, and marks every tensor of the item as
used on that stream (``record_stream``), so the caching allocator does not
hand the memory to the worker's stream again while the step still reads
it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch


def _tensors(item):
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _tensors(v)


class Prefetcher:
    """``produce()`` on a worker thread, up to ``depth`` items ahead, in
    order.  ``device``: a CUDA device gives the worker its own stream; a CPU
    device none.  Errors of ``produce`` are raised by ``get()``."""

    def __init__(self, produce: Callable[[], object], depth: int = 2,
                 device: Optional[torch.device] = None):
        self._produce = produce
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._device = device
        self._stream = (torch.cuda.Stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="prefetch")
        self._thread.start()

    def _next(self):
        if self._stream is None:
            return self._produce(), None
        with torch.cuda.stream(self._stream):
            item = self._produce()
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return item, ready

    def _worker(self):
        try:
            while not self._stop.is_set():
                entry = self._next()
                while not self._stop.is_set():
                    try:
                        self._queue.put(entry, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised by the next get()
            self._exc = e

    def get(self):
        while True:
            try:
                item, ready = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if not self._thread.is_alive():
                    raise RuntimeError("prefetch thread ended")
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in _tensors(item):
                if t.is_cuda:
                    t.record_stream(stream)
        return item

    def close(self):
        """Stop the worker and join it (items still queued are dropped)."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
