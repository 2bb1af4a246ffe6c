"""Background-thread batch prefetching (the port's copy of
``vae_captioning_tpu/utils/prefetch.py``).

CUDA kernels launch asynchronously, so the card crunches step t while
the host assembles batch t+1 — but only if assembly happens *off* the
launching thread fast enough.  ``Prefetcher`` moves the whole
batch-assembly iterator onto a daemon thread with a bounded queue, so
fit-loop step time approaches max(compute, IO).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class Prefetcher:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead.

    Exceptions raised by the source iterator are re-raised at the
    consuming ``__next__`` call (not swallowed in the thread).  The
    thread is a daemon, so abandoning the iterator mid-sweep (e.g. the
    epoch loop's ``break``) cannot hang interpreter shutdown; it parks
    on the bounded queue and dies with the process, or is unblocked by
    ``close()``.
    """

    def __init__(self, iterable: Iterable[T], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._fill, args=(iter(iterable),), daemon=True)
        self._thread.start()

    def _fill(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                while not self._closed.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._closed.is_set():
                    return
            self._q.put(_SENTINEL)
        except BaseException as e:  # forward to the consumer
            self._q.put(e)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        """Stop the producer thread (for early exits mid-sweep)."""
        self._closed.set()
