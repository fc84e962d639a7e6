"""Off-critical-path host fetches for live loops.

A robot loop that fetches its per-frame scalars inline (the reference
prints per-frame diagnostics, main.cpp:510-517) waits for the device at
every frame. ``FetchPool`` hands each fetch to a small thread pool so the
loop keeps dispatching; results arrive in submission order via
:meth:`drain`.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np


class FetchPool:
    """Fetch device arrays to host on background threads, delivering
    completed results in submission order."""

    def __init__(self, workers: int = 3,
                 fetch: Callable[[Any], np.ndarray] = np.asarray):
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._fetch = fetch
        self._queue: collections.deque = collections.deque()

    def submit(self, value, meta=None) -> None:
        """Queue ``value`` for fetching; ``meta`` is returned alongside."""
        self._queue.append((meta, self._pool.submit(self._fetch, value)))

    def drain(self) -> list:
        """Return [(meta, np.ndarray), ...] for every fetch completed so
        far, preserving submission order (a completed fetch behind a
        pending one waits for its turn)."""
        out = []
        while self._queue and self._queue[0][1].done():
            meta, fut = self._queue.popleft()
            out.append((meta, fut.result()))
        return out

    def join(self) -> list:
        """Block until every queued fetch completes; return the rest."""
        out = []
        while self._queue:
            meta, fut = self._queue.popleft()
            out.append((meta, fut.result()))
        return out

    def close(self) -> None:
        self._pool.shutdown(wait=True)
