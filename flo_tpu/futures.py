"""Futures for the bulk pipelines: dispatch now, collect later.

JAX dispatch is asynchronous — a jitted call returns as soon as the program
and its uploads are enqueued. The bulk APIs exploit that internally with
chunked double-buffering, but round 1 still ran the four bench pipelines
strictly serially: each ``encode_many``/``decode_many`` blocked on its own
downloads before the next pipeline's uploads started, leaving the duplex
wire half idle. The ``*_async`` variants return a :class:`BulkFuture` whose
``result()`` performs the blocking downloads + host finalization, so callers
can dispatch several pipelines before collecting any.

Single-threaded by design: overlap comes from the device and DMA engines,
not host threads.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

T = TypeVar("T")


def start_host_copy(*arrays) -> None:
    """Begin device->host DMA for each array without blocking.

    Called at dispatch time on small per-chunk outputs (sizes, widths,
    modes) and at collect time on the next chunk's payload prefix, so
    downloads overlap the current chunk's host finalization. No-op where
    the backend lacks copy_to_host_async."""
    for a in arrays:
        try:
            a.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass


class BulkFuture(Generic[T]):
    """Deferred collection of an already-dispatched bulk operation."""

    __slots__ = ("_collect", "_out")

    def __init__(self, collect: Callable[[], T]):
        self._collect = collect
        self._out: T | None = None

    def result(self) -> T:
        if self._collect is not None:
            self._out = self._collect()
            self._collect = None
        return self._out  # type: ignore[return-value]

    def then(self, fn: Callable[[T], "BulkFuture | object"]) -> "BulkFuture":
        """Chain a host-side transformation (lazy; no dispatch happens here)."""
        def chained():
            out = fn(self.result())
            return out.result() if isinstance(out, BulkFuture) else out
        return BulkFuture(chained)
