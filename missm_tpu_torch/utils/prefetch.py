"""Host-side input prefetching, after missm_tpu/utils/prefetch.py.

A background thread decodes and collates ahead of the device and optionally
performs the host->device transfer (`transfer`), double-buffering so that
the card does not wait on input between steps.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional


class _Sentinel:
    pass


_DONE = _Sentinel()


class Prefetcher:
    """Wraps an iterable; a worker thread stays `depth` batches ahead.
    Exceptions in the worker re-raise at the consuming site."""

    def __init__(self, iterable: Iterable, depth: int = 2,
                 transfer: Optional[Callable] = None):
        self.iterable = iterable
        self.depth = depth
        self.transfer = transfer

    def __iter__(self) -> Iterator:
        """Abandoning the returned generator early (a consumer `break` —
        e.g. the train loop's mid-epoch preemption stop) must not leak
        the worker: its generator close (CPython: immediate, refcount)
        runs the `finally`, which flags the worker to stop, closes the
        wrapped iterator (cascading through nested prefetchers), and
        joins — instead of leaving a daemon thread blocked on q.put
        forever, pinning ~depth decoded batches (and, for the transfer
        stage, racing transfers against whatever the consumer does
        next, e.g. a synchronous checkpoint's device->host copies)."""
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        err = []
        stop = threading.Event()
        it = iter(self.iterable)

        def _put(item) -> bool:
            # bounded put that notices cancellation
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def work():
            try:
                while not stop.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    if self.transfer is not None:
                        item = self.transfer(item)
                    if not _put(item):
                        break
            except BaseException as e:  # noqa: BLE001 - propagate to consumer
                err.append(e)
            finally:
                _put(_DONE)  # dropped only when the consumer is gone

        t = threading.Thread(target=work, daemon=True,
                             name="missm-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _DONE:
                    break
                yield item
            t.join()
            if err:
                raise err[0]
        finally:
            stop.set()
            close = getattr(it, "close", None)
            if close is not None:
                try:  # cascade: a nested Prefetcher generator releases
                    close()  # ITS worker the same way
                except BaseException:  # noqa: BLE001
                    pass
            # bounded: the worker exits within one put-timeout once
            # unblocked; next(it) can hold it for up to one decode
            t.join(timeout=60.0)


def prefetch(iterable: Iterable, depth: int = 2,
             transfer: Optional[Callable] = None) -> Prefetcher:
    return Prefetcher(iterable, depth, transfer)
