"""Async coordination utilities.

Re-design of Orleans' src/Orleans.Core/Async/ (1,342 LoC):
``AsyncExecutorWithRetries`` (backoff retry), ``BatchWorker`` (coalesced
background work), ``AsyncSerialExecutor`` (non-reentrant serial execution of
queued closures), ``AsyncPipeline`` (bounded-concurrency task pump). These
are asyncio-native rather than Task/TPL ports: the scheduler they cooperate
with is the event loop, not a custom thread pool.

The port's copy of ``orleans_tpu.core.asyncs``.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, Awaitable, Callable, TypeVar

log = logging.getLogger("orleans.async")

T = TypeVar("T")

__all__ = [
    "retry", "ExponentialBackoff", "BatchWorker", "AsyncSerialExecutor",
    "AsyncPipeline",
]


class ExponentialBackoff:
    """Jittered exponential backoff delays (``ExponentialBackoff`` struct)."""

    def __init__(self, min_delay: float = 0.05, max_delay: float = 5.0,
                 factor: float = 2.0, jitter: float = 0.2):
        self.min_delay = min_delay
        self.max_delay = max_delay
        self.factor = factor
        self.jitter = jitter

    def delay(self, attempt: int) -> float:
        base = min(self.max_delay, self.min_delay * (self.factor ** attempt))
        return base * (1.0 + self.jitter * (2 * random.random() - 1.0))


async def retry(
    fn: Callable[[int], Awaitable[T]] | Callable[[], Awaitable[T]],
    *,
    max_attempts: int = 5,
    backoff: ExponentialBackoff | None = None,
    retry_on: Callable[[Exception], bool] | type | tuple = Exception,
) -> T:
    """``AsyncExecutorWithRetries.ExecuteWithRetries``: run ``fn`` until it
    succeeds, retrying failures that match ``retry_on`` with backoff.

    ``fn`` may accept the attempt index (the reference passes the retry
    counter to the callable) or no arguments.
    """
    backoff = backoff or ExponentialBackoff()
    if isinstance(retry_on, (type, tuple)):
        exc_types = retry_on
        should_retry = lambda e: isinstance(e, exc_types)  # noqa: E731
    else:
        should_retry = retry_on
    import inspect
    # pass the attempt index only to callables with a REQUIRED positional
    # parameter — optional/keyword-only params (timeouts, partials) must not
    # silently receive the counter
    wants_attempt = any(
        p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                   inspect.Parameter.POSITIONAL_OR_KEYWORD)
        and p.default is inspect.Parameter.empty
        for p in inspect.signature(fn).parameters.values())
    last: Exception | None = None
    for attempt in range(max_attempts):
        try:
            return await (fn(attempt) if wants_attempt else fn())
        except Exception as e:  # noqa: BLE001 — filtered by should_retry
            last = e
            if not should_retry(e) or attempt == max_attempts - 1:
                raise
            await asyncio.sleep(backoff.delay(attempt))
    raise last  # pragma: no cover — loop always returns or raises


class BatchWorker:
    """Coalesced background work (``BatchWorker``/``BatchWorkerFromDelegate``):
    any number of ``notify()`` calls while a batch is running fold into
    exactly one more run of ``work`` afterwards. The pattern behind
    write-behind flushing, directory maintenance, and log-view workers."""

    def __init__(self, work: Callable[[], Awaitable[None]]):
        self._work = work
        self._more = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._task: asyncio.Task | None = None
        self._closed = False

    def notify(self) -> None:
        """Request (another) run of the work callback."""
        if self._closed:
            raise RuntimeError("BatchWorker is closed")
        self._more.set()
        self._idle.clear()
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        try:
            while self._more.is_set():
                self._more.clear()
                try:
                    await self._work()
                except Exception:  # noqa: BLE001 — worker survives failures
                    log.exception("BatchWorker work() failed")
        finally:
            if not self._more.is_set():
                self._idle.set()

    async def wait_idle(self) -> None:
        """Wait until all notified work has been executed
        (``WaitForCurrentWorkToBeServiced``)."""
        await self._idle.wait()

    async def notify_and_wait(self) -> None:
        self.notify()
        await self.wait_idle()

    def close(self) -> None:
        self._closed = True
        if self._task is not None and not self._task.done():
            self._task.cancel()


class AsyncSerialExecutor:
    """Serial, non-reentrant execution of queued closures
    (``AsyncSerialExecutor``): submissions run strictly one at a time in
    submission order, each submission's result awaitable by its caller."""

    def __init__(self) -> None:
        self._queue: asyncio.Queue[tuple[Callable, asyncio.Future]] = \
            asyncio.Queue()
        self._pump: asyncio.Task | None = None

    def submit(self, fn: Callable[[], Awaitable[T]]) -> "asyncio.Future[T]":
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._queue.put_nowait((fn, fut))
        if self._pump is None or self._pump.done():
            self._pump = asyncio.get_running_loop().create_task(self._run())
        return fut

    async def execute(self, fn: Callable[[], Awaitable[T]]) -> T:
        return await self.submit(fn)

    async def _run(self) -> None:
        while not self._queue.empty():
            fn, fut = self._queue.get_nowait()
            if fut.cancelled():
                continue
            try:
                result = await fn()
            except Exception as e:  # noqa: BLE001 — delivered to the caller
                if not fut.done():
                    fut.set_exception(e)
            else:
                if not fut.done():
                    fut.set_result(result)


class AsyncPipeline:
    """Bounded-concurrency task pump (``AsyncPipeline``): ``add`` blocks when
    ``capacity`` tasks are in flight — the backpressure primitive the
    reference uses for bulk storage/stream operations."""

    def __init__(self, capacity: int = 10):
        self.capacity = capacity
        self._sem = asyncio.Semaphore(capacity)
        self._tasks: set[asyncio.Task] = set()
        self._errors: list[Exception] = []

    async def add(self, coro: Awaitable[Any]) -> None:
        await self._sem.acquire()
        task = asyncio.get_running_loop().create_task(self._wrap(coro))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _wrap(self, coro: Awaitable[Any]) -> None:
        try:
            await coro
        except Exception as e:  # noqa: BLE001 — surfaced by wait_complete
            self._errors.append(e)
        finally:
            self._sem.release()

    async def wait_complete(self) -> None:
        """Drain the pipeline; raises the first captured error, if any."""
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        if self._errors:
            err = self._errors[0]
            self._errors.clear()
            raise err

    @property
    def count(self) -> int:
        return len(self._tasks)
