"""TaskExecutor: supervised async task spawning with shutdown + metrics.

Twin of common/task_executor/src/lib.rs:72-379 (`spawn` :169,
`spawn_blocking` :207, shutdown signalling :374, per-task metrics): an
asyncio wrapper where every service task is named, counted, and cancelled
as a group on shutdown; blocking work is pushed onto a thread pool so the
event loop (the tokio runtime analog) never stalls on device marshaling or
disk IO.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading
from typing import Any, Callable, Coroutine

from .metrics import (
    TASKS_ABANDONED,
    TASKS_RESTARTED,
    Counter,
    Gauge,
)

TASKS_STARTED = Counter("executor_tasks_started", "Tasks spawned, by name")
TASKS_ENDED = Counter("executor_tasks_ended", "Tasks finished, by name")
TASKS_ACTIVE = Gauge("executor_tasks_active", "Currently running tasks")


class ShutdownReason:
    def __init__(self, reason: str, failure: bool = False):
        self.reason = reason
        self.failure = failure

    def __repr__(self):
        kind = "failure" if self.failure else "success"
        return f"ShutdownReason({self.reason!r}, {kind})"


class TaskExecutor:
    def __init__(self, loop: asyncio.AbstractEventLoop | None = None,
                 max_blocking_threads: int = 8):
        self._loop = loop
        self._tasks: set[asyncio.Task] = set()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_blocking_threads, thread_name_prefix="blocking"
        )
        self._shutdown = asyncio.Event()
        self._shutdown_reason: ShutdownReason | None = None
        self._lock = threading.Lock()

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop or asyncio.get_event_loop()

    def spawn(self, coro: Coroutine, name: str) -> asyncio.Task:
        """Supervised fire-and-forget (task_executor spawn :169)."""
        task = self.loop.create_task(coro, name=name)
        TASKS_STARTED.inc(labels=(name,))
        TASKS_ACTIVE.inc()
        with self._lock:
            self._tasks.add(task)

        def done(t: asyncio.Task):
            with self._lock:
                self._tasks.discard(t)
            TASKS_ENDED.inc(labels=(name,))
            TASKS_ACTIVE.dec()
            if not t.cancelled() and t.exception() is not None:
                self.shutdown(f"task {name} panicked: {t.exception()!r}",
                              failure=True)

        task.add_done_callback(done)
        return task

    def spawn_supervised(
        self,
        factory: Callable[[], Coroutine],
        name: str,
        max_restarts: int = 5,
        backoff: float = 0.1,
        backoff_factor: float = 2.0,
        max_backoff: float = 30.0,
    ) -> asyncio.Task:
        """Supervised service task WITH restart: a crash restarts the
        coroutine (rebuilt via ``factory``) after an exponential backoff,
        up to ``max_restarts``; only exhausting the cap escalates to the
        failure shutdown that plain :meth:`spawn` triggers on the first
        crash.  A normal return ends supervision.

        The long-running services a node cannot live without (gossip
        pumps, the scheduler manager loop) ride this instead of ``spawn``
        so one transient exception — device hiccup, socket error, an
        injected ``executor.task.<name>`` fault — degrades to a restart
        counter instead of taking the process down.
        """

        async def supervisor():
            from . import faults

            attempt = 0
            delay = backoff
            while True:
                try:
                    faults.fire(f"executor.task.{name}")
                    await factory()
                    return  # clean completion: supervision over
                except asyncio.CancelledError:
                    raise  # shutdown path, not a crash
                except Exception as exc:  # noqa: BLE001 — any crash
                    attempt += 1
                    if attempt > max_restarts:
                        TASKS_ABANDONED.inc(labels=(name,))
                        self.shutdown(
                            f"task {name} crashed {attempt} times "
                            f"(last: {exc!r}); restart cap exhausted",
                            failure=True,
                        )
                        return
                    TASKS_RESTARTED.inc(labels=(name,))
                    await asyncio.sleep(delay)
                    delay = min(delay * backoff_factor, max_backoff)

        return self.spawn(supervisor(), name)

    async def spawn_blocking(self, fn: Callable[..., Any], *args, name: str = "?"):
        """Run CPU/disk-bound work on the thread pool (spawn_blocking :207)
        — device marshaling, hashing, store IO."""
        TASKS_STARTED.inc(labels=(name,))
        try:
            return await self.loop.run_in_executor(self._pool, fn, *args)
        finally:
            TASKS_ENDED.inc(labels=(name,))

    def shutdown(self, reason: str, failure: bool = False) -> None:
        """Signal shutdown (idempotent); tasks are cancelled by wait()."""
        if self._shutdown_reason is None:
            self._shutdown_reason = ShutdownReason(reason, failure)
        self._shutdown.set()

    async def wait_for_shutdown(self) -> ShutdownReason:
        await self._shutdown.wait()
        with self._lock:
            tasks = list(self._tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._pool.shutdown(wait=False, cancel_futures=True)
        return self._shutdown_reason or ShutdownReason("unknown")

    @property
    def active_tasks(self) -> int:
        with self._lock:
            return len(self._tasks)
