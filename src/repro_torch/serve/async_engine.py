"""Async streaming front end over the continuous-batching scheduler (the
port's counterpart of ``repro/serve/async_engine.py``).

``Scheduler`` is a synchronous host loop: each ``step()`` is one ragged
decode dispatch (plus admission / chunk prefills) with a single host sync.
``AsyncServeEngine`` wraps one scheduler in an asyncio drive loop, so
callers submit, stream, await and cancel requests concurrently while
generation proceeds:

  * the drive task owns stepping: while there is live or queued work it
    runs ``scheduler.step()`` in a worker thread (``asyncio.to_thread``), so
    the event loop stays responsive during the device work; when idle it
    parks on a wake event (new submissions set it);
  * a ``threading.Lock`` serializes every scheduler touch (step, submit,
    cancel): the scheduler itself is single-threaded by design;
  * streaming rides the scheduler's callback hooks: ``submit`` installs an
    ``on_token`` that forwards each committed token to a per-request
    ``asyncio.Queue`` via ``call_soon_threadsafe`` (the callback fires in
    the worker thread, mid-step) and an ``on_finish`` that closes the
    stream and resolves the request's future.  The order is the
    scheduler's commit order, i.e. exactly ``Completion.tokens``;
  * cancellation (``await cancel(idx)``) takes the lock in a worker thread
    (it may wait out the step in flight), then tears the request down
    through ``Scheduler.cancel``: its blocks return to the pool at once and
    its stream ends with a ``finish_reason='cancelled'`` completion.

Worker threads and the engine: gradient mode and the kernel backends are
per thread, and ``ServeEngine._with_backend`` sets both around every call,
so a step runs the engine's own routes on whichever worker runs it.  The
CUDA kernels are built (``kernels.build.library``) when the engine is
entered, before the first worker hop.

One engine serves one ``ServeConfig``; ``Request.priority`` and
``Request.arrival`` shape admission exactly as in synchronous serving —
the async layer adds concurrency, not policy.
"""
from __future__ import annotations

import asyncio
import threading
from typing import AsyncIterator, Callable, Dict, List, Optional

from repro_torch.serve.config import ServeConfig
from repro_torch.serve.scheduler import Completion, Request, Scheduler

_DONE = object()  # per-request stream terminator


class AsyncServeEngine:
    """Asyncio front end over one ``Scheduler`` (module docstring).

    Use as an async context manager::

        async with engine.serve_async(serve.ServeConfig(n_slots=4)) as srv:
            idx = srv.submit(Request(tokens=prompt, max_new_tokens=32))
            async for tok in srv.tokens(idx):
                ...
            comp = await srv.result(idx)

    ``scheduler`` is the wrapped (lock-protected) scheduler: tests reach its
    pool and stats through it; do not step it by hand while the engine is
    open."""

    def __init__(self, engine, config: Optional[ServeConfig] = None):
        config = (config or ServeConfig()).resolve(engine)
        if config.speculative is not None:
            from repro_torch.serve.speculative import SpeculativeScheduler

            self.scheduler: Scheduler = SpeculativeScheduler(engine, config)
        else:
            self.scheduler = Scheduler(engine, config)
        self.engine = engine
        self.config = config
        self._lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._queues: Dict[int, asyncio.Queue] = {}
        self._futures: Dict[int, asyncio.Future] = {}
        self._closed = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def __aenter__(self) -> "AsyncServeEngine":
        if self.engine.device.type == "cuda":
            from repro_torch.kernels import build

            await asyncio.to_thread(build.library)  # once per process; nvcc on first use
        self._loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._drive())
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        """Stop the drive task.  Unfinished requests stay in the scheduler
        (their streams simply stop advancing): cancel them first if their
        blocks should return to the pool."""
        self._closed = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self.scheduler._profile is not None:
            self.scheduler._profile.stop()  # idempotent; an armed window must not leak

    async def _drive(self) -> None:
        while not self._closed:
            with self._lock:
                work = bool(self.scheduler._n_live or self.scheduler._queue)
            if work:
                # one scheduler step per worker-thread hop: submissions and
                # cancellations interleave at step granularity
                await asyncio.to_thread(self._step_locked)
            else:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.05)
                except asyncio.TimeoutError:
                    pass

    def _step_locked(self) -> None:
        with self._lock:
            if self.scheduler._n_live or self.scheduler._queue:
                self.scheduler.step()

    # ------------------------------------------------------------------
    # request surface
    # ------------------------------------------------------------------
    def submit(self, req: Request, *, on_token: Optional[Callable[[int, int], None]] = None) -> int:
        """Enqueue a request; returns its index.  Tokens stream into
        ``tokens(idx)`` (and the optional extra ``on_token`` callback) as
        they are committed; ``result(idx)`` resolves with the Completion.
        Call from the event-loop thread the engine was entered on."""
        if self._loop is None:
            raise RuntimeError("AsyncServeEngine must be entered (async with) before submit")
        if self._closed:
            raise RuntimeError("AsyncServeEngine is closed")
        loop = self._loop
        q: asyncio.Queue = asyncio.Queue()
        fut: asyncio.Future = loop.create_future()

        def _tok(i: int, t: int) -> None:
            # fires in the worker thread mid-step; hop to the loop
            if on_token is not None:
                on_token(i, t)
            loop.call_soon_threadsafe(q.put_nowait, t)

        def _fin(comp: Completion) -> None:
            loop.call_soon_threadsafe(self._settle, comp)

        with self._lock:
            idx = self.scheduler.submit(req, on_token=_tok, on_finish=_fin)
        self._queues[idx] = q
        self._futures[idx] = fut
        self._wake.set()
        return idx

    def _settle(self, comp: Completion) -> None:
        self._queues[comp.index].put_nowait(_DONE)
        fut = self._futures[comp.index]
        if not fut.done():
            fut.set_result(comp)

    async def tokens(self, idx: int) -> AsyncIterator[int]:
        """Async-iterate request ``idx``'s tokens in commit order (exactly
        ``Completion.tokens``; a preemption replay delivers nothing again).
        Ends when the request finishes for any reason, cancellation
        included."""
        q = self._queues[idx]
        while True:
            item = await q.get()
            if item is _DONE:
                return
            yield item

    async def result(self, idx: int) -> Completion:
        """Await request ``idx``'s Completion."""
        return await self._futures[idx]

    async def cancel(self, idx: int) -> bool:
        """Cancel request ``idx`` (queued or live): its blocks return to the
        pool at once and its stream ends with a ``finish_reason='cancelled'``
        completion.  Runs in a worker thread: it may wait out the step in
        flight."""

        def _do() -> bool:
            with self._lock:
                return self.scheduler.cancel(idx)

        return await asyncio.to_thread(_do)

    async def drain(self) -> List[Completion]:
        """Await every submitted request; completions in submission order."""
        futs = [self._futures[i] for i in sorted(self._futures)]
        return list(await asyncio.gather(*futs)) if futs else []

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    @property
    def metrics(self):
        """The scheduler's ``MetricsRegistry``: snapshot(), to_prometheus()
        and to_json() are safe to call while serving (point-in-time reads of
        host numbers; a torn read across one step is the worst case)."""
        return self.scheduler.registry

    def timeline(self, idx: int) -> List:
        """Request ``idx``'s lifecycle timeline so far: the live (event,
        step) records of a request in flight, or the sealed
        ``Completion.timeline`` once it finished.  Taken under the scheduler
        lock, so it never shows a half-committed step."""
        with self._lock:
            tl = self.scheduler._timelines.get(idx)
            if tl is not None:
                return list(tl)
            comp = self.scheduler._completions.get(idx)
            return list(comp.timeline) if comp is not None else []
