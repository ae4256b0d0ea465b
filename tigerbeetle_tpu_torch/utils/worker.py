"""Serial background worker on a daemon thread.

This package's own copy of ``tigerbeetle_tpu/utils/worker.py``.

A minimal stand-in for ThreadPoolExecutor(max_workers=1) whose thread
is a DAEMON: replicas and grids are constructed/discarded freely in
crash-recovery loops and fuzz harnesses, and must not leak non-daemon
threads that pin the process (or the storage objects) alive.
"""

from __future__ import annotations

import queue
import threading


class _Job:
    __slots__ = ("fn", "args", "_done", "_exc")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args
        self._done = threading.Event()
        self._exc: BaseException | None = None

    def result(self) -> None:
        self._done.wait()
        if self._exc is not None:
            raise self._exc


class SerialWorker:
    """FIFO execution of submitted jobs on one daemon thread.

    `close()` stops the thread (idempotent); owners should either call
    it or register it with `weakref.finalize` so discarded owners
    (replicas/grids in crash-recovery loops) reclaim their thread
    instead of leaking one blocked in q.get() per construction."""

    _STOP = object()

    def __init__(self, name: str) -> None:
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, fn, *args) -> _Job:
        assert not self._closed, "submit on closed SerialWorker"
        job = _Job(fn, args)
        self._q.put(job)
        return job

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(self._STOP)

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is self._STOP:
                return
            try:
                job.fn(*job.args)
            # tbcheck: allow(broad-except): the worker thread must
            # survive any job failure — the exception is stored and
            # re-raised at job.result() on the submitting thread.
            except BaseException as e:
                job._exc = e
            finally:
                job._done.set()
