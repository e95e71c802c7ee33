"""The program's own spans and counters, on the profiler's clock.

Recording is on exactly while a ``torch.profiler`` records: the profile an
operator takes, or the benchmark's traced slice. There is no other switch.

Off, :func:`span` returns one shared no-op context, :func:`count` returns at
once and :func:`held` returns the lock it was given: none of them allocates,
reads a clock, launches on the device or waits for it.

On, a span records its name, its start and end from ``time.time_ns()``
(the Unix-epoch nanoseconds the profiler stamps its events with), its thread
(``threading.get_native_id()``), its parent (the span open on that thread
when it started), its frame id (given, else its parent's) and
its attributes. A counter adds to the innermost span open on its thread, or
is recorded alone when none is. Nothing here calls ``record_function``, and
nothing reads a device value: a span sees only what the host already holds.

Records stay in memory, the newest :data:`MAX_RECORDS`: :func:`records`
returns them, :func:`clear` empties the buffer. Each record is a dict with
``id``, ``name``, ``frame``, ``start_ns``, ``end_ns``, ``thread``,
``parent`` (an ``id`` or None), ``attrs`` and ``counters``.

Spans, outermost first: ``frame.dispatch`` (a frame's device half; its
frame id is ``SLAM.frame_count``), ``frame.preprocess`` (the frame's upload
and resize launches, or the host normalise of a frame at the network shape),
``model.encode``, ``tracker.track_step``, ``model.decode``,
``frame.finalize`` (the flags fetch and bookkeeping; parent of an inline
backend task), ``backend.task`` (attributes ``kf``, ``cause``: the frame
that made the keyframe, ``queued_ns``: when a threaded task was queued) with
its children ``backend.snapshot``, ``backend.pairs``, ``backend.window``,
``backend.solve_rays`` / ``backend.solve_calib`` and ``backend.merge``.
Counters: ``tracker.gn_iters`` (the tracking Gauss-Newton's iterations,
each ending in one host fetch), ``frame.lock_wait_ns`` (the frontend's
waits for ``SLAM._backend_lock``), ``backend.lock_wait_ns`` (a backend
task's), ``model.rope_launches`` (the RoPE kernel's launches in one
``encode_image`` or ``decode``, by the calling thread: one an attention on
the card, 0 on the CPU), ``backend.solve_iters`` (a window solve's
Gauss-Newton iterations, each ending in one host fetch),
``backend.calib_launches`` (the calibrated edge kernel's launches in one
calibrated solve: one an iteration and edge part on the card, 0 on the
CPU), ``backend.step_replays`` and ``backend.step_captures`` (a window
solve's CUDA graph replays and captures of its GN step: a replay an
iteration at a window shape met before, 0 on the CPU and for windows with
odometry rows or split edge rows).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 16

_records: deque = deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The shared span of a program that is not being profiled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _record(name, frame, start_ns, end_ns, parent, attrs, counters, ident=None):
    _records.append({"id": next(_ids) if ident is None else ident, "name": name, "frame": frame,
                     "start_ns": start_ns, "end_ns": end_ns, "thread": threading.get_native_id(),
                     "parent": parent, "attrs": attrs, "counters": counters})


class _Span:
    __slots__ = ("name", "frame", "attrs", "counters", "id", "parent", "start_ns")

    def __init__(self, name, frame, attrs):
        self.name, self.frame, self.attrs, self.counters = name, frame, attrs, {}

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        if self.frame is None and top is not None:
            self.frame = top.frame
        self.parent = None if top is None else top.id
        self.id = next(_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _record(self.name, self.frame, self.start_ns, end, self.parent, self.attrs, self.counters, self.id)
        return False


def span(name: str, frame=None, **attrs):
    """A context that records ``name`` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, frame, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n
    else:
        t = time.time_ns()
        _record(name, None, t, t, None, {}, {name: n})


class _Held:
    __slots__ = ("lock", "counter")

    def __init__(self, lock, counter):
        self.lock, self.counter = lock, counter

    def __enter__(self):
        t0 = time.time_ns()
        self.lock.acquire()
        count(self.counter, time.time_ns() - t0)
        return self.lock

    def __exit__(self, *exc):
        self.lock.release()
        return False


def held(lock, counter: str):
    """``lock`` as a context; while a profiler records, the nanoseconds
    spent taking it are added to counter ``counter``."""
    if not _profiler._is_profiler_enabled:
        return lock
    return _Held(lock, counter)


def stamp():
    """``time.time_ns()`` while a profiler records, else None."""
    return time.time_ns() if _profiler._is_profiler_enabled else None


def records() -> list:
    return list(_records)


def clear():
    _records.clear()
