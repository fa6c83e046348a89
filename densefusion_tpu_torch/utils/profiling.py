"""Profiling hooks: ``torch.profiler`` traces and the port's spans
(counterpart of ``densefusion_tpu/utils/profiling.py``).

:func:`trace_context` captures any region, CPU and (where there is a card)
CUDA activity, as a TensorBoard trace.

:func:`span` marks a region of the program at a layer boundary (the
serving request, the pipeline's stages, the model's, the training step's).
It records only while a ``torch.profiler`` session is active, such as
:func:`trace_context`'s or a benchmark's: then each span shows in the
trace as a ``record_function`` range, and is also kept in memory, on the
profiler's clock, for :func:`spans` to return. With no session, a span
records nothing and costs under a microsecond.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_CAPACITY = 4096
"""The most recent spans :func:`spans` keeps; older ones are dropped."""

_RECORDS: collections.deque = collections.deque(maxlen=SPAN_CAPACITY)
_IDS = itertools.count(1)
_LOCAL = threading.local()     # this thread's stack of open spans
_OFF: dict = {}                # (name, units) -> the no-op they share
_OFF_KEPT = 1024


class _Off:
    """What :func:`span` returns while nothing profiles: it records
    nothing. As a decorator it opens ``span(name, units)`` at each call."""

    __slots__ = ("name", "units")

    def __init__(self, name: str, units=None):
        self.name, self.units = name, units

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name, units = self.name, self.units

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name, units):
                return fn(*args, **kwargs)

        return wrapped


class _Span(_Off):
    """One recorded span. Its host interval is ``time.time_ns()`` at enter
    and exit, the clock ``torch.profiler`` stamps its events with; where
    CUDA is in use, a pair of timing events on the current stream gives its
    device time once the stream has passed both."""

    __slots__ = ("id", "parent", "request", "t0_ns", "t1_ns", "error",
                 "device_ms", "_events", "_range")

    def __enter__(self):
        stack = _stack()
        self.id = next(_IDS)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self.error = self.device_ms = self._events = None
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0_ns = time.time_ns()
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._events is not None:
            self._events[1].record()
        self.t1_ns = time.time_ns()
        self._range.__exit__(exc_type, exc, tb)
        self._range = None
        if exc_type is not None:
            self.error = repr(exc)
        _stack().pop()
        _RECORDS.append(self)
        return False

    def as_dict(self) -> dict:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms, self._events = start.elapsed_time(end), None
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "t0_ns": self.t0_ns,
                "t1_ns": self.t1_ns, "units": self.units,
                "error": self.error, "device_ms": self.device_ms}


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, units=None):
    """A context manager (or decorator) that marks one region as a span
    named ``name``; ``units`` is the work it holds (detections, samples).

    While a ``torch.profiler`` session is active, and the code is not being
    compiled or exported, the region is a ``record_function`` range of the
    trace and a record of :func:`spans`: its id, its ``parent`` (the
    enclosing span on this thread) and ``request`` (the outermost one's
    id), its host interval on the profiler's clock, ``units``, the error
    the region raised and, where CUDA is in use, its device time.
    Otherwise it is a no-op, shared by the spans of one name and
    ``units``."""
    if torch.compiler.is_compiling():
        # a fresh no-op: dynamo enters only a context made in traced code
        return _Off(name, units)
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, units)
    off = _OFF.get((name, units))
    if off is None:
        off = _Off(name, units)
        if len(_OFF) < _OFF_KEPT:
            _OFF[name, units] = off
    return off


def spans() -> list[dict]:
    """The kept spans, oldest first, each a dict of ``name``, ``id``,
    ``parent``, ``request``, ``t0_ns``, ``t1_ns`` (``time.time_ns()``),
    ``units``, ``error`` and ``device_ms`` (None without CUDA). A span's
    device time is read here: it waits for the stream to pass the span's
    end, so read once the work is done."""
    return [s.as_dict() for s in list(_RECORDS)]


def clear_spans() -> None:
    """Drop every kept span."""
    _RECORDS.clear()


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A ``torch.profiler`` trace of the region (CPU activity, and CUDA's
    where this build has it), written into ``log_dir`` as
    ``<worker>.<time>.pt.trace.json``, which TensorBoard's profiler plugin
    and ``chrome://tracing`` read; a no-op when ``log_dir`` is None. The
    port's spans (:func:`span`) show in it as ``record_function`` ranges,
    and are kept in memory (:func:`spans`) while it runs."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (
        ProfilerActivity, profile, supported_activities,
        tensorboard_trace_handler,
    )

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
