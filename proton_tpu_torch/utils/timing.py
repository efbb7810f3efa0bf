"""Timing and phase reporting (JAX counterpart:
proton_tpu/utils/timing.py; reference timecounter, utils.hpp:241-287,
and the coloured phase lines of the apps).

The device runs asynchronously, so a stopwatch around device work must
wait for it: ``toc`` synchronizes the device of the tensor it is given.
The JAX module's ``phase`` context manager, which nothing calls, is not
ported; ``span`` records the program's spans into a dict instead.

Spans. A solve makes its ``timings`` dict the sink of every span opened
while it runs (``with sink(timings):``); a context variable holds it, so
the spans deep in CG and the V-cycle need no argument. A span named
``x`` adds to the sink

- ``x_s``: its host seconds, ended by a synchronize of ``device`` where
  the span is given one (the phases); without one it is the host's
  enqueue time, and the span adds no wait;
- ``x_self_s``: those seconds less what its child spans cover (the spans
  opened inside it in the same sink);
- ``x_calls``: 1.

A counter, ``count(name, value)``, adds ``value`` to ``name`` in the
active sink, and writes nothing where no sink is set.

While a torch profiler runs, and only then, a span is also a
``torch.profiler.record_function`` range of its name, so it sits on the
profiler's clock around the work it launches. With no sink and no
profiler a span costs a flag read and the sink lookup.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from ..config import synchronize


def _sync(value) -> None:
    """Wait for the device of ``value`` (a tensor, or a tuple/list of
    them) to finish its queued work."""
    if isinstance(value, torch.Tensor):
        synchronize(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _sync(v)


class TimeCounter:
    """tic()/toc() stopwatch; prints seconds like the reference's
    operator<< (utils.hpp:281-287)."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def tic(self):
        self._start = time.perf_counter()
        return self

    def toc(self, sync_value=None):
        if sync_value is not None:
            _sync(sync_value)
        self._elapsed = time.perf_counter() - self._start
        return self._elapsed

    def to_double(self):
        return self._elapsed

    def __str__(self):
        return f"{self._elapsed:.6g}"


def _wrap(code):
    def f(s):
        return f"\x1b[{code}m{s}\x1b[0m" if sys.stdout.isatty() else str(s)
    return f


# ANSI manipulators (utils.hpp:295-374)
red = _wrap(31)
green = _wrap(32)
yellow = _wrap(33)
blue = _wrap(34)
magenta = _wrap(35)
cyan = _wrap(36)
bold = _wrap(1)


class _Sink:
    """A timings dict and the stack of the spans open in it."""

    __slots__ = ("timings", "open")

    def __init__(self, timings: dict):
        self.timings = timings
        self.open = []


_SINK: ContextVar[Optional[_Sink]] = ContextVar("proton_tpu_torch_span_sink",
                                                default=None)


@contextmanager
def sink(timings: Optional[dict]):
    """Make ``timings`` the sink of the spans opened in the block; None:
    they record nothing there. Installing the dict that is already the
    sink changes nothing, so a phase function handed its caller's dict
    nests its spans under the caller's open ones."""
    active = _SINK.get()
    if active is not None and active.timings is timings:
        yield
        return
    token = _SINK.set(None if timings is None else _Sink(timings))
    try:
        yield
    finally:
        _SINK.reset(token)


class span:
    """``with span(name[, device]):`` records the block into the active
    sink (the module docstring); ``device``: synchronize it before the
    block's end is read. A block that raises records nothing."""

    __slots__ = ("name", "device", "_sink", "_range", "_t0", "_inner")

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device

    def __enter__(self):
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._sink = s = _SINK.get()
        if s is not None:
            s.open.append(self)
            self._inner = 0.0
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        s = self._sink
        if s is not None:
            s.open.pop()
            if exc_type is None:
                if self.device is not None:
                    synchronize(self.device)
                dt = time.perf_counter() - self._t0
                if s.open:
                    s.open[-1]._inner += dt
                t, name = s.timings, self.name
                t[name + "_s"] = t.get(name + "_s", 0.0) + dt
                t[name + "_self_s"] = t.get(name + "_self_s", 0.0) + \
                    dt - self._inner
                t[name + "_calls"] = t.get(name + "_calls", 0) + 1
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        return False


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` of the active sink (the
    module docstring); nothing where no sink is set."""
    s = _SINK.get()
    if s is not None:
        s.timings[name] = s.timings.get(name, 0) + value
