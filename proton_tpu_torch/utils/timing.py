"""Timing and phase reporting (JAX counterpart:
proton_tpu/utils/timing.py; reference timecounter, utils.hpp:241-287,
and the coloured phase lines of the apps).

The device runs asynchronously, so a stopwatch around device work must
wait for it: ``toc`` synchronizes the device of the tensor it is given.
The JAX module's ``phase`` context manager, which nothing calls, is not
ported; ``timed`` records phase seconds into a dict instead.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Optional

import torch

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


@contextmanager
def timed(timings: Optional[dict], name: str, device):
    """Add the block's seconds to ``timings[name]`` (so a phase run once
    per item of a loop sums), the device synchronized at its end; a no-op
    when ``timings`` is None."""
    if timings is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0

