"""The traced slice of a ``--trace 1`` run: torch.profiler over a bounded,
steady stretch of CG iterations, and its reduction to the device's busy
time, kernel time by name and idle time by what the host was doing.

The slice runs after the window and after the peak memory is read, on
one more problem (the window's first), with CG capped just past the
slice, so that the window's own problems and their spans carry no
profiler. It is set in the cell's ``workloads/<cell>.json`` under
``trace``: ``target`` is the dotted name of the program's CG function,
``argument`` the keyword of the callable it is handed whose calls are
counted (the preconditioner, once per iteration), and the profiler runs
from call ``start`` to call ``start + calls``, both ends after a device
synchronize. The wrapper changes no argument and no result.

On the card only CUDA activity is recorded, which slows the host less
than recording every operator; the idle time is summed by what the host
was doing, as far as the profiler's host events say, or else by the
kernel the gap follows. Where the target is never called the
slice is None and the readers of the trace return nothing.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Slice:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]     # (name, seconds), longest first
    gaps: List[Tuple[str, float]]        # (label, idle seconds), most first

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.kernels[:TOP]],
                "idle_gaps": [[n, s] for n, s in self.gaps[:TOP]]}


def reduce_events(events) -> Optional[Slice]:
    """Busy time, kernel time by name and idle time by label of the
    profiler's events (times in microseconds), over the span from the
    first event's start to the last one's end. An idle gap is labelled by
    the host event under its middle, or else "after <kernel>", the kernel
    it follows; the gaps' seconds are summed by label."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False):
            continue
        iv = (e.time_range.start, e.time_range.end, e.name[:NAME_CHARS])
        (dev if e.device_type == DeviceType.CUDA else host).append(iv)
    if not dev and not host:
        return None
    t0 = min(a for a, _, _ in dev + host)
    t1 = max(b for _, b, _ in dev + host)
    per_name = defaultdict(float)
    for a, b, n in dev:
        per_name[n] += (b - a) * 1e-6
    host.sort()
    starts = [h[0] for h in host]

    def label(a, b, after):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        under = [h for h in host[max(0, i - 64):i] if h[1] >= mid]
        if under:
            return min(under, key=lambda h: h[1] - h[0])[2]
        return f"after {after}" if after else "before the first kernel"

    idle = defaultdict(float)
    busy, end, last = 0.0, t0, None
    for a, b, n in sorted(dev):
        if a > end:
            idle[label(end, a, last)] += (a - end) * 1e-6
        if b > end:
            busy += b - max(a, end)
            end, last = b, n
    if t1 > end:
        idle[label(end, t1, last)] += (t1 - end) * 1e-6
    return Slice((t1 - t0) * 1e-6, busy * 1e-6,
                 sorted(per_name.items(), key=lambda kv: -kv[1]),
                 sorted(idle.items(), key=lambda kv: -kv[1]))


class SliceTracer:
    """Profiles calls ``start`` .. ``start + calls`` of the callable
    ``argument`` handed to ``target``."""

    def __init__(self, device, target: str, argument: str, start: int,
                 calls: int):
        self.device = device
        self.target, self.argument = target, argument
        self.start, self.calls = start, calls

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profile(self, run_problem) -> Optional[Slice]:
        """Call ``run_problem(max_iter)`` with the target wrapped and CG
        capped past the slice; returns the slice."""
        from torch.profiler import ProfilerActivity, profile
        module_name, attr = self.target.rsplit(".", 1)
        module = importlib.import_module(module_name)
        original = getattr(module, attr)
        acts = [ProfilerActivity.CUDA] if self.device.type == "cuda" \
            else [ProfilerActivity.CPU]
        prof = profile(activities=acts)
        state = {"n": 0, "on": False, "done": False}

        def stop():
            if state["on"]:
                self._sync()
                prof.stop()
                state["on"], state["done"] = False, True

        def counted(fn):
            def call(*a, **kw):
                if state["n"] == self.start and not state["done"]:
                    self._sync()
                    prof.start()
                    state["on"] = True
                elif state["n"] == self.start + self.calls:
                    stop()
                state["n"] += 1
                return fn(*a, **kw)
            return call

        def wrapper(*a, **kw):
            if kw.get(self.argument) is not None:
                kw[self.argument] = counted(kw[self.argument])
            try:
                return original(*a, **kw)
            finally:
                stop()

        setattr(module, attr, wrapper)
        try:
            run_problem(self.start + self.calls + 1)
        finally:
            setattr(module, attr, original)
            stop()
        if not state["done"]:
            return None
        return reduce_events(prof.events())
