"""Spans: named intervals of the train step, on the host's clock and on the
device's.

A span records something only while a `torch.profiler` session records
(`torch.autograd.profiler._is_profiler_enabled`, a Python global that every
session sets while it records). Otherwise `span` reads that global once and
returns one shared context that does nothing, and `mark_backward` registers
no hook. There is no other switch.

While a session records, each span appends one record: its name, the index
of the enclosing span's record (-1 at the top), the step (the `step` spans
opened so far in the session, less one), its host interval by
`time.time_ns()` (the clock on which kineto stamps its events, so a span's
interval and the profiler's host events line up), and two device marks, CUDA
events recorded on the current stream at open and close: they bracket
exactly the work launched inside the span. Off the card the device marks
are host-clock readings. `records()` places the marks on the host clock
through one anchor event that the session's first span records, beside the
host time at which its record call returned; where the card is idle at that
point, as after a synchronise, the anchor is off by less than one launch
latency. A span's host open is read just before its open event is recorded,
so where the card waits for the host, the event's device time less that
reading is near zero. Each span also enters
`torch.profiler.record_function(name)`, so that a trace with CPU activity
(the trainers' `--profile`) shows it above the kernels it launched. Events
come from a pool that later sessions reuse.

The backward runs the model's segments in reverse, on autograd's own thread
on the card. `backward_segments(first)` opens `<first>.bwd` around the
backward; `mark_backward(x, name)`, called in the forward on a tensor that
ends a segment, registers a hook on `x` that closes the open backward
segment and opens `<name>.bwd` once the gradient of `x` is complete. The
segments' events are recorded on the stream of the thread that runs the
hook. The hooks leave the gradients as they are, so a step's loss,
parameters, moments and EMA trees are the same bit for bit with spans on and
off. Under `--remat` the forward recomputed in the backward lies inside the
backward segments.

A new profiler session starts with no records (`reset`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
#: CUDA events reused by every session, in the order a session takes them
_POOL: List[torch.cuda.Event] = []


@dataclasses.dataclass(frozen=True)
class Record:
    name: str
    parent: int                              # the enclosing span's index, -1 at the top
    step: int                                # `step` spans opened before it, less one
    host_ns: Tuple[int, Optional[int]]       # (open, close) by time.time_ns()
    device_ns: Optional[Tuple[int, int]]     # (open, close) on the host clock; None open
    on_card: bool                            # device marks are CUDA events


class _Session:
    """The records of one profiler session. A row is [name, parent, step,
    host open, host close, mark open, mark close, record_function]."""

    def __init__(self):
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.rows: list = []
        self.stack: List[int] = []
        self.step = -1
        self.used = 0
        self.bwd: Optional[List[int]] = None     # [parent, open row] in a backward
        self.anchor = None
        if self.cuda:
            # the host time after the record returned: the card cannot have
            # reached the event before then, less one launch latency
            self.anchor = (self.mark()[0], time.time_ns())

    def event(self) -> torch.cuda.Event:
        """The pool's next event. A new one is recorded at once, which creates
        it, so that its creation delays no later reading of the clock."""
        if self.used == len(_POOL):
            _POOL.append(torch.cuda.Event(enable_timing=True))
            _POOL[-1].record()
        self.used += 1
        return _POOL[self.used - 1]

    def mark(self):
        """(a device mark, the host time just before it was recorded)."""
        if not self.cuda:
            t = time.time_ns()
            return t, t
        ev = self.event()
        t = time.time_ns()
        ev.record()
        return ev, t

    def open(self, name: str, parent: int) -> int:
        rf = _profiler.record_function(name)
        rf.__enter__()
        mark, host = self.mark()
        self.rows.append([name, parent, self.step, host, None, mark, None, rf])
        return len(self.rows) - 1

    def close(self, i: int) -> None:
        row = self.rows[i]
        row[6] = self.mark()[0]
        row[4] = time.time_ns()
        row[7].__exit__(None, None, None)
        row[7] = None

    def switch(self, name: str) -> None:
        """Close the open backward segment and open `name` in its place."""
        parent, i = self.bwd
        self.close(i)
        self.bwd[1] = self.open(name, parent)

    def place(self, mark) -> int:
        if not self.cuda:
            return mark
        ev, host = self.anchor
        return host + round(ev.elapsed_time(mark) * 1e6)


_current: Optional[_Session] = None


def _session() -> _Session:
    global _current
    if _current is None:
        _current = _Session()
    return _current


class _Span:
    __slots__ = ("name", "s", "i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        s = self.s = _session()
        if self.name == "step":
            s.step += 1
        self.i = s.open(self.name, s.stack[-1] if s.stack else -1)
        s.stack.append(self.i)

    def __exit__(self, *exc):
        self.s.stack.pop()
        self.s.close(self.i)


class _Backward:
    __slots__ = ("first", "s")

    def __init__(self, first: str):
        self.first = first

    def __enter__(self):
        s = self.s = _session()
        parent = s.stack[-1] if s.stack else -1
        s.bwd = [parent, s.open(self.first + ".bwd", parent)]

    def __exit__(self, *exc):
        s = self.s
        s.close(s.bwd[1])
        s.bwd = None


def span(name: str):
    """A context that records the span `name` while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def backward_segments(first: str):
    """A context around `loss.backward()`: the backward segment `<first>.bwd`
    opens on entry, the one open last closes on exit."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Backward(first)


def mark_backward(x: torch.Tensor, name: str) -> None:
    """Where the gradient of `x` is complete, the backward of segment `name`
    (the one that produced `x`) starts."""
    if not _profiler._is_profiler_enabled or not x.requires_grad:
        return
    s, label = _session(), name + ".bwd"

    def hook(grad):
        if s.bwd is not None:
            s.switch(label)

    x.register_hook(hook)


def records() -> List[Record]:
    """The records of the current (or last) profiler session, in the order
    the spans opened; on the card after a synchronise."""
    s = _current
    if s is None:
        return []
    if s.cuda:
        torch.cuda.synchronize()
    return [Record(name, parent, step, (h0, h1),
                   None if m1 is None else (s.place(m0), s.place(m1)), s.cuda)
            for name, parent, step, h0, h1, m0, m1, _ in s.rows]


def reset() -> None:
    """Drop the records; the next span starts a new session."""
    global _current
    _current = None


def _on_profiler_start(start=_profiler._run_on_profiler_start) -> None:
    start()
    reset()


# every profiler session announces its start through this module function
_profiler._run_on_profiler_start = _on_profiler_start
