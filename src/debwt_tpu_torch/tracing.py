"""One recorder for the port's stages: profiler spans, host seconds and
counts, shared by every tier.

  span(name, label)  a torch.profiler.record_function range named
                     "debwt.<name>", so that the stage sits on the clock
                     of a device trace; where `label` is given, its host
                     seconds (perf_counter) are added to timings[label].
                     It never synchronizes the device, and with no
                     profiler on it costs a few microseconds.
  wait(name, fn)     a blocking device-to-host fetch, fn(), inside the
                     span "debwt.<name>.wait"; counts one sync, and the
                     bytes of a tensor it returns as d2h_bytes.
  count(name, n)     adds n to counters[name].
  mark(label, dev)   the grouped, out-of-core and multi-device tiers'
                     sequential stage marks: synchronizes a CUDA device,
                     then adds the seconds since the last mark (or the
                     recording's start) to timings[label].

What these record goes to every recording open on the calling thread:
a recording (`recording()`, or a function decorated `recorded`) holds
one build's `timings` and `counters`, which BwtResult carries; the
CLI's own recording, around the job, sees its ingest, its build's
stages and its writer together. With no recording open, spans still
reach the profiler and nothing else is kept.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

PREFIX = "debwt."

_local = threading.local()


class Recorder:
    """The timings and counters of one recording."""

    def __init__(self, timings: dict | None = None,
                 counters: dict | None = None):
        self.timings = {} if timings is None else timings
        self.counters = {} if counters is None else counters
        self.last_mark = time.perf_counter()


def _open() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Recorder | None:
    """The innermost recording open on this thread."""
    stack = _open()
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording(timings: dict | None = None, counters: dict | None = None):
    """A recording over `timings` and `counters` (new dicts by default)
    for the duration of the block."""
    rec = Recorder(timings, counters)
    stack = _open()
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.pop()


def recorded(fn):
    """Runs each call of fn inside a recording of its own; fn reads it
    with current()."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with recording():
            return fn(*args, **kwargs)
    return run


def add(label: str, seconds: float) -> None:
    for rec in _open():
        rec.timings[label] = rec.timings.get(label, 0.0) + seconds


def count(name: str, n: int = 1) -> None:
    for rec in _open():
        rec.counters[name] = rec.counters.get(name, 0) + int(n)


@contextlib.contextmanager
def span(name: str, label: str | None = None):
    with torch.profiler.record_function(PREFIX + name):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
    if label is not None:
        add(label, dt)


def wait(name: str, fn):
    with span(f"{name}.wait"):
        out = fn()
    count("syncs")
    if isinstance(out, torch.Tensor):
        count("d2h_bytes", out.numel() * out.element_size())
    return out


def mark(label: str, device: torch.device | None = None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    rec = current()
    now = time.perf_counter()
    add(label, now - rec.last_mark)
    rec.last_mark = now
