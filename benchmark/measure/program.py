"""What the readers of the program's own spans share.

debwt_tpu_torch names its stages with record_function ranges that start
with "debwt." (its tracing.py). `spans(w)` gives them as (name, start,
end) in seconds from the traced window's start, from the same profiler
events that measure/trace.py's reduce reads: Trace keeps only the
starts of host events (host_ops), and a stage's end is needed here, so
the events are read once more from the finished profile. The harness
holds that profile in the frame of run_cell, which calls each reader
with the Window; Window does not carry it, so it is found there, by its
type. The list is kept on the Trace as `program`, and a Trace that
already has one (a hand-made one) is read as it is.

Each number here is a mean over the window's builds. Where the program
opens no such span (a program without them), every reader returns None.
"""

from __future__ import annotations

import sys

from benchmark.measure.trace import WINDOW_SPAN, _ns

PREFIX = "debwt."
# the spans that open a call into the program: api.build,
# BwtResult.packed() and cli.main
ROOTS = ("debwt.build", "debwt.pack", "debwt.cli")


def _profile():
    """The finished torch.profiler.profile held by a calling frame, or
    None."""
    import torch

    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, torch.profiler.profile):
                return v
        f = f.f_back
    return None


def reduce(prof) -> list:
    """(name, start, end) of the profile's host events named "debwt.*",
    in seconds from the start of its bench.window span (no span: [])."""
    from torch.autograd import DeviceType

    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    win = [e for e in events if e.name() == WINDOW_SPAN]
    if not win:
        return []
    t0 = _ns(win[0], "start")
    return [(e.name(), (_ns(e, "start") - t0) / 1e9,
             (_ns(e, "end") - t0) / 1e9)
            for e in events if e.name().startswith(PREFIX)]


def spans(w) -> list:
    """The program's spans in the traced window ([] where none)."""
    if w.trace is None:
        return []
    got = getattr(w.trace, "program", None)
    if got is None:
        prof = _profile()
        got = w.trace.program = reduce(prof) if prof is not None else []
    return got


def _builds(w) -> int:
    return len(w.builds) if w.trace is not None else 0


def stage_seconds(w, name: str):
    """Seconds a build of the spans named `name`."""
    if not _builds(w):
        return None
    got = [e - s for n, s, e in spans(w) if n == name]
    return sum(got) / _builds(w) if got else None


def _inside(spans, roots) -> list:
    """The spans that lie within a span named one of `roots`."""
    outer = [(s, e) for n, s, e in spans if n in roots]
    return [(n, s, e) for n, s, e in spans
            if any(s0 <= s and e <= e0 for s0, e0 in outer)]


def waits(w, roots):
    """(count, seconds) a build of the spans named *.wait (the host
    blocked on the device) within a span named one of `roots`; None
    where there are none."""
    if not _builds(w):
        return None
    got = [e - s for n, s, e in _inside(spans(w), roots)
           if n.endswith(".wait")]
    if not got:
        return None
    return len(got) / _builds(w), sum(got) / _builds(w)


def innermost(spans, end: float) -> list:
    """[(start, end, name)]: [0, end) cut where the innermost open span
    changes, name None where none is open. Spans nest (one thread)."""
    out, stack, t = [], [], 0.0

    def close(upto):
        nonlocal t
        while stack and stack[-1][1] <= upto:
            name, e = stack.pop()
            out.append((t, e, name))
            t = max(t, e)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close(s)
        out.append((t, s, stack[-1][0] if stack else None))
        t = max(t, s)
        stack.append((name, e))
    close(float("inf"))
    out.append((t, end, None))
    return [(a, min(b, end), n) for a, b, n in out if min(b, end) > a]


def idle_by_span(trace, program) -> dict:
    """Seconds of the window in which the device ran nothing, by the
    innermost of the `program` spans open on the host then (None: none
    open)."""
    idle, t = [], 0.0
    for s, e in trace.busy_intervals() + [[trace.window_s, trace.window_s]]:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    pieces = innermost(program, trace.window_s)
    out, i, j = {}, 0, 0
    while i < len(idle) and j < len(pieces):
        (a, b), (c, d, name) = idle[i], pieces[j]
        lo, hi = max(a, c), min(b, d)
        if hi > lo:
            out[name] = out.get(name, 0.0) + hi - lo
        if b < d:
            i += 1
        else:
            j += 1
    return out


def idle_traced_pct(w):
    """Percent of the device-idle time during which the innermost open
    program span is a stage, not a root's own time nor outside the
    program."""
    if w.trace is None or not w.trace.device:
        return None
    program = spans(w)
    if not program:
        return None
    by = idle_by_span(w.trace, program)
    total = sum(by.values())
    if not total:
        return None
    named = sum(v for n, v in by.items() if n is not None and n not in ROOTS)
    return 100 * named / total
