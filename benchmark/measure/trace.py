"""The traced window: torch.profiler over the window, reduced to the
device's activity, the harness's spans and the host's operations.

The union of device activity over the window's wall time follows
chip_smoke.py's profile_build, applied to the whole window rather than
to one build. The harness marks its own spans with record_function under
names that start with "bench."; on the device timeline those show as
annotations, which are not device work and are left out of it.
"""

from __future__ import annotations

import bisect
import dataclasses

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
_TOP = 10


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    """Times in seconds from the window's start."""

    window_s: float
    device: list          # (name, start, end): kernels, copies, fills
    spans: list           # (name, start, end): the harness's spans
    host_ops: list        # (start, name): host operations, by start

    def kernel_seconds(self, names) -> float | None:
        """Device seconds of the kernels whose name holds one of
        `names`; None when no such kernel ran."""
        hits = [e - s for n, s, e in self.device if any(k in n for k in names)]
        return sum(hits) if hits else None

    def busy_intervals(self) -> list:
        """The union of device activity within the window."""
        out = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def device_ops(self) -> list:
        """[name, seconds]: the device operations that took most time."""
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:_TOP]
        return [[n[:120], t] for n, t in top]

    def idle_gaps(self) -> list:
        """[name, seconds]: the longest idle gaps of the device, each
        named by the harness span around it and the host operation
        that started last before it."""
        gaps, end = [], 0.0
        for s, e in self.busy_intervals() + [[self.window_s, self.window_s]]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [t for t, _ in self.host_ops]
        out = []
        for g0, g1 in gaps[:_TOP]:
            mid = (g0 + g1) / 2
            inner = [(s, n) for n, s, e in self.spans if s <= mid <= e]
            span = max(inner)[1] if inner else "window"
            i = bisect.bisect_right(starts, g0) - 1
            op = self.host_ops[i][1] if i >= 0 else "start"
            out.append([f"{span[len(SPAN_PREFIX):]} after {op}"[:120], g1 - g0])
        return out


def reduce(prof) -> Trace:
    """The window's Trace from a finished torch.profiler.profile."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    win = [e for e in events if e.name() == WINDOW_SPAN
           and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    t0 = _ns(win[0], "start")
    w_s = (_ns(win[0], "end") - t0) / 1e9
    device, spans, host = [], [], []
    for e in events:
        name = e.name()
        s = (_ns(e, "start") - t0) / 1e9
        t = (_ns(e, "end") - t0) / 1e9
        if e.device_type() == DeviceType.CUDA:
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not (annotation or name.startswith(SPAN_PREFIX)):
                device.append((name, s, t))
        elif name.startswith(SPAN_PREFIX):
            if name != WINDOW_SPAN:
                spans.append((name, s, t))
        else:
            host.append((s, name))
    host.sort()
    return Trace(window_s=w_s, device=device, spans=spans, host_ops=host)
