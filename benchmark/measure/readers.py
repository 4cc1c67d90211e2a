"""What the metric readers share: means over the traced window's builds
of the program's `timings` (BwtResult.timings: the stage marks of
pipeline.py, grouped.py and oocore.py) and of the harness's own spans,
a kernel's share of its bound, and the device's idle share."""

from __future__ import annotations


def mean_seconds(w, labels, where: str = "timings"):
    """The mean, over the builds that report every label, of the sum of
    their seconds; None where no build reports them."""
    got = [sum(b[where][k] for k in labels) for b in w.builds
           if all(k in b[where] for k in labels)]
    return sum(got) / len(got) if got else None


def share_of_bound(w, kernels, bytes_a_build: float):
    """Percent: the least device time the builds' bytes need at the
    card's bandwidth, over the device time of the kernels named
    (None where none ran)."""
    from benchmark.measure.roofline import bound_s

    if w.trace is None:
        return None
    t = w.trace.kernel_seconds(kernels)
    if not t:
        return None
    return 100 * bound_s(bytes_a_build * len(w.builds)) / t


def idle_pct(w):
    """Percent of the window's wall time in which no operation ran on
    the device (None where the trace shows no device activity)."""
    if w.trace is None or not w.trace.device:
        return None
    return 100 * (1 - w.trace.busy_s() / w.trace.window_s)
