"""The process's peak resident set over the window, from
/proc/self/statm sampled every 50 ms, in GB."""


def read(w):
    if w.peak_rss_bytes is None:
        return None
    return w.peak_rss_bytes / 1e9
