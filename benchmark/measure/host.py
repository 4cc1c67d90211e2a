"""Host-side readings: the process's age, its peak resident set over a
window, and the bytes it has passed to write calls.

RssPeak and written_bytes follow chip_smoke.py's RssPeak and own_wchar
(the chip machine's /proc has no VmHWM, so the peak is sampled).
"""

from __future__ import annotations

import os
import threading
import time

_IMPORTED = time.time()


def process_age_s() -> float:
    """Seconds since this process started (/proc/self/stat's start time
    against /proc/uptime, 10 ms steps); since this module was imported
    where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _IMPORTED


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssPeak:
    """The peak resident set of this process while the `with` block runs,
    sampled from /proc/self/statm every 50 ms by one thread. `bytes`
    stays None where statm cannot be read."""

    def __init__(self):
        self.bytes = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while True:
            try:
                self.bytes = max(self.bytes or 0, rss_bytes())
            except (OSError, ValueError, IndexError):
                return
            if self._stop.wait(0.05):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        try:     # the last reading, as the window closes
            self.bytes = max(self.bytes or 0, rss_bytes())
        except (OSError, ValueError, IndexError):
            pass


def written_bytes() -> int | None:
    """Bytes this process has passed to write calls (/proc/self/io
    wchar), None where the file cannot be read."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None
