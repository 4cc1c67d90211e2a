"""Child process of the out-of-core tier's builds at scale, and the
launcher side that starts it and kills it from outside: the CPU tests
run it at toy sizes, chip_smoke.py on the card at 1 Gbp (killed and
resumed) and at 4.3 Gbp (one whole build past grouped.MAX_N).

    python tests/torch_ooc_worker.py SOURCE SPILL_DIR DEVICE
        [--chunk C] [--buckets B] [--kill-at I] [--sleep S]
        [--verify-steps V]

SOURCE is a size in Mbp (synth.synth_concat_collection of it, made from
its seed in the child, so no text goes to disk) or a directory written
by save_collection (x2.npy and sep.npy, mapped read-only, so that a
killed child and the one that resumes it build the very same bytes).
The child runs

    oocore.build_bwt_ooc(coll, PipelineConfig(m=32, check=True),
                         OocConfig(chunk=C, n_buckets=B,
                                   spill_dir=SPILL_DIR, checkpoint=True),
                         stats, device=DEVICE)

(C 2^26 and B 256 by default: tools/bench_ooc.py's knobs) and prints
three tagged JSON lines to stdout: START before the build (N, the
sha256 of x2 for a saved text, RLIMIT_NOFILE), PASS_B at its first
bucket classification (the kernels' launches, the calls, the peak RSS
and the spill bytes so far) and RESULT after it (stats, bwt_len, the
peak RSS, the spill peak, the bytes this process wrote, the sha256 of
packed() and of sharp_pos as int64, dollar, launches, calls; with
--verify-steps V, lf_verify over the last V characters and its
seconds). The peak RSS is sampled every 50 ms from /proc/self/statm
(ru_maxrss, printed beside it, starts at the parent's high-water mark),
the spill directory's bytes on disk every second and at the first
classification; the bytes written are /proc/self/io's wchar (write
calls; the output, a mapped file under a spill directory, is not
among them) and write_bytes (sent to storage, where the filesystem
counts it). --kill-at I SIGKILLs the child itself at its I-th call of
oocore._classify_bucket; --sleep S sleeps S seconds before each call.
It imports torch, numpy, the standard library and the port only, never
jax.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parent.parent / "src")


# ---------------------------------------------------------------------------
# launcher (the test process, or chip_smoke.py)
# ---------------------------------------------------------------------------


def save_collection(coll, out: Path):
    """x2 and sep of `coll` as out/x2.npy and out/sep.npy."""
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "x2.npy", coll.x2)
    np.save(out / "sep.npy", coll.sep)


class Child:
    """One worker process; its stdout and stderr go to `log`."""

    def __init__(self, log: Path, source, spill_dir, device: str = "cpu",
                 *flags: str):
        self.log = Path(log)
        env = dict(os.environ, PYTHONPATH=SRC)
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, __file__, str(source), str(spill_dir), device,
                 *flags],
                env=env, stdout=f, stderr=subprocess.STDOUT)

    def lines(self) -> dict:
        """{tag: the JSON object of the child's last line with that tag}."""
        out = {}
        for line in self.log.read_text().splitlines():
            tag, _, rest = line.partition(" ")
            if tag in ("START", "PASS_B", "RESULT"):
                out[tag] = json.loads(rest)
        return out

    def tail(self, n: int = 40) -> str:
        return "\n".join(self.log.read_text().splitlines()[-n:])


def spill_bytes(spill_dir) -> tuple:
    """(bytes on disk, apparent bytes) of the files in spill_dir."""
    used = size = 0
    try:
        entries = list(os.scandir(spill_dir))
    except OSError:
        return 0, 0
    for e in entries:
        try:
            st = e.stat()
        except OSError:
            continue
        used += st.st_blocks * 512
        size += st.st_size
    return used, size


def io_bytes(pid="self") -> dict:
    """wchar and write_bytes of process `pid` (/proc/<pid>/io), {} where
    the file cannot be read (a process that is gone)."""
    try:
        with open(f"/proc/{pid}/io") as f:
            rows = dict(line.split(":", 1) for line in f.read().splitlines())
    except (OSError, ValueError):
        return {}
    return {k: int(rows[k]) for k in ("wchar", "write_bytes") if k in rows}


def rss_bytes(pid: int) -> int:
    """Resident bytes of process `pid` (/proc/<pid>/statm), 0 if gone."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def watch(proc, spill_dir, kill_at: int | None = None, interval: float = 2.0,
          timeout: float = 3600.0) -> dict:
    """Wait for `proc`, sampling spill_dir's bytes and the process's
    resident bytes and the bytes it has written (/proc/<pid>/io) every
    `interval` s (as tools/bench_ooc.py's SpillWatcher does). With kill_at, SIGKILL it from outside once the
    checkpoint manifest says stage B with next_bucket >= kill_at
    (tools/rehearse_ooc.py's rule). Past `timeout` seconds it is killed
    and TimeoutError raised. Returns {"killed_at": the manifest's
    next_bucket at the kill, or None; "spill_peak": bytes on disk;
    "spill_peak_apparent": file sizes; "rss_peak"; "io_bytes": the last
    sample (up to `interval` s old at the end); "returncode";
    "seconds"}."""
    t0 = time.perf_counter()
    manifest = Path(spill_dir) / "manifest.json"
    peak = [0, 0]
    rss = 0
    io = {}
    killed_at = None
    while proc.poll() is None:
        if time.perf_counter() - t0 > timeout:
            proc.kill()
            proc.wait()
            raise TimeoutError(f"worker outlived {timeout} s")
        peak = [max(a, b) for a, b in zip(peak, spill_bytes(spill_dir))]
        rss = max(rss, rss_bytes(proc.pid))
        io = io_bytes(proc.pid) or io
        if kill_at is not None:
            try:
                st = json.loads(manifest.read_text())
            except (OSError, ValueError):
                st = {}
            if st.get("stage") == "B" and st.get("next_bucket", 0) >= kill_at:
                proc.send_signal(signal.SIGKILL)
                killed_at = st["next_bucket"]
                break
        time.sleep(interval)
    proc.wait()
    return {"killed_at": killed_at, "spill_peak": peak[0],
            "spill_peak_apparent": peak[1], "rss_peak": rss, "io_bytes": io,
            "returncode": proc.returncode,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the child
# ---------------------------------------------------------------------------


def _collection(source: str):
    from debwt_tpu_torch.synth import synth_concat_collection
    from debwt_tpu_torch.types import SequenceCollection

    if os.path.isdir(source):
        return SequenceCollection(
            x2=np.load(os.path.join(source, "x2.npy"), mmap_mode="r"),
            sep=np.load(os.path.join(source, "sep.npy")))
    return synth_concat_collection(float(source))


def _emit(tag: str, obj: dict):
    print(f"{tag} {json.dumps(obj)}", flush=True)


def _sample(peak: list, fn, period: float):
    """Keep peak[0] at the largest value of fn(), sampled every `period`
    s (for the RSS: ru_maxrss cannot serve, a child starts with its
    parent's high-water mark)."""
    while True:
        peak[0] = max(peak[0], fn())
        time.sleep(period)


def main(argv) -> int:
    import argparse
    import resource
    import threading

    import torch

    from debwt_tpu_torch import oocore
    from debwt_tpu_torch.kernels import seg_or, window_keys
    from debwt_tpu_torch.types import PipelineConfig
    from debwt_tpu_torch.verify import lf_verify

    ap = argparse.ArgumentParser()
    ap.add_argument("source")
    ap.add_argument("spill_dir")
    ap.add_argument("device")
    ap.add_argument("--chunk", type=int, default=1 << 26)
    ap.add_argument("--buckets", type=int, default=256)
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--sleep", type=float, default=0.0)
    ap.add_argument("--verify-steps", type=int, default=0)
    a = ap.parse_args(argv)
    if a.device == "cpu":
        torch.set_num_threads(1)
    rss, spill = [0], [0]
    pid = os.getpid()
    threading.Thread(target=_sample, args=(rss, lambda: rss_bytes(pid), 0.05),
                     daemon=True).start()
    threading.Thread(target=_sample, args=(
        spill, lambda: spill_bytes(a.spill_dir)[0], 1.0), daemon=True).start()
    counters = {"window_keys": window_keys.window_keys,
                "window_keys_at": window_keys.window_keys_at,
                "seg_scan_or": seg_or.seg_scan_or}
    calls = {"_chunk_keys": 0, "_row_keys": 0, "_classify_bucket": 0}

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    real = {n: getattr(oocore, n) for n in ("_chunk_keys", "_row_keys")}

    def counted(name):
        def fn(*args):
            calls[name] += 1
            return real[name](*args)
        return fn

    real_classify = oocore._classify_bucket

    def classify(*args):
        calls["_classify_bucket"] += 1
        if calls["_classify_bucket"] == 1:
            spill[0] = max(spill[0], spill_bytes(a.spill_dir)[0])
            _emit("PASS_B", {"launches": launches(), "calls": dict(calls),
                             "rss_peak_bytes": rss[0],
                             "spill_bytes": spill_bytes(a.spill_dir)[0]})
        if calls["_classify_bucket"] == a.kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(a.sleep)
        return real_classify(*args)

    oocore._chunk_keys = counted("_chunk_keys")
    oocore._row_keys = counted("_row_keys")
    oocore._classify_bucket = classify
    t0 = time.perf_counter()
    coll = _collection(a.source)
    _emit("START", {"n": coll.bwt_len, "n_reads": coll.n_reads,
                    "x2_sha": (hashlib.sha256(coll.x2).hexdigest()
                               if os.path.isdir(a.source) else None),
                    "rlimit_nofile": resource.getrlimit(resource.RLIMIT_NOFILE),
                    "load_s": time.perf_counter() - t0})
    for fn in counters.values():
        fn.launches = 0
    stats = {}
    t0 = time.perf_counter()
    res = oocore.build_bwt_ooc(
        coll, PipelineConfig(m=32, check=True),
        oocore.OocConfig(chunk=a.chunk, n_buckets=a.buckets,
                         spill_dir=a.spill_dir, checkpoint=True),
        stats, device=a.device)
    build_s = time.perf_counter() - t0   # the build ends in host arrays
    counts = launches()
    io_build = io_bytes()
    t0 = time.perf_counter()
    obj_sha = hashlib.sha256(res.packed()).hexdigest()
    pack_s = time.perf_counter() - t0
    verify = None
    if a.verify_steps:
        t0 = time.perf_counter()
        ok = lf_verify(res, coll, max_steps=a.verify_steps)
        verify = {"ok": bool(ok), "steps": min(a.verify_steps, coll.bwt_len),
                  "seconds": time.perf_counter() - t0}
    _emit("RESULT", {
        "stats": stats, "bwt_len": coll.bwt_len, "build_s": build_s,
        "launches": counts, "calls": calls, "obj_sha": obj_sha,
        "sharp_sha": hashlib.sha256(
            res.sharp_pos.astype(np.int64).tobytes()).hexdigest(),
        "dollar": int(res.dollar_pos), "n_sharp": int(res.sharp_pos.shape[0]),
        "pack_s": pack_s, "lf_verify": verify,
        "rss_peak_bytes": rss[0],
        "ru_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "spill_peak_bytes": spill[0],
        "io_bytes_build": io_build, "io_bytes": io_bytes(),
    })
    return 0


if __name__ == "__main__":
    sys.path.insert(0, SRC)
    sys.exit(main(sys.argv[1:]))
