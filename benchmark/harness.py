"""The harness: one run of one cell.

Everything that belongs to one cell is found by name:

  BENCHMARK.json              the cell (its config, traffic and chips)
                              and the metrics, with the cells of each
  benchmark/configs/<c>.json  the collection: generator model and sizes
  benchmark/traffic/<t>.json  the traffic: entry kind, m, the share
                              of the window's answers checked, the
                              program's environment
  benchmark/entries/<e>.py    what the window drives, class Entry
  benchmark/metrics/<m>.py    the reader of metric m: read(window) ->
                              a number, or None where it finds nothing

A run: the collection from the seed, one warm-up build of the cell's
own shapes (set-up ends there), then a closed loop with one client for
`seconds`: each build starts while the window is open, and the window
closes at the end of the last, after a device sync. Every build gets
its own input (one point substitution, traffic/genomes.py). A sample
of the window's builds drawn from the seed is kept on disk in the run's
temporary directory, and once the window has closed and the program's
device memory is freed, each kept answer is compared with the plain
reference (reference/bwt.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark.measure import trace as tracing
from benchmark.measure.host import RssPeak, process_age_s, written_bytes
from benchmark.reference import bwt
from benchmark.traffic import genomes

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "debwt_tpu")
# each number compared: 0 when the answer is the reference's, and
# nothing but 0 is right (an exact comparison)
LIMITS = {"obj_bytes_off": 0, "sharp_off": 0, "dollar_off": 0}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    metrics: dict         # "end_to_end" / "per_layer" -> [metric entry]
    root: Path


@dataclasses.dataclass
class Window:
    """What a metric's reader is given."""

    seconds: float        # wall seconds from the first build's start
    n_builds: int         # builds of the window that answered
    bases: int            # input bases of one build
    N: int                # BWT length of one build
    n_reads: int
    m: int
    setup_s: float
    peak_device_bytes: int | None
    peak_rss_bytes: int | None
    builds: list          # per build: {"timings": {...}, "spans": {...}}
    trace: tracing.Trace | None = None


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]

    return Cell(
        name=name,
        config=_load_json(root / "benchmark" / "configs" / f"{w['config']}.json"),
        traffic=_load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        metrics={k: mine(bench[k]) for k in ("end_to_end", "per_layer")},
        root=root,
    )


def _load_file(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(kind: str, root: Path = ROOT):
    return _load_file(root / "benchmark" / "entries" / f"{kind}.py").Entry


def load_reader(metric: str, root: Path = ROOT):
    return _load_file(root / "benchmark" / "metrics" / f"{metric}.py").read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (debwt_tpu_torch is neither: names compare whole)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def checked(seed: int, build: int, share: float) -> bool:
    """Whether the window's build `build` (1, 2, ...) is kept and
    compared: the first always, each other with probability `share`,
    drawn from (seed, build)."""
    if build == 1 or share >= 1:
        return True
    return bool(np.random.default_rng([seed % (1 << 64), 2, build]).random()
                < share)


def _profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev) -> dict:
    """One run: the result line's fields, and "checks" (name -> (value,
    limit)) last."""
    col = cell.config["collection"]
    traffic = cell.traffic
    Entry = load_entry(traffic["entry"], cell.root)
    codes, lengths = genomes.make_codes(col, seed)
    n_codes = int(lengths.sum())
    n_reads = int(lengths.shape[0])
    workdir = tempfile.TemporaryDirectory(prefix="debwt-bench-")
    entry = None
    try:
        entry = Entry(codes, lengths, traffic, dev, workdir.name, trace)
        del codes
        entry.set_variant(*genomes.substitution(seed, 0, n_codes))
        entry.build()                       # the warm-up: set-up
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = process_age_s()

        kept = {}                           # build -> the entry's handle
        records, failed, errors, build_s = [], 0, [], []
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(_profiler(dev)) if trace else None
            rss = stack.enter_context(RssPeak())
            if trace:
                stack.enter_context(
                    torch.profiler.record_function(tracing.WINDOW_SPAN))
            t0 = time.perf_counter()
            j = 0
            while j == 0 or time.perf_counter() - t0 < seconds:
                j += 1
                entry.set_variant(*genomes.substitution(seed, j, n_codes))
                tb = time.perf_counter()
                try:
                    handle, rec = entry.build()
                    _sync(dev)
                except Exception:       # a build that never answers
                    failed += 1
                    errors.append(traceback.format_exc(limit=4))
                    continue
                build_s.append(time.perf_counter() - tb)
                records.append(rec)
                if checked(seed, j, traffic["checked_share"]):
                    kept[j] = entry.keep(handle, j)
                del handle
            _sync(dev)
            window_s = time.perf_counter() - t0
        peak_dev = (torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None)

        w = Window(
            seconds=window_s, n_builds=len(records), bases=n_codes,
            N=n_codes + n_reads, n_reads=n_reads, m=traffic["m"],
            setup_s=setup_s, peak_device_bytes=peak_dev,
            peak_rss_bytes=rss.bytes, builds=records,
            trace=tracing.reduce(prof) if trace else None,
        )
        metrics = {}
        for m in cell.metrics["per_layer" if trace else "end_to_end"]:
            v = load_reader(m["name"], cell.root)(w)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        entry.close()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sorts = []
        checks = _check(col, seed, lengths, kept, entry, dev, sorts)
        check_s = time.perf_counter() - t0
    finally:
        if entry is not None:
            entry.close()
        workdir.cleanup()

    result = {
        "correct": (failed == 0 and bool(kept)
                    and all(v <= lim for v, lim in checks.values())),
        "attempted": j,
        "failed": failed,
        "metrics": metrics,
        "device": _device(dev, cell.chips, peak_dev),
    }
    if trace:
        result["device"]["busy_s"] = w.trace.busy_s()
        result["device"]["window_s"] = w.trace.window_s
        result["breakdown"] = {"device_ops": w.trace.device_ops(),
                               "idle_gaps": w.trace.idle_gaps()}
    result["checks"] = checks
    result["_notes"] = {"errors": errors[:3], "checked_builds": sorted(kept),
                        "build_s": build_s, "written_bytes": written_bytes(),
                        "check_s": check_s,
                        "sorts": {k: sorts.count(k) for k in set(sorts)}}
    return result


def _check(col: dict, seed: int, lengths, kept: dict, entry, dev,
           sorts: list) -> dict:
    """The worst of each number compared over the kept answers, each
    against the plain reference of that build's own input; `sorts` gets
    the path each reference took."""
    worst = {k: 0 for k in LIMITS}
    if not kept:
        return {k: (v, LIMITS[k]) for k, v in worst.items()}
    codes, _ = genomes.make_codes(col, seed)
    for b, handle in sorted(kept.items()):
        ans = entry.answer(handle)
        q, shift = genomes.substitution(seed, b, codes.shape[0])
        old = codes[q]
        codes[q] = (old + shift) % 4
        x = bwt.text6(codes, lengths, dev)
        codes[q] = old
        stats = {}      # filled by the blocked path only
        got = bwt.compare(ans, bwt.reference_answer(x, stats=stats))
        sorts.append("blocked" if stats else "one sort")
        del x
        for k, v in got.items():
            worst[k] = max(worst[k], v)
    return {k: (v, LIMITS[k]) for k, v in worst.items()}


def _device(dev, chips: int, peak) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": peak}


def emit(result: dict) -> None:
    """Prints the run's notes and the numbers compared on standard
    error, the numbers last, then the result line on standard output."""
    notes = result.pop("_notes", {})
    for e in notes.get("errors", []):
        print(f"[bench] a build failed:\n{e}", file=sys.stderr)
    print(f"[bench] seconds of each build {notes.get('build_s')}",
          file=sys.stderr)
    print(f"[bench] checked builds {notes.get('checked_builds')}; "
          f"bytes written by this process {notes.get('written_bytes')}",
          file=sys.stderr)
    print(f"[bench] reference seconds {notes.get('check_s')}, its sorts "
          f"{notes.get('sorts')}", file=sys.stderr)
    checks = result.pop("checks")
    for k, (v, lim) in checks.items():
        print(f"[bench] check {k} {v} limit {lim}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
