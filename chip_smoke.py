#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/debwt_tpu_torch) on one CUDA card.

Run from the root of a checkout, on a machine with an H100:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero code:

  card     the card's name and power limit (nvidia-smi), the device count
  build    nvcc builds every kernel source of src/debwt_tpu_torch/csrc for
           sm_90a, all at once; ptxas's register/shared-memory report
  kernels  each kernel against its plain PyTorch version on the card,
           exact equality (all data is integer), at the CPU tests' shapes
           and at the 140 Mbp main-path shape; CUDA-event times there
           beside the bound and the plain version's time
  e2e      the main path through api.build: a small collection against
           the golden BWT, then 4.6 and 140 Mbp of the synthetic
           near-identical-genome collection (m = 32) against the reference
           binary's hashes in .bench_cache.json; Mbp/s (best of 3 after a
           warm-up), stage timings, peak device memory, and the launch
           counts of every kernel, reset before each build; then one
           140 Mbp build under torch.profiler (device time by kernel,
           the device's idle share)

The lines before the last are the `kernels` JSON object and the card's
name and power limit; the last is {"ok": true, "device": {...}}.
Every run runs every phase. The script takes no arguments and imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM non-tensor 32-bit rate (data sheet)
MAIN_N_CAP = 167_772_160    # N_cap of the 140 Mbp collection
MAIN_R = MAIN_N_CAP + 128   # plus ns_cap: the row scans' length
PALLAS_TILE = 8192          # the JAX kernels' tile, used by the CPU tests
E2E_MBP = (4.6, 140.0)
EXPECTED_LAUNCHES = {"window_keys": 1, "seg_scan_or": 4}


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(n_bytes: float, n_ops: float):
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / ALU_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


class Parity:
    """Exact comparisons of one kernel against its plain version."""

    def __init__(self, name):
        self.name = name
        self.cases = 0
        self.max_abs_err = 0.0

    def check(self, got, want, what):
        import torch

        err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
        self.max_abs_err = max(self.max_abs_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"{self.name} {what}: kernel != plain version")
        self.cases += 1


def phase_build():
    from debwt_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"[build] {len(logs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.strip().splitlines():
            say(f"[build] {name}: {line}")


def phase_kernels(dev, rows: dict):
    import torch

    from debwt_tpu_torch.kernels import seg_or
    from debwt_tpu_torch.kernels.window_keys import window_keys, window_keys_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def codes(n):
        return torch.randint(0, 4, (n,), generator=gen, device=dev,
                             dtype=torch.uint8)

    # ---- kernel 1: window_keys ----
    wk = Parity("window_keys")
    shapes = [(5000, 32), (5000, 31), (PALLAS_TILE, 24), (PALLAS_TILE + 1, 23),
              (3 * PALLAS_TILE + 17, 29), (20000, 12), (9000, 2),
              (1, 32), (1023, 32), (1024, 17), (1025, 32)]
    for n_out, w in shapes:
        x = codes(n_out + w - 1)
        wk.check(window_keys(x, w, n_out), window_keys_plain(x, w, n_out),
                 f"n_out={n_out} w={w}")
    n_out, w = 6000, 32                 # tail isolation
    base = codes(n_out + w - 1 + 500)
    other = base.clone()
    other[n_out + w - 1:] = (other[n_out + w - 1:] + 1) % 4
    wk.check(window_keys(other, w, n_out), window_keys(base, w, n_out),
             "tail isolation")
    n_out, w = MAIN_N_CAP, 32           # the 140 Mbp main-path shape
    x = codes(n_out + w - 1)
    got = window_keys(x, w, n_out)
    want = window_keys_plain(x, w, n_out)
    wk.check(got, want, f"n_out={n_out} w={w}")
    del got, want
    ms = cuda_ms(lambda: window_keys(x, w, n_out), reps=20)
    plain = cuda_ms(lambda: window_keys_plain(x, w, n_out), reps=3, warm=1)
    # bytes: each code read once, each key written once; operations: a
    # rolling key costs a shift, an OR and a mask per position
    b_ms, b_by = bound_ms((n_out + w - 1) + 8 * n_out, 3 * n_out)
    del x
    rows["window_keys"] = dict(
        name="window_keys", route="cuda",
        source="src/debwt_tpu_torch/csrc/window_keys.cu",
        replaces="src/debwt_tpu/kernels/window_keys.py:98",
        launches=None, max_abs_err=wk.max_abs_err, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    say(f"[kernels] window_keys: {wk.cases} cases equal; n_out={n_out} w={w}: "
        f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, plain {plain:.4f} ms)")

    # ---- kernel 2: seg_scan_or (both directions) ----
    so = Parity("seg_scan_or")
    T = seg_or.TILE

    def words(R, stop, prefix, p_stop):
        bits = torch.randint(0, stop, (R,), generator=gen, device=dev,
                             dtype=torch.int32)
        is_stop = torch.rand(R, generator=gen, device=dev) < p_stop
        is_stop[0 if prefix else -1] = True
        return bits | (is_stop.to(torch.int32) * stop)

    sizes = [1, 127, T, T + 1, 3 * T + 17, PALLAS_TILE + 1, 70001,
             (2 * seg_or.CARRY_THREADS + 5) * T, MAIN_R]
    for R in sizes:
        for stop in (1 << 6, 1 << 29):
            for prefix in (False, True):
                # p_stop 0: one segment spans every tile of the array
                for p_stop in ((0.05, 0.0) if R < MAIN_R else (1e-4,)):
                    wd = words(R, stop, prefix, p_stop)
                    got = seg_or.seg_scan_or(wd, stop_bit=stop, prefix=prefix)
                    want = seg_or.seg_scan_or_plain(wd, stop, prefix)
                    m = stop - 1
                    so.check(got & m, want & m,
                             f"R={R} stop={stop} prefix={prefix} p={p_stop}")
                    so.check(got, want, f"R={R} whole words")
                    del got, want, wd
    timed = {}
    for stop, prefix in ((1 << 6, False), (1 << 29, True)):
        wd = words(MAIN_R, stop, prefix, 0.05)
        timed[(stop, prefix)] = (
            cuda_ms(lambda: seg_or.seg_scan_or(wd, stop_bit=stop, prefix=prefix),
                    reps=20),
            cuda_ms(lambda: seg_or.seg_scan_or_plain(wd, stop, prefix),
                    reps=3, warm=1),
        )
        del wd
    ms, plain = timed[(1 << 6, False)]
    # bytes: each word read once and written once; operations: the
    # carry combine (AND, select, OR) once per word
    b_ms, b_by = bound_ms(8 * MAIN_R, 3 * MAIN_R)
    rows["seg_scan_or"] = dict(
        name="seg_scan_or", route="cuda",
        source="src/debwt_tpu_torch/csrc/seg_or.cu",
        replaces="src/debwt_tpu/kernels/seg_or.py:138",
        launches=None, max_abs_err=so.max_abs_err, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    for (stop, prefix), (k_ms, p_ms) in timed.items():
        say(f"[kernels] seg_scan_or R={MAIN_R} stop=2^{stop.bit_length() - 1} "
            f"{'prefix' if prefix else 'suffix'}: {k_ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, plain {p_ms:.4f} ms)")
    say(f"[kernels] seg_scan_or: {so.cases} cases equal")
    torch.cuda.empty_cache()


def _counters():
    from debwt_tpu_torch.kernels import seg_or, window_keys

    return {"window_keys": window_keys.window_keys,
            "seg_scan_or": seg_or.seg_scan_or}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def _check_counts(counts, what):
    for name, want in EXPECTED_LAUNCHES.items():
        if counts[name] != want:
            raise AssertionError(
                f"{what}: {name} launched {counts[name]} times, want {want}"
            )


def phase_e2e(dev, rows: dict):
    import numpy as np
    import torch

    from debwt_tpu_torch.api import build
    from debwt_tpu_torch.golden import golden_bwt
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

    # small collection against the golden BWT (repeats, several m)
    rng = np.random.default_rng(5)
    frags = ["".join(rng.choice(list("ACGT"), size=40)) for _ in range(5)]
    reads = ["".join(rng.choice(frags) for _ in range(5)) for _ in range(30)]
    coll = SequenceCollection.from_reads(reads)
    g = golden_bwt(coll)
    for m in (12, 20, 32):
        _reset_counts()
        r = build(coll, PipelineConfig(m=m, check=True), device=dev)
        packed = r.packed()
        _check_counts(_read_counts(), f"golden m={m}")
        if not (packed == g.packed() and (r.sharp_pos == g.sharp_pos).all()
                and r.dollar_pos == g.dollar_pos):
            raise AssertionError(f"small collection m={m}: differs from golden")
    say(f"[e2e] {coll.n_reads} reads x m in (12, 20, 32): equal to golden")

    cache = json.loads((ROOT / ".bench_cache.json").read_text())
    config = PipelineConfig(m=32)
    for mbp in E2E_MBP:
        ref = cache[f"ref_mbp{mbp}"]
        t0 = time.perf_counter()
        coll = synth_collection(mbp)
        t_synth = time.perf_counter() - t0
        n_bases = coll.bwt_len - coll.n_reads
        times, last = [], None
        for rep in range(4):            # one warm-up, then best of 3
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            r = build(coll, config, device=dev)
            packed = r.packed()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = _read_counts()
            _check_counts(counts, f"{mbp} Mbp build {rep}")
            ok = (
                hashlib.sha256(packed).hexdigest() == ref["obj_sha"]
                and hashlib.sha256(r.sharp_pos.astype(np.int64).tobytes())
                .hexdigest() == ref["sharp_sha"]
                and r.dollar_pos == ref["dollar"]
            )
            if not ok:
                raise AssertionError(
                    f"{mbp} Mbp: output differs from the reference hashes"
                )
            if rep:
                times.append(dt)
                last = (r.timings, torch.cuda.max_memory_allocated(), counts)
            del r, packed
        best = min(times)
        timings, peak, counts = last
        for name, n in counts.items():
            if name in rows:
                rows[name]["launches"] = n
        say(json.dumps({
            "e2e_mbp": mbp, "n_bases": n_bases, "m": 32,
            "hashes_equal_reference": True,
            "mbps": n_bases / 1e6 / best, "best_s": best, "times_s": times,
            "stage_s": timings, "peak_bytes": peak, "launches": counts,
            "synth_s": t_synth,
        }))
        if mbp == max(E2E_MBP):
            profile_build(lambda: build(coll, config, device=dev).packed(), mbp)
        del coll
        torch.cuda.empty_cache()


def profile_build(fn, mbp: float):
    """fn() once under torch.profiler: device time by kernel name and
    the device's busy share of fn's wall time."""
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):          # union of device intervals
        if t > end:
            busy += t - max(s, end)
            end = t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    say(json.dumps({
        "profile_mbp": mbp, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1 - busy / wall_us,
        "device_events": len(spans),
        "top_device_ms": {n[:80]: us / 1e3 for n, us in top},
    }))


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import debwt_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {name} x{count}")
    rows: dict = {}
    t_all = time.perf_counter()
    phase_build()
    phase_kernels(dev, rows)
    phase_e2e(dev, rows)
    say(f"[done] {time.perf_counter() - t_all:.1f}s")
    say(json.dumps({"kernels": list(rows.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
