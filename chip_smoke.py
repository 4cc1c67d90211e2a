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
           and at the 140 Mbp main-path shape: window_keys through both
           loaders (packed words, uint8 codes, also on slices at odd
           byte offsets), seg_scan_or in both directions with every
           R mod 4 and with one segment across more than 32 x 32 tiles,
           the scan cases twice over; CUDA-event times at the main-path
           shape beside the bound, the plain version's time and a plain
           fill or copy of the same bytes
  e2e      the main path through api.build: a small collection against
           the golden BWT, then 4.6 and 140 Mbp of the synthetic
           near-identical-genome collection (m = 32) against the reference
           binary's hashes in .bench_cache.json; Mbp/s (best of 3 after a
           warm-up), stage timings, peak device memory (allocated and
           reserved, per sorted row), and the launch
           counts of every kernel, reset before each build; then one
           140 Mbp build under torch.profiler (device time by kernel,
           the device's idle share); last, one build of the largest
           collection under api.single_rows_bound (410 Mbp on an 80 GB
           card) with the character counts checked, its peak memory
           beside the bound; a card too small for it must refuse it

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
NEAR_BOUND_MBP = 410.0      # rows 469,762,176: the last bucket under 2^29
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

    from debwt_tpu_torch import ops
    from debwt_tpu_torch.kernels import seg_or
    from debwt_tpu_torch.kernels.window_keys import (
        window_keys, window_keys_packed, window_keys_packed_plain,
        window_keys_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def codes(n):
        return torch.randint(0, 4, (n,), generator=gen, device=dev,
                             dtype=torch.uint8)

    # ---- kernel 1: window_keys, both loaders ----
    wk = Parity("window_keys")
    shapes = [(5000, 32), (5000, 31), (PALLAS_TILE, 24), (PALLAS_TILE + 1, 23),
              (3 * PALLAS_TILE + 17, 29), (20000, 12), (9000, 2),
              (1, 32), (1023, 32), (1024, 17), (1025, 32),
              # the last word partial; W[j+1] or W[j+2] past the end
              (4081, 16), (33, 32), (100, 5), (2048, 32), (2049, 32), (1, 1)]
    for n_out, w in shapes:
        x = codes(n_out + w - 1)
        x2w = ops.pack_2bit_words(x)
        want = window_keys_plain(x, w, n_out)
        wk.check(window_keys_packed(x2w, w, n_out), want,
                 f"packed n_out={n_out} w={w}")
        wk.check(window_keys_packed_plain(x2w, w, n_out), want,
                 f"packed plain n_out={n_out} w={w}")
        wk.check(window_keys(x, w, n_out), want, f"uint8 n_out={n_out} w={w}")
        for off in (1, 16):             # slices at odd byte offsets
            if n_out > off:
                wk.check(window_keys(x[off:], w, n_out - off), want[off:],
                         f"uint8 x[{off}:] n_out={n_out} w={w}")
    n_out, w = 6000, 32                 # tail isolation, both loaders
    base = codes(n_out + w - 1 + 500)
    other = base.clone()
    other[n_out + w - 1:] = (other[n_out + w - 1:] + 1) % 4
    wk.check(window_keys(other, w, n_out), window_keys(base, w, n_out),
             "tail isolation")
    wk.check(window_keys_packed(ops.pack_2bit_words(other), w, n_out),
             window_keys_packed(ops.pack_2bit_words(base)[:-20], w, n_out),
             "tail isolation, packed")
    n_out, w = MAIN_N_CAP, 32           # the 140 Mbp main-path shape
    x = codes(n_out + w - 1)
    x2w = ops.pack_2bit_words(x)
    want = window_keys_plain(x, w, n_out)
    wk.check(window_keys_packed(x2w, w, n_out), want,
             f"packed n_out={n_out} w={w}")
    wk.check(window_keys(x, w, n_out), want, f"uint8 n_out={n_out} w={w}")
    wk.check(window_keys(x[1:], w, n_out - 1), want[1:],
             f"uint8 x[1:] n_out={n_out} w={w}")
    del want
    ms = cuda_ms(lambda: window_keys_packed(x2w, w, n_out), reps=20)
    ms_u8 = cuda_ms(lambda: window_keys(x, w, n_out), reps=20)
    ms_u8_off = cuda_ms(lambda: window_keys(x[1:], w, n_out - 1), reps=20)
    plain = cuda_ms(lambda: window_keys_packed_plain(x2w, w, n_out),
                    reps=3, warm=1)
    plain_u8 = cuda_ms(lambda: window_keys_plain(x, w, n_out), reps=3, warm=1)
    ms_w8 = cuda_ms(lambda: window_keys_packed(x2w, 8, n_out), reps=20)
    # the card's own yardstick: a fill of the same 8 * n_out bytes
    keys = torch.empty(n_out, dtype=torch.int64, device=dev)
    fill = cuda_ms(keys.zero_, reps=20)
    del keys
    # bytes: each code read once (2 bits packed, a byte unpacked), each
    # key written once; operations: a rolling key costs a shift, an OR
    # and a mask per position
    b_ms, b_by = bound_ms((n_out + w - 1) / 4 + 8 * n_out, 3 * n_out)
    b_u8, b_u8_by = bound_ms((n_out + w - 1) + 8 * n_out, 3 * n_out)
    del x, x2w
    rows["window_keys"] = dict(
        name="window_keys", route="cuda",
        source="src/debwt_tpu_torch/csrc/window_keys.cu",
        replaces="src/debwt_tpu/kernels/window_keys.py:98",
        launches=None, max_abs_err=wk.max_abs_err, ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    say(f"[kernels] window_keys uint8 loader n_out={n_out} w={w}: "
        f"{ms_u8:.4f} ms, on x[1:] {ms_u8_off:.4f} ms "
        f"(bound {b_u8:.4f} ms by {b_u8_by}, plain {plain_u8:.4f} ms)")
    say(f"[kernels] window_keys packed loader n_out={n_out} w={w}: "
        f"{ms:.4f} ms, at w=8 {ms_w8:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
        f"plain {plain:.4f} ms; zero_ of the keys' bytes {fill:.4f} ms)")
    say(f"[kernels] window_keys: {wk.cases} cases equal")

    # ---- kernel 2: seg_scan_or (both directions) ----
    so = Parity("seg_scan_or")
    T = seg_or.TILE

    def words(R, stop, prefix, p_stop):
        bits = torch.randint(0, stop, (R,), generator=gen, device=dev,
                             dtype=torch.int32)
        is_stop = torch.rand(R, generator=gen, device=dev) < p_stop
        is_stop[0 if prefix else -1] = True
        return bits | (is_stop.to(torch.int32) * stop)

    # R mod 4 takes every value (T + 1, T + 2, T + 3); the largest but
    # one has more tiles than 32 look-back windows of 32
    sizes = [1, 127, T - 1, T, T + 1, T + 2, T + 3, 3 * T + 17,
             PALLAS_TILE + 1, 70001, (32 * 32 + 5) * T + 1, MAIN_R]

    def scan_cases():
        for R in sizes:
            for stop in (1 << 6, 1 << 29):
                for prefix in (False, True):
                    # p_stop 0: one segment spans every tile of the array
                    for p_stop in ((0.05, 0.0) if R < MAIN_R else (1e-4, 0.0)):
                        wd = words(R, stop, prefix, p_stop)
                        got = seg_or.seg_scan_or(wd, stop_bit=stop, prefix=prefix)
                        want = seg_or.seg_scan_or_plain(wd, stop, prefix)
                        m = stop - 1
                        so.check(got & m, want & m,
                                 f"R={R} stop={stop} prefix={prefix} p={p_stop}")
                        so.check(got, want, f"R={R} whole words")
                        del got, want, wd
        for off in (1, 2, 3):           # words off a 16-byte boundary
            for prefix in (False, True):
                wd = words(5 * T + 9 + off, 1 << 6, prefix, 0.01)[off:]
                wd[0 if prefix else -1] |= 1 << 6
                so.check(seg_or.seg_scan_or(wd, 1 << 6, prefix),
                         seg_or.seg_scan_or_plain(wd.clone(), 1 << 6, prefix),
                         f"words[{off}:] prefix={prefix}")

    # twice in one process: every launch must find fresh descriptors
    # and a fresh ticket
    scan_cases()
    scan_cases()
    timed = {}
    for stop, prefix, p_stop in ((1 << 6, False, 0.05), (1 << 29, True, 0.05),
                                 (1 << 29, False, 0.0)):
        wd = words(MAIN_R, stop, prefix, p_stop)
        timed[(stop, prefix, p_stop)] = (
            cuda_ms(lambda: seg_or.seg_scan_or(wd, stop_bit=stop, prefix=prefix),
                    reps=20),
            cuda_ms(lambda: seg_or.seg_scan_or_plain(wd, stop, prefix),
                    reps=3, warm=1),
        )
    # the card's own yardstick: a copy reads and writes the same bytes
    copy = cuda_ms(wd.clone, reps=20)
    del wd
    ms, plain = timed[(1 << 6, False, 0.05)]
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
    for (stop, prefix, p_stop), (k_ms, p_ms) in timed.items():
        say(f"[kernels] seg_scan_or R={MAIN_R} stop=2^{stop.bit_length() - 1} "
            f"{'prefix' if prefix else 'suffix'} p_stop={p_stop}: {k_ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, plain {p_ms:.4f} ms)")
    say(f"[kernels] seg_scan_or: {so.cases} cases equal (every case twice); "
        f"clone of the words {copy:.4f} ms")
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
    from debwt_tpu_torch.pipeline import rows_needed
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
                last = (r.timings, torch.cuda.max_memory_allocated(),
                        torch.cuda.max_memory_reserved(), counts)
            del r, packed
        best = min(times)
        timings, peak, reserved, counts = last
        n_rows = rows_needed(coll, config.m)
        for name, n in counts.items():
            if name in rows:
                rows[name]["launches"] = n
        say(json.dumps({
            "e2e_mbp": mbp, "n_bases": n_bases, "m": 32,
            "hashes_equal_reference": True,
            "mbps": n_bases / 1e6 / best, "best_s": best, "times_s": times,
            "stage_s": timings, "peak_bytes": peak,
            "peak_reserved_bytes": reserved, "rows": n_rows,
            "peak_bytes_per_row": peak / n_rows,
            "peak_reserved_bytes_per_row": reserved / n_rows,
            "launches": counts,
            "synth_s": t_synth,
        }))
        if mbp == max(E2E_MBP):
            profile_build(lambda: build(coll, config, device=dev).packed(), mbp)
        del coll
        torch.cuda.empty_cache()


def phase_near_bound(dev):
    """One build just under the single-device bound: it must fit in the
    card's memory, or be refused by api.build before anything is
    allocated where the card is too small for it."""
    import torch

    from debwt_tpu_torch import api
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig

    config = PipelineConfig(m=32, check=True)
    coll = synth_collection(NEAR_BOUND_MBP)
    n_rows = api.rows_needed(coll, config.m)
    torch.cuda.empty_cache()
    bound = api.single_rows_bound(dev)
    free, total = torch.cuda.mem_get_info(dev)
    line = {"near_bound_mbp": NEAR_BOUND_MBP, "rows": n_rows,
            "single_rows_bound": bound, "free_bytes": free,
            "total_bytes": total, "bytes_per_row": api._BYTES_PER_ROW}
    if n_rows >= bound:
        try:
            api.build(coll, config, device=dev)
        except NotImplementedError:
            say(json.dumps({**line, "refused": True}))
            return
        raise AssertionError("a collection over the bound was not refused")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    r = api.build(coll, config, device=dev)     # check: character counts
    n_packed = len(r.packed())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _check_counts(_read_counts(), f"{NEAR_BOUND_MBP} Mbp build")
    if n_packed != 8 * ((coll.bwt_len + 31) // 32):
        raise AssertionError(f"{NEAR_BOUND_MBP} Mbp: packed BWT length")
    peak, reserved = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved())
    say(json.dumps({
        **line, "refused": False, "build_s": dt, "peak_bytes": peak,
        "peak_reserved_bytes": reserved,
        "peak_bytes_per_row": peak / n_rows,
        "peak_reserved_bytes_per_row": reserved / n_rows,
        "reserved_share_of_free": reserved / free,
    }))
    del r, coll
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
    phase_near_bound(dev)
    say(f"[done] {time.perf_counter() - t_all:.1f}s")
    say(json.dumps({"kernels": list(rows.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
