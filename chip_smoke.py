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
           the scan cases twice over; window_keys' packed entry on
           word-offset slices of the words (the grouped tier's call) and
           seg_scan_or at the grouped tier's selection and classification
           shapes; window_keys_at (kernel 1 at gathered int64
           positions) at the CPU tests' shapes and on rows laid out as
           an out-of-core bucket's over a text past 2^32 positions;
           CUDA-event times at the main-path shapes beside the
           bound, the plain version's time and a plain fill or copy of
           the same bytes
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
           beside the bound; a card too small for it must refuse it;
           the grouped tier then builds the same collection and must
           give the same hashes
  verify   lf_verify (full walk, native walker) on the 4.6 Mbp result and
           on a copy with one flipped character, which must fail;
           count_kmers at m = 32 against a host count of the same keys
  grouped  the grouped tier (grouped.build_bwt_grouped): 140 Mbp with a
           cap and a chunk that force at least 4 groups and 4 chunks,
           against the reference hashes, the kernels' launch counts
           against the plan, then one such build under torch.profiler;
           then the main path of this tier at full width: 600 Mbp, over
           the single-device bound of any card, through api.build with
           the default cap; it must take the grouped tier, pass the
           character-count check, hold one '$' and n_reads - 1 '#', and
           pass a bounded LF walk on the sampled-occ path
  ooc      the out-of-core tier (oocore.build_bwt_ooc), called directly:
           the grouped phase's 600 Mbp collection with the default knobs
           (9 chunks of 2^26, 64 buckets in host DRAM) must give the
           grouped build's hashes, one '$' and n_reads - 1 '#'; 140 Mbp
           spilled to a temporary directory with checkpoints, interrupted
           at bucket 32 of 64 and resumed in-process, must give the
           reference hashes with no kernel-1 launch on the resume and no
           file left in the directory; launches against the plan (kernel
           1 once a chunk, kernel 2 three times a device classification);
           the plan, stage times, Mbp/s, peak device bytes, the host's
           peak RSS and the peak spill bytes; then both kernels against their
           plain versions and timed at this tier's shapes (window_keys on
           one chunk's packed words at w = 31 and 11, the classification
           scans at the largest bucket's rows)
  genome   the CLI at genome scale: tools/bench_ooc.py's synth_concat
           text at 3000 Mbp (N = 3,000,000,004, so positions pass 2^31;
           synthesis timed) written as FASTA (four records, 80 bases a
           line) to a tmpfs with room for 1.3 x (FASTA + N/4 + 64 MiB),
           else gzip-compressed at level 1 to disk; then one `python -m
           debwt_tpu_torch.cli` process on it with --check --timings
           --verify --verify-steps 2^22 and DEBWT_TRACE=1 alone (the
           default route); it must announce and take the grouped tier
           at G 7 x 23 chunks with a classification of at least 2^29 -
           2^20 rows (the default cap at the scan bound), launch the
           kernels as its plan says, trace .bench_cache.json
           grouped_mbp3000.0's sp_len and n_blue (the JAX package's
           grouped and out-of-core tiers agreed on them), pass the
           character counts and the 2^22-step LF walk, and write files
           of N/4 bytes with the port's own hashes as first recorded
           (GENOME_HASHES), one '$' and n_reads - 1 '#'; the FASTA's
           bytes and medium, the process's wall, start, import, CUDA
           context, ingest, build, write, walk and exit seconds, its
           stage times, Mbp/s, its peak resident set (VmHWM) and the
           card's peak bytes a group row; then seg_scan_or at this
           build's classification rows, both directions, against its
           plain version and timed, in this process
  ooc_rehearsal
           the out-of-core tier spilled with checkpoints, killed and
           resumed across processes (tools/rehearse_ooc.py's job):
           synth_concat at 600 Mbp built on the grouped tier through
           api.build for the same-run hashes and counts, its
           text written once to a disk-backed temporary directory
           (tmpfs, or under 1.25 x 8 bytes a position free, fails),
           this process's memory freed, then tests/torch_ooc_worker.py
           (OocConfig(chunk=2^26, n_buckets=256, spill_dir,
           checkpoint=True), check=True) in a child SIGKILLed from here
           once the manifest reaches bucket 128 of pass B, and in a
           fresh child that resumes it; it must skip pass A (no
           kernel-1 launch), launch kernel 2 three times a
           classification, classify no more than the buckets left, have
           the grouped build's sp_len, n_blue and hashes (.bench_cache.json
           has the JAX package's counts at 1000 Mbp, where the phase ran
           until the genome phase's CLI process took its time), leave
           the spill directory empty and
           spill at most 7.5 bytes a position at the peak (bucket rows
           are 6 bytes: a position's offset in its chunk and its
           metadata; pass B re-derives the key);
           each child's seconds and peak RSS, the spill peak (sampled
           every 2 s), the resumed stage times; then seg_scan_or at the
           largest bucket's rows
  ooc_past_max_n
           the out-of-core tier where only it can go: synth_concat at
           4300 Mbp (N = 4,300,000,004, at least grouped.MAX_N, which
           the grouped tier refuses, and past 2^32) built whole by
           tests/torch_ooc_worker.py in a child that makes the text
           from its seed (65 chunks, 256 buckets, spill and
           checkpoints, check=True): the character counts, one '$' and
           3 '#', a 2^23-step LF walk from the end across position
           2^32, kernel 1 once a chunk, its gathered form once and
           kernel 2 three times a classification, no bucket oversized,
           at most 7.5 spill bytes a position, no file left, and the
           port's own hashes as first recorded (PAST_MAX_N_HASHES);
           sp_len and n_blue beside the 3000 Mbp row scaled, the stage
           split, the child's peak RSS and bytes written; then
           window_keys_at at the largest bucket's rows against its
           plain version, timed beside its bound
  dist     the multi-device tier (parallel.dist_build_bwt), one process a
           rank: through api.build(n_devices=1), one rank over NCCL at 4.6
           and 250 Mbp against the reference hashes (seconds, Mbp/s, stage
           times, peak device bytes a text position, kernel-1 launches);
           kernel 1 against its plain version and timed at the shard
           shapes of 250 Mbp on one and on two ranks; `python -m
           debwt_tpu_torch.cli --dist 1` in a subprocess at 4.6 Mbp, its
           files against the reference hashes; then two rank processes
           on the one card (tests/torch_dist_worker.py): NCCL is asked
           once to join both (its answer is printed), then gloo with host
           staging builds 4.6 Mbp (reference hashes), 40 Mbp (the fused
           engine's hashes) and the ooc x dist composition at 4.6 Mbp
           (sp_cap 2^12: sharded SP ranking; spilled with checkpoints,
           each rank under its own subdirectory; reference hashes); a
           failed rank fails the phase
  cli      the CLI (`debwt_tpu_torch.cli.main`, as `python -m
           debwt_tpu_torch.cli` runs it, one process a run, the kernels'
           launch counts printed after it returns): kernel 1 against its
           plain version and timed at w = 24 on the 140 Mbp N_cap; the
           140 Mbp collection written once as FASTA, read by
           read_collection, by read_fasta (the native parser) and by its
           NumPy parser, which must agree (timed); then the CLI on it
           once a route: fused, grouped (--check; DEBWT_SINGLE_MAX_ROWS
           under its rows and DEBWT_GROUPED_CAP 48,000,000: at least 4
           groups), out-of-core (--verify over the last 2^22 chars;
           DEBWT_SINGLE_MAX_ROWS and DEBWT_FORCE_OOC=1), --dist 1, and
           fused at -k 24; then -k 12 at 4.6 Mbp. Each run must exit 0,
           name its tier on its route line, launch the kernels as its
           printed plan says and write files with the reference hashes
           (ref_mbp140.0, ref_mbp140.0_m24 for -k 24, ref_mbp4.6)

After the phases, one line gives the GiB each phase wrote to disk,
its children's included, and their total; bytes that went to a tmpfs
are counted apart. The lines before the last
are the `kernels` JSON object and the card's name and power limit; the
last is {"ok": true, "device": {...}}.
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
EXPECTED_LAUNCHES = {"window_keys": 1, "window_keys_at": 0, "seg_scan_or": 4}
SEL_C = 1 << 27             # the grouped tier's default selection chunk
SEL_R = SEL_C + 33          # its separator scan: C + k + 2 words at m = 32
CLS_R = 402_653_184 + 64    # a classification: 600 Mbp in 2 groups + ns_cap
GROUPED_MBP = 140.0         # against the reference hashes, in >= 4 groups
GROUPED_CAP = 48_000_000
GROUPED_CHUNK = 1 << 25
FULL_MBP = 600.0            # rows_needed > 2^29: over any card's bound
OOC_CHUNK = 1 << 26         # OocConfig().chunk
OOC_SPILL_MBP = 140.0       # spilled, interrupted and resumed
VERIFY_STEPS = 1 << 22
DIST_MBP = (4.6, 250.0)     # one rank over NCCL, against the reference
DIST_GLOO_MBP = 40.0        # two ranks on one card, against the fused engine
OOC_DIST_SP_CAP = 1 << 12   # under 4.6 Mbp's 33,979 SP events: sharded ranking
GENOME_MBP = 3000.0         # synth_concat: .bench_cache.json grouped_mbp3000.0
GENOME_MIN_R = (1 << 29) - (1 << 20)   # its classification reaches the scan bound
# the port's own hashes of that build, as first recorded; not the
# reference binary's
GENOME_HASHES = (
    "9de95ddf21d8dce6b441465b6035964d0e722f1f149b6bcaf52a00c4f2090d97",
    "eb56453b5bee26e43351f6794c7487aed1cd92e007bbc3d52680624f4b2e6eef",
    2_733_368_556)
# the kill-and-resume rehearsal: tools/rehearse_ooc.py's knobs, at 600 Mbp
# of its 1000 so that the script keeps to its time with the genome phase's
# CLI process
OOC_REHEARSAL_MBP = 600.0
OOC_REHEARSAL_BUCKETS = 256
OOC_REHEARSAL_KILL_AT = 128  # SIGKILL once the manifest reaches this bucket
OOC_SPILL_BYTES = 8         # disk bytes a position: 6 of bucket rows, the
#                             output's 1, the rehearsal's saved text's 1
OOC_SPILL_MAX = 7.5         # most spill bytes a position at the peak
OOC_CHILD_TIMEOUT = 600     # seconds an out-of-core child may take
# the out-of-core tier where only it can go: synth_concat at 4300 Mbp,
# N = 4,300,000,004 >= grouped.MAX_N and > 2^32, one whole build in a
# child (tools/bench_ooc.py's knobs), an LF walk across position 2^32
PAST_MAX_N_MBP = 4300.0
PAST_MAX_N = 4_300_000_004
PAST_MAX_N_VERIFY_STEPS = 1 << 23
PAST_MAX_N_TIMEOUT = 900    # seconds its child may take
# the port's own hashes of that build, as first recorded; not the
# reference binary's
PAST_MAX_N_HASHES = (
    "4b3fcc8fe112a7fcc7e9939ed8e3e489a9339d209fb89319e6b0b5792bfba972",
    "1cf0b555652fbc363729e68f3b9d788462f164b3b6600b065efa5852a51459ee",
    3_917_836_742)
RANK_TIMEOUT = 600          # seconds a rank process may take
CLI_MBP = 140.0             # the cli phase's FASTA: every tier's CLI run
CLI_SMALL_MBP = 4.6         # -k 12
CLI_TIMEOUT = 300           # seconds a CLI process may take
CLI_GENOME_TIMEOUT = 600    # seconds the genome phase's CLI process may take
GENOME_PLAN = (7, 23)       # its groups and selection chunks at R near 2^29


def say(*a):
    print(*a, flush=True)


# bytes a phase wrote that this process's own /proc entry does not hold:
# its children's (their /proc/<pid>/io wchar, as they report it or as
# it was last sampled) and an out-of-core build's spilled output, a
# mapped file whose N bytes are all written; and, of the bytes counted
# so, those that went to a tmpfs, not to the disk (main reads the deltas)
_WRITTEN = {"children_wchar": 0, "mapped": 0, "tmpfs": 0}


def note_written(children_wchar: int = 0, mapped: int = 0, tmpfs: int = 0):
    _WRITTEN["children_wchar"] += children_wchar
    _WRITTEN["mapped"] += mapped
    _WRITTEN["tmpfs"] += tmpfs


def disk_bytes(w: dict) -> int:
    """The disk bytes of one phase's tally: every write counted, less
    those that went to a tmpfs."""
    return w["own_wchar"] + w["children_wchar"] + w["mapped"] - w["tmpfs"]


def own_wchar() -> int:
    """Bytes this thread has passed to write calls: its own /proc task
    entry, which holds no child's (/proc/self/io adds a reaped child's
    on some kernels and not on others)."""
    import threading

    from torch_ooc_worker import io_bytes

    return io_bytes(f"self/task/{threading.get_native_id()}").get("wchar", 0)


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
    logs = _build.build_all(_build.SOURCES + _build.HOST_SOURCES)
    say(f"[build] {len(_build.SOURCES)} kernel libraries and "
        f"{len(_build.HOST_SOURCES)} host helpers in "
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
        for off in (1, 3):              # slices of words (the grouped tier)
            if n_out > 16 * off:
                wk.check(window_keys_packed(x2w[off:], w, n_out - 16 * off),
                         want[16 * off:],
                         f"packed x2w[{off}:] n_out={n_out} w={w}")
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
    # the grouped tier's call: a chunk of SEL_C keys from a slice that
    # starts at the chunk's word (1 is the prologue's word: 4 bytes off
    # a 16-byte boundary)
    for off in (1, 7, SEL_C // 16 // 4):
        wk.check(window_keys_packed(x2w[off:], w, SEL_C),
                 want[16 * off : 16 * off + SEL_C],
                 f"packed x2w[{off}:] n_out={SEL_C} w={w}")
    del want
    sel_words = x2w[1 : 1 + (SEL_C + 48) // 16]
    ms_sel = cuda_ms(lambda: window_keys_packed(sel_words, w, SEL_C), reps=20)
    plain_sel = cuda_ms(lambda: window_keys_packed_plain(sel_words, w, SEL_C),
                        reps=3, warm=1)
    b_sel, b_sel_by = bound_ms((SEL_C + w - 1) / 4 + 8 * SEL_C, 3 * SEL_C)
    del sel_words
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
        grouped_shapes=[dict(
            shape=f"packed words from x2w[1:], n_out {SEL_C}, w {w}",
            ms=ms_sel, plain_ms=plain_sel, bound_ms=b_sel, bound_by=b_sel_by)],
        # the fused engine's call: its T-padded uint8 codes, already on
        # the card, through the byte entry
        fused_shape=dict(
            shape=f"uint8 codes x2p[:N + w - 1], n_out {n_out}, w {w}",
            ms=ms_u8, plain_ms=plain_u8, bound_ms=b_u8, bound_by=b_u8_by),
    )
    say(f"[kernels] window_keys packed loader on the word slice x2w[1:] "
        f"n_out={SEL_C} w={w}: {ms_sel:.4f} ms (bound {b_sel:.4f} ms by "
        f"{b_sel_by}, plain {plain_sel:.4f} ms)")
    say(f"[kernels] window_keys uint8 loader (the fused engine's entry) "
        f"n_out={n_out} w={w}: "
        f"{ms_u8:.4f} ms, on x[1:] {ms_u8_off:.4f} ms "
        f"(bound {b_u8:.4f} ms by {b_u8_by}, plain {plain_u8:.4f} ms)")
    say(f"[kernels] window_keys packed loader n_out={n_out} w={w}: "
        f"{ms:.4f} ms, at w=8 {ms_w8:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
        f"plain {plain:.4f} ms; zero_ of the keys' bytes {fill:.4f} ms)")
    say(f"[kernels] window_keys: {wk.cases} cases equal")
    _window_keys_at_cases(dev, gen, rows)

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
    grouped_shapes = _grouped_scan_shapes(dev, gen, so)
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
        grouped_shapes=grouped_shapes,
    )
    for g in grouped_shapes:
        say(f"[kernels] seg_scan_or {g['shape']}: {g['ms']:.4f} ms "
            f"(bound {g['bound_ms']:.4f} ms by {g['bound_by']}, "
            f"plain {g['plain_ms']:.4f} ms)")
    for (stop, prefix, p_stop), (k_ms, p_ms) in timed.items():
        say(f"[kernels] seg_scan_or R={MAIN_R} stop=2^{stop.bit_length() - 1} "
            f"{'prefix' if prefix else 'suffix'} p_stop={p_stop}: {k_ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, plain {p_ms:.4f} ms)")
    say(f"[kernels] seg_scan_or: {so.cases} cases equal (every case twice); "
        f"clone of the words {copy:.4f} ms")
    torch.cuda.empty_cache()


def _bucket_positions(dev, gen, n_codes: int, R: int, chunk: int = OOC_CHUNK):
    """R int64 text positions laid out as an out-of-core bucket's rows:
    one ascending run a chunk of the text, about R / n_chunks rows each,
    drawn at random inside the chunk."""
    import torch

    n_chunks = -(-n_codes // chunk)
    per = -(-R // n_chunks)
    runs = []
    for ci in range(n_chunks):
        lo, hi = ci * chunk, min(n_codes, (ci + 1) * chunk)
        runs.append(torch.sort(torch.randint(lo, hi, (min(per, R - ci * per),),
                                             generator=gen, device=dev)).values)
    return torch.cat(runs)


def _window_keys_at_cases(dev, gen, rows: dict):
    """Kernel 1's gathered entry against its plain version, exact
    equality: at the CPU tests' shapes (random positions in no order,
    the first and the last whose window fits, windows past the words, a
    negative position) and on 2^20 rows laid out as a bucket's over a
    text of PAST_MAX_N codes, so that positions pass 2^32."""
    import torch

    from debwt_tpu_torch import ops
    from debwt_tpu_torch.kernels.window_keys import (
        window_keys_at, window_keys_at_plain, window_keys_plain,
    )

    wa = Parity("window_keys_at")
    for n_codes in (37, 4096, 5000, 200_003):
        for w in (2, 12, 24, 31, 32):
            x = torch.randint(0, 4, (n_codes,), generator=gen, device=dev,
                              dtype=torch.uint8)
            x2w = ops.pack_2bit_words(x)
            n_out = n_codes - w + 1
            pos = torch.cat([
                torch.randint(0, n_out, (5000,), generator=gen, device=dev),
                torch.tensor([0, n_out - 1, n_codes - 1, 16 * x2w.shape[0] + 7,
                              -3], device=dev)])
            got = window_keys_at(x2w, pos, w)
            wa.check(got, window_keys_at_plain(x2w, pos, w),
                     f"n_codes={n_codes} w={w}")
            wa.check(got[:5000], window_keys_plain(x, w, n_out)[pos[:5000]],
                     f"n_codes={n_codes} w={w} against every window's key")
    words = _random_words(dev, gen, PAST_MAX_N + 32)
    pos = _bucket_positions(dev, gen, PAST_MAX_N, 1 << 20)
    assert int(pos.max()) >= 1 << 32
    wa.check(window_keys_at(words, pos, 31), window_keys_at_plain(words, pos, 31),
             f"2^20 bucket rows of a {PAST_MAX_N}-code text, w 31")
    del words, pos
    rows["window_keys_at"] = dict(
        name="window_keys_at", route="cuda",
        source="src/debwt_tpu_torch/csrc/window_keys.cu",
        replaces="src/debwt_tpu/kernels/window_keys.py:98",
        launches=None, max_abs_err=wa.max_abs_err, ms=None, plain_ms=None,
        bound_ms=None, bound_by=None, library_ms=None)
    say(f"[kernels] window_keys_at: {wa.cases} cases equal")
    torch.cuda.empty_cache()


def _random_words(dev, gen, n_codes: int):
    """The packed words of n_codes random codes (every bit random)."""
    import torch

    return torch.randint(-(1 << 31), 1 << 31, (-(-n_codes // 16),),
                         generator=gen, device=dev, dtype=torch.int32)


def _scan_shape(so: Parity, words, stop: int, prefix: bool, shape: str) -> dict:
    """seg_scan_or on `words` checked against its plain version, then
    timed beside the bound and the plain version's time."""
    from debwt_tpu_torch.kernels import seg_or

    got = seg_or.seg_scan_or(words, stop_bit=stop, prefix=prefix)
    so.check(got, seg_or.seg_scan_or_plain(words, stop, prefix), shape)
    del got
    R = words.shape[0]
    b_ms, b_by = bound_ms(8 * R, 3 * R)
    return dict(
        shape=shape,
        ms=cuda_ms(lambda: seg_or.seg_scan_or(words, stop_bit=stop,
                                              prefix=prefix), reps=10),
        plain_ms=cuda_ms(lambda: seg_or.seg_scan_or_plain(words, stop, prefix),
                         reps=2, warm=1),
        bound_ms=b_ms, bound_by=b_by)


def _classification_scans(dev, gen, so: Parity, R: int, what: str) -> list:
    """The scans of one classification of R sorted rows
    (engine.segment_facts): the suffix OR of the presence bits under
    stop bit 2^6, and a prefix broadcast of row indices under 2^29 (the
    facts' broadcast has the same shape and stop)."""
    import torch

    POS = 1 << 29
    newseg = torch.rand(R, generator=gen, device=dev) < 0.3
    newseg[0] = True
    bits = torch.randint(0, 64, (R,), generator=gen, device=dev,
                         dtype=torch.int32)
    stop = torch.cat([newseg[1:], newseg.new_ones(1)])
    out = [_scan_shape(so, bits | (stop.to(torch.int32) << 6), 1 << 6, False,
                       f"{what} R={R} suffix 2^6")]
    del bits, stop
    idx = torch.arange(R, dtype=torch.int32, device=dev)
    out.append(_scan_shape(
        so, torch.where(newseg, idx, 0) | (newseg.to(torch.int32) << 29), POS,
        True, f"{what} R={R} prefix 2^29"))
    return out


def _grouped_scan_shapes(dev, gen, so: Parity) -> list:
    """seg_scan_or at the grouped tier's shapes, checked and timed: the
    selection's separator scan (R = C + k + 2, not a multiple of 4:
    the ragged scalar path; position words under stop bit 2^29, a
    separator every few hundred to few million rows) and the three
    scans of a classification (R = cap_run + ns_cap)."""
    import torch

    POS = 1 << 29
    out = []
    idx = torch.arange(SEL_R, dtype=torch.int32, device=dev)
    for every in (300, 30_000, 3_000_000):
        is_sep = torch.rand(SEL_R, generator=gen, device=dev) < 1.0 / every
        is_sep[-1] = True
        out.append(_scan_shape(
            so, torch.where(is_sep, idx | POS, 0), POS, False,
            f"selection R={SEL_R} suffix 2^29, a separator every {every} rows"))
    del idx, is_sep
    return out + _classification_scans(dev, gen, so, CLS_R, "classification")


def _counters():
    from debwt_tpu_torch.kernels import seg_or, window_keys

    return {"window_keys": window_keys.window_keys,
            "window_keys_at": window_keys.window_keys_at,
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
    from debwt_tpu_torch.grouped import build_bwt_grouped
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
    # the grouped tier on the same collection, bit for bit: only the
    # first result's hashes are kept, the two do not fit together
    fused = _hashes(r)
    del r
    torch.cuda.empty_cache()
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g = build_bwt_grouped(coll, config, stats=stats, device=dev)
    dt = time.perf_counter() - t0
    if _hashes(g) != fused:
        raise AssertionError(
            f"{NEAR_BOUND_MBP} Mbp: the grouped tier differs from the fused engine"
        )
    R = stats["cap_run"] + stats["ns_cap"]
    reserved = torch.cuda.max_memory_reserved()
    say(json.dumps({
        "near_bound_grouped_equals_fused": True, "build_s": dt,
        **_plan_of(stats), "stage_s": stats["stage_s"],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": reserved, "rows_largest_group": R,
        "peak_reserved_bytes_per_group_row": reserved / R,
    }))
    del g, coll
    torch.cuda.empty_cache()


def _hashes(r) -> tuple:
    import numpy as np

    return (hashlib.sha256(r.packed()).hexdigest(),
            hashlib.sha256(r.sharp_pos.astype(np.int64).tobytes()).hexdigest(),
            int(r.dollar_pos))


def _plan_of(stats: dict) -> dict:
    keys = ("n_groups", "cap", "cap_run", "chunk", "n_chunks", "ns_cap",
            "sp_len", "n_blue", "attempts", "groups_selected",
            "groups_classified", "launches", "select_peak_bytes")
    return {k: stats[k] for k in keys}


def _text_bytes(chunk: int, n_chunks: int) -> int:
    """Device bytes of the grouped tier's resident packed text."""
    E = chunk + 32 + 15
    return (16 + (n_chunks - 1) * chunk + E + (-E) % 16) // 4


def _check_grouped_counts(stats: dict, counts: dict, what: str):
    """Launches against the plan: kernel 1 once a chunk of every group
    scanned, kernel 2 once a chunk too and three times a group
    classified; none from the back half. The wrappers' counters and the
    build's own tally must both agree."""
    sel = stats["groups_selected"] * stats["n_chunks"]
    want = {"window_keys": sel,
            "seg_scan_or": sel + 3 * stats["groups_classified"]}
    if (counts != dict(want, window_keys_at=0) or stats["launches"] != want
            or min(want.values()) < 1):
        raise AssertionError(
            f"{what}: launches {counts} (tally {stats['launches']}), plan {want}"
        )


def phase_verify_count(dev):
    """lf_verify accepts the 4.6 Mbp result and rejects a copy with one
    flipped character; count_kmers equals a host count."""
    import numpy as np
    import torch

    from debwt_tpu_torch import count_kmers
    from debwt_tpu_torch.api import build
    from debwt_tpu_torch.pipeline import BwtResult
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig
    from debwt_tpu_torch.verify import _FAST_N, lf_verify

    m = 32
    coll = synth_collection(min(E2E_MBP))
    N = coll.bwt_len
    assert N < _FAST_N
    r = build(coll, PipelineConfig(m=m), device=dev)
    t0 = time.perf_counter()
    if not lf_verify(r, coll):
        raise AssertionError("lf_verify rejects the 4.6 Mbp result")
    t_ok = time.perf_counter() - t0
    bad = r.bwt6.copy()
    bad[int(np.nonzero(bad < 4)[0][N // 3])] ^= 1
    if lf_verify(BwtResult.from_bwt6(torch.from_numpy(bad), coll.n_reads), coll):
        raise AssertionError("lf_verify accepts a BWT with a flipped character")
    say(json.dumps({"lf_verify_mbp": min(E2E_MBP), "n": N, "walker": "native",
                    "path": "full LF permutation", "accepts_result": True,
                    "rejects_flipped_char": True, "full_walk_s": t_ok}))
    del r, bad

    # host count: the key of every separator-free m-window of coll.x2
    x2p = np.concatenate([coll.x2, np.full(m, 3, np.uint8)])
    pos = np.arange(N)
    dist = coll.sep[np.searchsorted(coll.sep, pos)] - pos
    mainp = np.nonzero(dist >= m)[0]
    key = np.zeros(mainp.shape[0], np.uint64)
    for i in range(m):
        key = (key << np.uint64(2)) | x2p[mainp + i].astype(np.uint64)
    want_k, want_c = np.unique(key, return_counts=True)
    _reset_counts()
    t0 = time.perf_counter()
    got_k, got_c = count_kmers(coll, m, device=dev)
    dt = time.perf_counter() - t0
    counts = _read_counts()
    if counts != {"window_keys": 1, "window_keys_at": 0, "seg_scan_or": 0}:
        raise AssertionError(f"count_kmers: launches {counts}")
    if not (got_k.dtype == np.uint64 and np.array_equal(got_k, want_k)
            and np.array_equal(got_c, want_c)):
        raise AssertionError("count_kmers differs from the host count")
    say(json.dumps({"count_kmers_mbp": min(E2E_MBP), "m": m,
                    "distinct": int(got_k.shape[0]), "total": int(got_c.sum()),
                    "equals_host_count": True, "seconds": dt,
                    "launches": counts}))


def phase_grouped(dev, rows: dict):
    """The grouped tier: 140 Mbp in at least 4 groups and 4 chunks
    against the reference hashes, a profile of one such build, then
    600 Mbp at full width through api.build. Returns the 600 Mbp
    collection and its hashes, which the ooc phase builds again."""
    import torch

    from debwt_tpu_torch import api, grouped
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig
    from debwt_tpu_torch.verify import _FAST_N, lf_verify

    cache = json.loads((ROOT / ".bench_cache.json").read_text())
    ref = cache[f"ref_mbp{GROUPED_MBP}"]
    coll = synth_collection(GROUPED_MBP)
    n_bases = coll.bwt_len - coll.n_reads
    gcfg = grouped.GroupedConfig(cap=GROUPED_CAP, chunk=GROUPED_CHUNK)
    config = PipelineConfig(m=32)
    times = []
    for rep in range(2):                # one warm-up, then one timed build
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        r = grouped.build_bwt_grouped(coll, config, gcfg, stats=stats, device=dev)
        packed = r.packed()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = _read_counts()
        if stats["n_groups"] < 4 or stats["n_chunks"] < 4 or stats["attempts"] != 1:
            raise AssertionError(f"grouped {GROUPED_MBP} Mbp: plan {_plan_of(stats)}")
        _check_grouped_counts(stats, counts, f"grouped {GROUPED_MBP} Mbp")
        if _hashes(r) != (ref["obj_sha"], ref["sharp_sha"], ref["dollar"]):
            raise AssertionError(
                f"grouped {GROUPED_MBP} Mbp: output differs from the reference hashes"
            )
        del packed
    R = stats["cap_run"] + stats["ns_cap"]
    peak, reserved = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved())
    say(json.dumps({
        "grouped_mbp": GROUPED_MBP, "n": coll.bwt_len, "m": 32,
        "hashes_equal_reference": True, **_plan_of(stats),
        "build_s": times[-1], "warmup_s": times[0],
        "mbps": n_bases / 1e6 / times[-1], "stage_s": r.timings,
        "peak_bytes": peak, "peak_reserved_bytes": reserved,
        "rows_largest_group": R, "kernels_phase_classification_rows": CLS_R,
        "peak_reserved_bytes_per_group_row": reserved / R,
    }))
    # the bounded walk on the sampled-occ path also at this size
    assert coll.bwt_len >= _FAST_N
    t0 = time.perf_counter()
    if not lf_verify(r, coll, max_steps=VERIFY_STEPS):
        raise AssertionError(f"grouped {GROUPED_MBP} Mbp: the LF walk fails")
    say(json.dumps({"lf_verify_mbp": GROUPED_MBP, "n": coll.bwt_len,
                    "walker": "native", "path": "sampled occ table",
                    "steps": VERIFY_STEPS, "ok": True,
                    "seconds": time.perf_counter() - t0}))
    del r
    profile_build(
        lambda: grouped.build_bwt_grouped(coll, config, gcfg, device=dev).packed(),
        f"grouped {GROUPED_MBP}",
    )
    del coll
    torch.cuda.empty_cache()

    # ---- the tier's main path at full width, through api.build ----
    t0 = time.perf_counter()
    coll = synth_collection(FULL_MBP)
    t_synth = time.perf_counter() - t0
    config = PipelineConfig(m=32, check=True)
    n_rows, bound = api.rows_needed(coll, config.m), api.single_rows_bound(dev)
    if n_rows < bound:
        raise AssertionError(f"{FULL_MBP} Mbp is under the single-device bound")
    free, _total = torch.cuda.mem_get_info(dev)
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    # check: character counts; stats: the plan the grouped tier ran
    r = api.build(coll, config, device=dev, stats=stats)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    if not stats or "groups.select" not in r.timings:
        raise AssertionError(f"{FULL_MBP} Mbp did not take the grouped tier")
    _check_grouped_counts(stats, counts, f"grouped {FULL_MBP} Mbp")
    for name, n in counts.items():
        rows[name]["launches_fused_build"] = rows[name]["launches"]
        rows[name]["launches"] = n
    bwt6 = r.bwt6
    if not (bwt6.shape[0] == coll.bwt_len and int((bwt6 == 5).sum()) == 1
            and bwt6[r.dollar_pos] == 5
            and r.sharp_pos.shape[0] == coll.n_reads - 1
            and int((bwt6 == 4).sum()) == coll.n_reads - 1):
        raise AssertionError(f"{FULL_MBP} Mbp: the '$' or '#' counts are wrong")
    R = stats["cap_run"] + stats["ns_cap"]
    peak, reserved = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved())
    text_bytes = _text_bytes(stats["chunk"], stats["n_chunks"])
    say(json.dumps({
        "grouped_full_mbp": FULL_MBP, "n": coll.bwt_len, "m": 32,
        "rows_needed": n_rows, "single_rows_bound": bound, "free_bytes": free,
        "route": "grouped", "character_counts_equal": True,
        **_plan_of(stats), "build_s": dt,
        "mbps": (coll.bwt_len - coll.n_reads) / 1e6 / dt, "stage_s": r.timings,
        "unmarked_s": dt - sum(v for k_, v in r.timings.items()
                               if not k_.startswith("groups.")),
        "peak_bytes": peak, "peak_reserved_bytes": reserved,
        "rows_largest_group": R, "kernels_phase_classification_rows": CLS_R,
        "peak_reserved_bytes_per_group_row": reserved / R,
        "peak_reserved_less_text_per_group_row": (reserved - text_bytes) / R,
        "group_bytes_per_row_constant": grouped._GROUP_BYTES_PER_ROW,
        "synth_s": t_synth,
    }))
    assert coll.bwt_len >= _FAST_N
    t0 = time.perf_counter()
    if not lf_verify(r, coll, max_steps=VERIFY_STEPS):
        raise AssertionError(f"{FULL_MBP} Mbp: the LF walk fails")
    say(json.dumps({"lf_verify_mbp": FULL_MBP, "n": coll.bwt_len,
                    "walker": "native", "path": "sampled occ table",
                    "steps": VERIFY_STEPS, "ok": True,
                    "seconds": time.perf_counter() - t0}))
    hashes = _hashes(r)
    del r, bwt6
    torch.cuda.empty_cache()
    return coll, hashes


class RssPeak:
    """The peak resident set of this process while the `with` block
    runs, sampled from /proc/self/statm every 50 ms by a thread (not
    every kernel's /proc/self/status has the high-water mark VmHWM, nor
    lets it be reset). `bytes` stays None where statm cannot be read."""

    def __init__(self):
        import threading

        self.bytes = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _now():
        import os

        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while True:
            try:
                self.bytes = max(self.bytes or 0, self._now())
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


class _Interrupted(Exception):
    pass


def _check_ooc_counts(stats: dict, counts: dict, what: str, resumed=False):
    """Launches against the plan: kernel 1 once a chunk (none on a
    resume past pass A), its gathered form once and kernel 2 three times
    a device classification (no bucket oversized)."""
    want = {"window_keys": 0 if resumed else stats["n_chunks"],
            "window_keys_at": stats["classifications"],
            "seg_scan_or": 3 * stats["classifications"]}
    if counts != want or stats["launches"] != want or want["seg_scan_or"] < 3:
        raise AssertionError(
            f"{what}: launches {counts} (tally {stats['launches']}), plan {want}"
        )


def _ooc_plan(stats: dict) -> dict:
    keys = ("bucket_cap", "chunk", "n_chunks", "n_buckets", "max_bucket_rows",
            "classifications", "oversized_buckets", "sp_len", "n_blue",
            "launches")
    return {k: stats[k] for k in keys}


def phase_ooc(dev, rows: dict, coll, hashes):
    """The out-of-core tier (oocore.build_bwt_ooc), called directly:
    the grouped phase's 600 Mbp collection with the default knobs (9
    chunks, 64 buckets in host DRAM) against the grouped tier's hashes;
    then 140 Mbp spilled to disk with checkpoints, interrupted in pass B
    and resumed, against the reference hashes; then both kernels at the
    shapes this tier gives them."""
    import os
    import resource
    import tempfile

    import torch

    from debwt_tpu_torch import oocore
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig

    config = PipelineConfig(m=32)
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        r = oocore.build_bwt_ooc(coll, config, oocore.OocConfig(), stats,
                                 device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = _read_counts()
    _check_ooc_counts(stats, counts, f"ooc {FULL_MBP} Mbp")
    # 600 Mbp: 9 chunks of 2^26
    if (stats["n_chunks"], stats["n_buckets"]) != (-(-coll.bwt_len // OOC_CHUNK), 64):
        raise AssertionError(f"ooc {FULL_MBP} Mbp: plan {_ooc_plan(stats)}")
    if _hashes(r) != hashes:
        raise AssertionError(f"ooc {FULL_MBP} Mbp: differs from the grouped tier")
    bwt6 = r.bwt6
    if not (int((bwt6 == 5).sum()) == 1
            and int((bwt6 == 4).sum()) == coll.n_reads - 1 == r.sharp_pos.shape[0]):
        raise AssertionError(f"ooc {FULL_MBP} Mbp: the '$' or '#' counts are wrong")
    for name, n in counts.items():
        rows[name]["launches_ooc"] = n
    say(json.dumps({
        "ooc_mbp": FULL_MBP, "n": coll.bwt_len, "m": 32,
        "hashes_equal_grouped": True, **_ooc_plan(stats), "build_s": dt,
        "mbps": (coll.bwt_len - coll.n_reads) / 1e6 / dt,
        "stage_s": stats["stage_s"],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
        "host_peak_rss_bytes": rss.bytes,
        "ru_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
    }))
    R_bucket = stats["max_bucket_rows"]
    del r, bwt6, coll
    torch.cuda.empty_cache()

    # ---- 140 Mbp through disk spill with checkpoints, interrupted ----
    cache = json.loads((ROOT / ".bench_cache.json").read_text())
    ref = cache[f"ref_mbp{OOC_SPILL_MBP}"]
    coll = synth_collection(OOC_SPILL_MBP)
    real = oocore._classify_bucket
    seen = {"calls": 0, "spill_peak": 0, "spill_peak_apparent": 0}

    with tempfile.TemporaryDirectory(prefix="debwt_ooc_") as d:
        ooc = oocore.OocConfig(spill_dir=d, checkpoint=True)
        crash_at = ooc.n_buckets // 2 + 1

        def spy(*a):
            seen["calls"] += 1
            sts = [os.stat(os.path.join(d, f)) for f in os.listdir(d)]
            seen["spill_peak"] = max(seen["spill_peak"],
                                     sum(st.st_blocks * 512 for st in sts))
            seen["spill_peak_apparent"] = max(seen["spill_peak_apparent"],
                                              sum(st.st_size for st in sts))
            if seen["calls"] == crash_at:
                raise _Interrupted(f"interrupted at classification {crash_at}")
            return real(*a)

        oocore._classify_bucket = spy
        try:
            t0 = time.perf_counter()
            try:
                oocore.build_bwt_ooc(coll, config, ooc, device=dev)
                raise AssertionError("the spill build was not interrupted")
            except _Interrupted:
                t_first = time.perf_counter() - t0
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            if (manifest["stage"], manifest["next_bucket"]) != ("B", crash_at - 1):
                raise AssertionError(f"ooc spill: manifest {manifest} at the interrupt")
            stats = {}
            _reset_counts()
            t0 = time.perf_counter()
            r = oocore.build_bwt_ooc(coll, config, ooc, stats, device=dev)
            torch.cuda.synchronize()
            t_resume = time.perf_counter() - t0
            counts = _read_counts()
            left = sorted(os.listdir(d))
        finally:
            oocore._classify_bucket = real
        _check_ooc_counts(stats, counts, f"ooc {OOC_SPILL_MBP} Mbp resume",
                          resumed=True)
        if _hashes(r) != (ref["obj_sha"], ref["sharp_sha"], ref["dollar"]):
            raise AssertionError(
                f"ooc {OOC_SPILL_MBP} Mbp resumed: differs from the reference hashes"
            )
        if left:
            raise AssertionError(f"ooc spill: files left: {left[:5]}")
        if stats["classifications"] != seen["calls"] - crash_at:
            raise AssertionError("ooc spill: the resume redid finished buckets")
        note_written(mapped=coll.bwt_len)
        for name, n in counts.items():
            rows[name]["launches_ooc_resume"] = n
        say(json.dumps({
            "ooc_spill_mbp": OOC_SPILL_MBP, "n": coll.bwt_len, "m": 32,
            "hashes_equal_reference": True, "interrupted_at_bucket": crash_at - 1,
            **_ooc_plan(stats), "first_run_s": t_first, "resume_s": t_resume,
            "stage_s_resume": stats["stage_s"],
            "spill_peak_bytes": seen["spill_peak"],
            "spill_peak_apparent_bytes": seen["spill_peak_apparent"],
            "files_left": 0,
        }))
        del r
    del coll
    torch.cuda.empty_cache()
    _ooc_kernel_shapes(dev, rows, R_bucket)


def _ooc_kernel_shapes(dev, rows: dict, R_bucket: int):
    """Both kernels at the out-of-core tier's shapes, checked against
    their plain versions and timed: window_keys' packed entry on one
    chunk's freshly packed words at w = 31 (m = 32) and w = 11 (m = 12),
    and the classification scans at the largest bucket's rows."""
    import numpy as np
    import torch

    from debwt_tpu_torch import ops
    from debwt_tpu_torch.kernels.window_keys import (
        window_keys_packed, window_keys_packed_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    wk, so = Parity("window_keys"), Parity("seg_scan_or")
    C = OOC_CHUNK
    shapes = []
    for w in (31, 11):
        buf = np.random.default_rng(w).integers(0, 4, C + w, dtype=np.uint8)
        kw = torch.from_numpy(ops.pack_2bit_words_host(buf).view("int32")).to(dev)
        what = f"packed words of one chunk, n_out {C}, w {w}"
        wk.check(window_keys_packed(kw, w, C), window_keys_packed_plain(kw, w, C),
                 what)
        b_ms, b_by = bound_ms((C + w - 1) / 4 + 8 * C, 3 * C)
        shapes.append(dict(
            shape=what, ms=cuda_ms(lambda: window_keys_packed(kw, w, C), reps=20),
            plain_ms=cuda_ms(lambda: window_keys_packed_plain(kw, w, C),
                             reps=3, warm=1),
            bound_ms=b_ms, bound_by=b_by))
        del kw
    rows["window_keys"]["ooc_shapes"] = shapes
    rows["seg_scan_or"]["ooc_shapes"] = _classification_scans(
        dev, gen, so, R_bucket, "ooc bucket")
    for name, par in (("window_keys", wk), ("seg_scan_or", so)):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], par.max_abs_err)
        for g in rows[name]["ooc_shapes"]:
            say(f"[kernels] {name} {g['shape']}: {g['ms']:.4f} ms "
                f"(bound {g['bound_ms']:.4f} ms by {g['bound_by']}, "
                f"plain {g['plain_ms']:.4f} ms)")
        say(f"[kernels] {name} at the ooc shapes: {par.cases} cases equal")
    torch.cuda.empty_cache()


def phase_genome(dev, rows: dict):
    """The CLI at genome scale: tools/bench_ooc.py's synth_concat text at
    3000 Mbp (N = 3,000,000,004, so positions run past 2^31) written as
    FASTA to a tmpfs with room (else gzip-compressed to disk), then one
    `python -m debwt_tpu_torch.cli` process on it (--check --timings
    --verify --verify-steps 2^22, DEBWT_TRACE=1 and no routing variable:
    the route a user gets). It must take the grouped tier at
    GENOME_PLAN with a classification at the scan bound, launch the
    kernels as its plan says, trace .bench_cache.json grouped_mbp3000.0's
    SP length and blue count (the JAX package's grouped and out-of-core
    tiers agreed on them), pass the check and the LF walk, and write
    files with the port's recorded hashes, one '$' and n_reads - 1 '#';
    then seg_scan_or at its classification rows, in this process."""
    import tempfile

    import torch

    from debwt_tpu_torch import grouped, oocore
    from debwt_tpu_torch.synth import synth_concat_codes

    want = json.loads((ROOT / ".bench_cache.json").read_text())[
        f"grouped_mbp{GENOME_MBP}"]
    what = f"cli genome {GENOME_MBP} Mbp"
    n_est = int(GENOME_MBP * 1e6) + 4
    need = int(1.3 * (n_est * 81 // 80 + n_est // 4 + (64 << 20)))
    mounts = _tmpfs_mounts()
    say(json.dumps({"genome_tmpfs_mounts": mounts, "need_bytes": need}))
    room = [m["mount"] for m in mounts if m["free_bytes"] >= need]
    medium = "tmpfs" if room else "gz on disk"
    with tempfile.TemporaryDirectory(prefix="debwt_cli_genome_",
                                     dir=room[0] if room else None) as d:
        fa = Path(d) / ("genome.fa" if room else "genome.fa.gz")
        made = _write_fasta(fa, GENOME_MBP, synth_concat_codes)
        N, fa_bytes = made["n"], fa.stat().st_size
        if N <= 1 << 31:
            raise AssertionError(f"{what}: N = {N} does not pass 2^31")
        oocore._malloc_trim()           # the codes and the text are freed
        torch.cuda.empty_cache()
        free, _total = torch.cuda.mem_get_info(dev)
        run = _run_cli(fa, ["--check", "--timings", "--verify", "--verify-steps",
                            str(VERIFY_STEPS)], {}, dev,
                       dict(zip(("obj_sha", "sharp_sha", "dollar"), GENOME_HASHES)),
                       timeout=CLI_GENOME_TIMEOUT)
        if room:
            note_written(tmpfs=fa_bytes + sum(run["file_bytes"].values()))
    for ln in run["route"] + run["plan"]:
        say(f"[genome] {ln}")
    _check_cli_run("grouped_genome", run)
    G, cap_run, C, n_chunks, ns_cap = _grouped_plan(run)
    R = cap_run + ns_cap
    if "groups.select" not in run["stage_s"] or (G, n_chunks) != GENOME_PLAN:
        raise AssertionError(f"{what}: plan G {G} x {n_chunks} chunks, stages "
                             f"{list(run['stage_s'])}; want {GENOME_PLAN}")
    if R < GENOME_MIN_R:
        raise AssertionError(
            f"{what}: classification rows {R} under {GENOME_MIN_R}: the "
            "default cap no longer reaches the scan bound")
    if (run["sp_len"], run["n_blue"]) != (want["sp_len"], want["n_blue"]):
        raise AssertionError(
            f"{what}: sp_len {run['sp_len']} and n_blue {run['n_blue']}, "
            f"the JAX package's {want['sp_len']} and {want['n_blue']}")
    if run["verify"] != ["[debwt-torch] LF invertibility: OK"]:
        raise AssertionError(f"{what}: {run['verify']}")
    sharp, dollar = run["sharp_pos"], run["hashes"]["dollar"]
    if not (len(sharp) == made["n_reads"] - 1 and dollar == GENOME_HASHES[2]
            and run["file_bytes"][""] == 8 * ((N + 31) // 32)):
        raise AssertionError(f"{what}: sidecars {sharp}, {dollar}, files "
                             f"{run['file_bytes']}")
    for name, n in run["launches"].items():
        rows[name]["launches_genome"] = n
    proc = run["process"]
    reserved = proc["max_memory_reserved"]
    text_bytes = _text_bytes(C, n_chunks)
    say(json.dumps({
        "cli_genome": True, "genome_mbp": GENOME_MBP, "n": N, "m": 32,
        "input": "synth_concat", "fasta_medium": medium, "fasta_bytes": fa_bytes,
        "fasta_mount": room[0] if room else None, "synth_s": made["synth_s"],
        "fasta_write_s": made["write_s"], "free_bytes": free,
        "route": "grouped", "character_counts_equal": True,
        "sp_len_n_blue_equal_jax": [want["sp_len"], want["n_blue"]],
        "n_groups": G, "cap_run": cap_run, "chunk": C, "n_chunks": n_chunks,
        "ns_cap": ns_cap, "sp_len": run["sp_len"], "n_blue": run["n_blue"],
        "launches": run["launches"],
        "rows_largest_group": R, "process_s": run["process_s"],
        "ingest_s": run["ingest_s"], "build_s": run["build_s"],
        "write_s": proc["write_s"], "verify_s": proc["verify_s"],
        "verify_steps": VERIFY_STEPS,
        "start_s": proc["start_s"], "torch_import_s": proc["torch_import_s"],
        "imports_s": proc["imports_s"], "cuda_context_s": proc.get("cuda_context_s"),
        "exit_s": proc["exit_s"],
        "other_s": run["process_s"] - run["ingest_s"] - run["build_s"]
        - proc["write_s"] - proc["verify_s"] - proc["start_s"] - proc["imports_s"]
        - proc.get("cuda_context_s", 0) - proc["exit_s"],
        "mbps": (N - made["n_reads"]) / 1e6 / run["build_s"],
        "stage_s": run["stage_s"],
        "unmarked_s": run["build_s"] - sum(
            v for k_, v in run["stage_s"].items()
            if not k_.startswith("groups.") and k_ not in _CLI_LABELS),
        "vmhwm_bytes": proc["vmhwm_bytes"],
        "rss_peak_sampled_bytes": proc["rss_peak_sampled_bytes"],
        "host_peak_rss_bytes": proc["vmhwm_bytes"] or proc["rss_peak_sampled_bytes"],
        "peak_bytes": proc["max_memory_allocated"],
        "peak_reserved_bytes": reserved,
        "peak_reserved_bytes_per_group_row": reserved / R,
        "peak_reserved_less_text_per_group_row": (reserved - text_bytes) / R,
        "group_bytes_per_row_constant": grouped._GROUP_BYTES_PER_ROW,
        "file_bytes": run["file_bytes"], "sharp_pos": sharp, "dollar_pos": dollar,
        "positions_past_2_31": sum(p >= 1 << 31 for p in sharp + [dollar]),
        "port_hashes": run["hashes"], "port_hashes_equal_recorded": True,
        "lf_verify_ok": True,
    }))
    # ---- kernel 2 at this build's classification rows ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    so = Parity("seg_scan_or")
    shapes = _classification_scans(dev, gen, so, R, "genome classification")
    rows["seg_scan_or"]["genome_shapes"] = shapes
    rows["seg_scan_or"]["max_abs_err"] = max(rows["seg_scan_or"]["max_abs_err"],
                                             so.max_abs_err)
    for g in shapes:
        say(f"[kernels] seg_scan_or {g['shape']}: {g['ms']:.4f} ms "
            f"(bound {g['bound_ms']:.4f} ms by {g['bound_by']}, "
            f"plain {g['plain_ms']:.4f} ms)")
    say(f"[kernels] seg_scan_or at the genome classification: {so.cases} "
        "cases equal")
    torch.cuda.empty_cache()


def _tmpfs_mounts() -> list:
    """The tmpfs mounts of /proc/mounts that this process may write, each
    once and none under /sys or /proc, with their free bytes, the most
    free first."""
    import os
    import shutil

    out = {}
    for mnt, typ in _proc_mounts():
        if (typ == "tmpfs" and not mnt.startswith(("/sys/", "/proc/"))
                and os.access(mnt, os.W_OK | os.X_OK)):
            try:
                out[mnt] = shutil.disk_usage(mnt).free
            except OSError:
                pass
    return [{"mount": m, "free_bytes": b}
            for m, b in sorted(out.items(), key=lambda kv: -kv[1])]


def _proc_mounts() -> list:
    """(mount point, filesystem type) of each line of /proc/mounts."""
    with open("/proc/mounts") as f:
        return [(mnt.replace("\\040", " "), typ)
                for _dev, mnt, typ in (line.split()[:3] for line in f)]


def _spill_fs(path, N: int) -> dict:
    """The filesystem that holds `path` (the /proc/mounts entry of the
    longest mount point over it) and its free bytes. Raises on tmpfs,
    where a spill is host memory, and under 1.25 x OOC_SPILL_BYTES x N
    free bytes."""
    import os
    import shutil

    real = os.path.realpath(path)
    mount, fstype = "", "unknown"
    for mnt, typ in _proc_mounts():
        inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
        if inside and len(mnt) > len(mount):
            mount, fstype = mnt, typ
    free = shutil.disk_usage(path).free
    need = int(1.25 * OOC_SPILL_BYTES * N)
    fs = {"path": real, "mount": mount, "fstype": fstype, "free_bytes": free,
          "need_bytes": need}
    if fstype in ("tmpfs", "ramfs"):
        raise AssertionError(f"the spill directory is in host memory: {fs}")
    if free < need:
        raise AssertionError(f"too little disk for the spill: {fs}")
    return fs


def phase_ooc_rehearsal(dev, rows: dict):
    """The out-of-core tier spilled with checkpoints, killed and resumed
    across processes (tools/rehearse_ooc.py's job): synth_concat at
    OOC_REHEARSAL_MBP built here on the grouped tier for the same-run
    hashes, its text written once to disk, then
    tests/torch_ooc_worker.py (OocConfig(chunk=2^26, n_buckets=256,
    spill_dir, checkpoint=True), check=True) in a child that this
    process SIGKILLs once the manifest reaches bucket 128 of pass B, and
    in a fresh child that resumes it. The resumed child must skip pass
    A, classify only what was left, have the grouped build's sp_len,
    n_blue and hashes, and leave the spill directory empty; then
    seg_scan_or at the largest bucket's rows."""
    import os
    import tempfile

    import torch

    from debwt_tpu_torch import api, oocore
    from debwt_tpu_torch.synth import synth_concat_collection
    from debwt_tpu_torch.types import PipelineConfig

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_ooc_worker import Child, save_collection, watch

    what = f"ooc rehearsal {OOC_REHEARSAL_MBP} Mbp"
    nb = OOC_REHEARSAL_BUCKETS
    t0 = time.perf_counter()
    coll = synth_concat_collection(OOC_REHEARSAL_MBP)
    t_synth = time.perf_counter() - t0
    N = coll.bwt_len
    stats = {}
    t0 = time.perf_counter()
    r = api.build(coll, PipelineConfig(m=32, check=True), device=dev,
                  stats=stats)
    t_grouped = time.perf_counter() - t0
    if "groups.select" not in r.timings:
        raise AssertionError(f"{what}: the grouped build's plan {_plan_of(stats)}")
    want = {k: stats[k] for k in ("sp_len", "n_blue")}
    grouped = _hashes(r)
    gplan = {k: stats[k] for k in ("n_groups", "cap_run", "n_chunks")}
    del r
    with tempfile.TemporaryDirectory(prefix="debwt_ooc_rehearsal_") as work:
        work = Path(work)
        fs = _spill_fs(work, N)
        t0 = time.perf_counter()
        save_collection(coll, work / "coll")
        t_save = time.perf_counter() - t0
        del coll
        oocore._malloc_trim()
        torch.cuda.empty_cache()
        parent = {"rss_bytes": RssPeak._now(),
                  "reserved_bytes": torch.cuda.memory_reserved()}
        spill = work / "spill"
        with RssPeak() as rss:
            first = Child(work / "child1.log", work / "coll", spill,
                          str(dev), "--buckets", str(nb))
            w1 = watch(first.proc, spill, kill_at=OOC_REHEARSAL_KILL_AT,
                       timeout=OOC_CHILD_TIMEOUT)
            killed_at, l1 = w1["killed_at"], first.lines()
            manifest = json.loads((spill / "manifest.json").read_text())
            resumed_at = manifest.get("next_bucket")
            if not (w1["returncode"] == -9 and killed_at is not None
                    and killed_at >= OOC_REHEARSAL_KILL_AT and "RESULT" not in l1
                    and manifest["stage"] == "B"
                    and killed_at <= resumed_at < nb):
                raise AssertionError(
                    f"{what}: child 1 exited {w1['returncode']}, killed at "
                    f"{killed_at}, manifest at {manifest['stage']} "
                    f"{resumed_at}\n{first.tail()}")
            second = Child(work / "child2.log", work / "coll", spill, str(dev),
                           "--buckets", str(nb))
            w2 = watch(second.proc, spill, timeout=OOC_CHILD_TIMEOUT)
        left = sorted(os.listdir(spill))
        l2 = second.lines()
        if w2["returncode"] != 0 or "RESULT" not in l2:
            raise AssertionError(f"{what}: the resumed child exited "
                                 f"{w2['returncode']}\n{second.tail()}")
    parent["rss_peak_bytes"] = rss.bytes
    res = l2["RESULT"]
    stats = res["stats"]
    note_written(children_wchar=w1["io_bytes"].get("wchar", 0)
                 + res["io_bytes"].get("wchar", 0), mapped=N)
    if l1["START"]["x2_sha"] != l2["START"]["x2_sha"] or l2["START"]["n"] != N:
        raise AssertionError(f"{what}: the two children read different texts")
    if l1["PASS_B"]["launches"] != {"window_keys": stats["n_chunks"],
                                    "window_keys_at": 1, "seg_scan_or": 0}:
        raise AssertionError(f"{what}: child 1's pass A launched "
                             f"{l1['PASS_B']['launches']}")
    if (stats["n_chunks"], stats["n_buckets"], stats["oversized_buckets"]) != (
            -(-N // OOC_CHUNK), nb, 0):
        raise AssertionError(f"{what}: plan {_ooc_plan(stats)}")
    if "pass A (resume attach)" not in stats["stage_s"]:
        raise AssertionError(f"{what}: child 2 did not resume: {stats['stage_s']}")
    _check_ooc_counts(stats, res["launches"], f"{what} resume", resumed=True)
    if not 1 <= stats["classifications"] <= nb - resumed_at:
        raise AssertionError(f"{what}: {stats['classifications']} classifications "
                             f"on a resume at bucket {resumed_at}")
    if {k: stats[k] for k in want} != want:
        raise AssertionError(f"{what}: sp_len {stats['sp_len']} and n_blue "
                             f"{stats['n_blue']}, the grouped build's {want}")
    if (res["obj_sha"], res["sharp_sha"], res["dollar"]) != grouped:
        raise AssertionError(f"{what}: differs from the grouped build")
    if left:
        raise AssertionError(f"{what}: files left: {left[:5]}")
    spill_peak = max(w1["spill_peak"], w2["spill_peak"])
    if spill_peak > OOC_SPILL_MAX * N:
        raise AssertionError(f"{what}: spill peak {spill_peak / N} bytes a "
                             f"position, over {OOC_SPILL_MAX}")
    for name, n in res["launches"].items():
        rows[name]["launches_ooc_rehearsal_resume"] = n
    rows["window_keys"]["launches_ooc_rehearsal_killed_pass_a"] = (
        l1["PASS_B"]["launches"]["window_keys"])
    say(json.dumps({
        "ooc_rehearsal_mbp": OOC_REHEARSAL_MBP, "n": N, "m": 32,
        "input": "synth_concat", "synth_s": t_synth, "grouped_build_s": t_grouped,
        "grouped_plan": gplan,
        "hashes_equal_grouped": True,
        "sp_len_n_blue_equal_grouped": list(want.values()),
        "spill_fs": fs, "text_save_s": t_save, "parent": parent,
        "killed_at": killed_at, "resumed_at": resumed_at, **_ooc_plan(stats),
        "child1": {"seconds": w1["seconds"], "exit": w1["returncode"],
                   "rss_peak_bytes_every_2s": w1["rss_peak"],
                   "rlimit_nofile": l1["START"]["rlimit_nofile"],
                   "load_s": l1["START"]["load_s"],
                   "rss_peak_bytes_to_pass_b": l1["PASS_B"]["rss_peak_bytes"],
                   "pass_a_launches": l1["PASS_B"]["launches"],
                   "io_bytes_sampled_every_2s": w1["io_bytes"]},
        "child2": {"seconds": w2["seconds"], "exit": w2["returncode"],
                   "build_s": res["build_s"], "pack_s": res["pack_s"],
                   "rss_peak_bytes": res["rss_peak_bytes"],
                   "rss_peak_bytes_every_2s": w2["rss_peak"],
                   "ru_maxrss_bytes_with_parents": res["ru_maxrss_bytes"],
                   "io_bytes": res["io_bytes"], "stage_s": stats["stage_s"]},
        "spill_peak_bytes": spill_peak,
        "spill_peak_apparent_bytes": max(w1["spill_peak_apparent"],
                                         w2["spill_peak_apparent"]),
        "spill_peak_bytes_per_position": spill_peak / N,
        "files_left": 0,
    }))
    # ---- kernel 2 at this tier's bucket rows ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    so = Parity("seg_scan_or")
    shapes = _classification_scans(dev, gen, so, stats["max_bucket_rows"],
                                   "ooc rehearsal bucket")
    rows["seg_scan_or"]["ooc_rehearsal_shapes"] = shapes
    rows["seg_scan_or"]["max_abs_err"] = max(rows["seg_scan_or"]["max_abs_err"],
                                             so.max_abs_err)
    for g in shapes:
        say(f"[kernels] seg_scan_or {g['shape']}: {g['ms']:.4f} ms "
            f"(bound {g['bound_ms']:.4f} ms by {g['bound_by']}, "
            f"plain {g['plain_ms']:.4f} ms)")
    say(f"[kernels] seg_scan_or at the ooc rehearsal bucket: {so.cases} cases equal")
    torch.cuda.empty_cache()


def phase_ooc_past_max_n(dev, rows: dict):
    """The out-of-core tier where only it can go: synth_concat at
    PAST_MAX_N_MBP (N >= grouped.MAX_N, which the grouped tier refuses,
    and past 2^32) built whole in tests/torch_ooc_worker.py, a child
    that makes the text from its seed (OocConfig(chunk=2^26,
    n_buckets=256, spill_dir, checkpoint=True), check=True), then an LF
    walk of PAST_MAX_N_VERIFY_STEPS steps from the text's end, across
    position 2^32. It must pass the character counts, hold one '$' and
    n_reads - 1 '#', launch kernel 1 once a chunk, its gathered form
    once and kernel 2 three times a classification, classify no bucket
    oversized, spill at most OOC_SPILL_MAX bytes a position, leave the
    spill directory empty and give the port's recorded hashes; then
    window_keys_at at the largest bucket's rows, against its plain
    version and timed beside its bound."""
    import os
    import tempfile

    import torch

    from debwt_tpu_torch import grouped

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_ooc_worker import Child, watch

    what = f"ooc past MAX_N {PAST_MAX_N_MBP} Mbp"
    N = PAST_MAX_N
    if not (N >= grouped.MAX_N and N > 1 << 32):
        raise AssertionError(f"{what}: N = {N} is under MAX_N or 2^32")
    if N - PAST_MAX_N_VERIFY_STEPS >= 1 << 32:
        raise AssertionError(f"{what}: the LF walk does not reach 2^32")
    cache = json.loads((ROOT / ".bench_cache.json").read_text())
    sp_3000 = cache["grouped_mbp3000.0"]
    parent = {"rss_bytes": RssPeak._now(),
              "reserved_bytes": torch.cuda.memory_reserved()}
    with tempfile.TemporaryDirectory(prefix="debwt_ooc_past_max_n_") as work:
        work = Path(work)
        fs = _spill_fs(work, N)
        spill = work / "spill"
        child = Child(work / "child.log", PAST_MAX_N_MBP, spill, str(dev),
                      "--buckets", "256",
                      "--verify-steps", str(PAST_MAX_N_VERIFY_STEPS))
        with RssPeak() as rss:
            w = watch(child.proc, spill, timeout=PAST_MAX_N_TIMEOUT)
        left = sorted(os.listdir(spill))
        lines = child.lines()
        if w["returncode"] != 0 or "RESULT" not in lines:
            raise AssertionError(f"{what}: the child exited {w['returncode']}"
                                 f"\n{child.tail()}")
    parent["rss_peak_bytes"] = rss.bytes
    res, start = lines["RESULT"], lines["START"]
    stats = res["stats"]
    note_written(children_wchar=res["io_bytes"].get("wchar", 0), mapped=N)
    n_reads = start["n_reads"]
    if start["n"] != N or res["bwt_len"] != N:
        raise AssertionError(f"{what}: N {start['n']}, bwt_len {res['bwt_len']}")
    if not (res["n_sharp"] == n_reads - 1 == 3 and 0 <= res["dollar"] < N):
        raise AssertionError(f"{what}: {res['n_sharp']} '#', '$' at {res['dollar']}")
    verify = res["lf_verify"]
    if not (verify and verify["ok"] and verify["steps"] == PAST_MAX_N_VERIFY_STEPS):
        raise AssertionError(f"{what}: the LF walk {verify}")
    if (stats["n_chunks"], stats["n_buckets"], stats["oversized_buckets"]) != (
            -(-N // OOC_CHUNK), 256, 0):
        raise AssertionError(f"{what}: plan {_ooc_plan(stats)}")
    _check_ooc_counts(stats, res["launches"], what)
    if res["calls"] != {"_chunk_keys": stats["n_chunks"],
                        "_row_keys": stats["classifications"],
                        "_classify_bucket": stats["classifications"]}:
        raise AssertionError(f"{what}: calls {res['calls']}")
    spill_peak = max(w["spill_peak"], res["spill_peak_bytes"])
    if left or spill_peak > OOC_SPILL_MAX * N:
        raise AssertionError(f"{what}: files left {left[:5]}, spill peak "
                             f"{spill_peak / N} bytes a position")
    hashes = (res["obj_sha"], res["sharp_sha"], res["dollar"])
    for name, n in res["launches"].items():
        rows[name]["launches_ooc_past_max_n"] = n
    rows["window_keys_at"]["launches"] = res["launches"]["window_keys_at"]
    say(json.dumps({
        "ooc_past_max_n_mbp": PAST_MAX_N_MBP, "n": N, "m": 32,
        "input": "synth_concat", "max_n": grouped.MAX_N,
        "n_at_least_max_n": True, "n_past_2_32": True, "n_reads": n_reads,
        "character_counts_equal": True, "n_sharp": res["n_sharp"],
        "port_hashes": dict(zip(("obj_sha", "sharp_sha", "dollar"), hashes)),
        "sp_len": stats["sp_len"], "n_blue": stats["n_blue"],
        "sp_len_3000_scaled": sp_3000["sp_len"] * PAST_MAX_N_MBP / 3000.0,
        "n_blue_3000_scaled": sp_3000["n_blue"] * PAST_MAX_N_MBP / 3000.0,
        **_ooc_plan(stats), "stage_s": stats["stage_s"],
        "child": {"seconds": w["seconds"], "load_s": start["load_s"],
                  "build_s": res["build_s"], "pack_s": res["pack_s"],
                  "rss_peak_bytes": res["rss_peak_bytes"],
                  "rss_peak_bytes_every_2s": w["rss_peak"],
                  "io_bytes_build": res["io_bytes_build"],
                  "io_bytes": res["io_bytes"]},
        "lf_verify": dict(verify, first_position=N - verify["steps"]),
        "spill_fs": fs, "parent": parent,
        "spill_peak_bytes": spill_peak,
        "spill_peak_apparent_bytes": w["spill_peak_apparent"],
        "spill_peak_bytes_per_position": spill_peak / N,
        "files_left": 0,
    }))
    _window_keys_at_shape(dev, rows, stats["max_bucket_rows"])
    if hashes != PAST_MAX_N_HASHES:
        raise AssertionError(f"{what}: hashes {hashes}, the port's recorded "
                             f"{PAST_MAX_N_HASHES}")


def _window_keys_at_shape(dev, rows: dict, R: int):
    """Kernel 1's gathered entry at R rows laid out as the largest
    bucket's (one ascending run a chunk of a PAST_MAX_N-code text, w 31)
    against its plain version, then timed beside its bound: each
    position read once, each key written once, and each distinct 32-byte
    sector of words that the rows' windows touch read once."""
    import torch

    from debwt_tpu_torch.kernels.window_keys import (
        window_keys_at, window_keys_at_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    wa = Parity("window_keys_at")
    words = _random_words(dev, gen, PAST_MAX_N + 32)
    pos = _bucket_positions(dev, gen, PAST_MAX_N, R)
    w = 31
    what = f"R {R} rows as a bucket's, w {w}, positions to {int(pos.max())}"
    wa.check(window_keys_at(words, pos, w), window_keys_at_plain(words, pos, w),
             what)
    j = pos >> 4                       # words j, j + 1, j + 2 (w <= 32)
    sectors = torch.unique(torch.cat([(4 * j) >> 5, (4 * (j + 2) + 3) >> 5]))
    n_bytes = 16 * R + 32 * sectors.shape[0]
    del j, sectors
    b_ms, b_by = bound_ms(n_bytes, 10 * R)
    row = rows["window_keys_at"]
    row.update(
        max_abs_err=max(row["max_abs_err"], wa.max_abs_err),
        ms=cuda_ms(lambda: window_keys_at(words, pos, w), reps=20),
        plain_ms=cuda_ms(lambda: window_keys_at_plain(words, pos, w),
                         reps=3, warm=1),
        bound_ms=b_ms, bound_by=b_by, shape=what, bound_bytes=n_bytes)
    del words, pos
    say(f"[kernels] window_keys_at {what}: {row['ms']:.4f} ms (bound "
        f"{b_ms:.4f} ms by {b_by}, {n_bytes} bytes; plain "
        f"{row['plain_ms']:.4f} ms); {wa.cases} case equal")
    torch.cuda.empty_cache()


def phase_dist(dev, rows: dict):
    """The multi-device tier: one rank over NCCL through api.build at
    full size, kernel 1 at the shard shapes, the CLI's --dist 1, then two
    rank processes sharing the card."""
    import torch
    import torch.distributed as tdist

    from debwt_tpu_torch import api
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig

    cache = json.loads((ROOT / ".bench_cache.json").read_text())
    config = PipelineConfig(m=32)
    torch.cuda.empty_cache()
    N = None
    for mbp in DIST_MBP:
        ref = cache[f"ref_mbp{mbp}"]
        t0 = time.perf_counter()
        coll = synth_collection(mbp)
        t_synth = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        r = api.build(coll, config, device=dev, n_devices=1)
        hashes = _hashes(r)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        if counts != {"window_keys": 1, "window_keys_at": 0, "seg_scan_or": 0}:
            raise AssertionError(f"dist {mbp} Mbp: launches {counts}")
        if hashes != (ref["obj_sha"], ref["sharp_sha"], ref["dollar"]):
            raise AssertionError(f"dist {mbp} Mbp: differs from the reference hashes")
        peak, reserved = (torch.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_reserved())
        N = coll.bwt_len
        say(json.dumps({
            "dist_mbp": mbp, "n": N, "m": 32, "ranks": 1,
            "backend": tdist.get_backend(), "hashes_equal_reference": True,
            "build_s": dt, "mbps": (N - coll.n_reads) / 1e6 / dt,
            "stage_s": r.timings, "peak_bytes": peak,
            "peak_reserved_bytes": reserved, "peak_bytes_per_position": peak / N,
            "peak_reserved_bytes_per_position": reserved / N,
            "launches": counts, "synth_s": t_synth,
        }))
        del r, coll
        torch.cuda.empty_cache()
    rows["window_keys"]["launches_dist"] = counts["window_keys"]
    tdist.destroy_process_group()
    _dist_kernel_shapes(dev, rows, N)
    _dist_cli(dev, cache[f"ref_mbp{min(DIST_MBP)}"])
    _dist_two_ranks(dev, rows, cache[f"ref_mbp{min(DIST_MBP)}"])


def _dist_kernel_shapes(dev, rows: dict, N: int):
    """Kernel 1's uint8 entry on a shard's codes x2[: Ns + m - 1], Ns =
    ceil(N / ranks), at one and two ranks: against its plain version,
    then timed beside the bound."""
    import torch

    from debwt_tpu_torch.kernels.window_keys import window_keys, window_keys_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    wk, w, shapes = Parity("window_keys"), 32, []
    for ranks in (1, 2):
        Ns = -(-N // ranks)
        x = torch.randint(0, 4, (Ns + w - 1,), generator=gen, device=dev,
                          dtype=torch.uint8)
        what = f"uint8 codes of a {ranks}-rank shard of {N}, n_out {Ns}, w {w}"
        wk.check(window_keys(x, w, Ns), window_keys_plain(x, w, Ns), what)
        b_ms, b_by = bound_ms((Ns + w - 1) + 8 * Ns, 3 * Ns)
        shapes.append(dict(
            shape=what, ms=cuda_ms(lambda: window_keys(x, w, Ns), reps=20),
            plain_ms=cuda_ms(lambda: window_keys_plain(x, w, Ns), reps=3, warm=1),
            bound_ms=b_ms, bound_by=b_by))
        del x
        torch.cuda.empty_cache()
    rows["window_keys"]["dist_shapes"] = shapes
    rows["window_keys"]["max_abs_err"] = max(rows["window_keys"]["max_abs_err"],
                                             wk.max_abs_err)
    for g in shapes:
        say(f"[kernels] window_keys {g['shape']}: {g['ms']:.4f} ms "
            f"(bound {g['bound_ms']:.4f} ms by {g['bound_by']}, "
            f"plain {g['plain_ms']:.4f} ms)")
    say(f"[kernels] window_keys at the dist shapes: {wk.cases} cases equal")


def _write_fasta(path, mbp: float, make=None) -> dict:
    """The synthetic collection make(mbp) (synth.synth_codes unless given:
    (codes, lengths) of the genomes back to back) as FASTA, records
    genome<i>, 80 bases a line, 2^20 lines a write; gzip at level 1 where
    `path` ends in .gz. Returns the collection's N and n_reads and the
    seconds of synthesis and of writing."""
    import functools
    import gzip

    import numpy as np

    from debwt_tpu_torch.synth import synth_codes

    t0 = time.perf_counter()
    codes, lengths = (make or synth_codes)(mbp)
    t_synth = time.perf_counter() - t0
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    opener = (functools.partial(gzip.open, compresslevel=1)
              if str(path).endswith(".gz") else open)
    block = 1 << 20
    with opener(path, "wb") as f:
        start = 0
        for i, n in enumerate(lengths.tolist()):
            f.write(f">genome{i}\n".encode())
            full = n // 80
            for j in range(0, full, block):
                rows = min(block, full - j)
                lines = np.empty((rows, 81), dtype=np.uint8)
                lines[:, 80] = ord("\n")
                lines[:, :80] = acgt[codes[start + 80 * j:
                                           start + 80 * (j + rows)]].reshape(rows, 80)
                f.write(memoryview(lines.reshape(-1)))
            if n % 80:
                f.write(acgt[codes[start + 80 * full : start + n]].tobytes() + b"\n")
            start += n
    return {"n": int(lengths.sum()) + lengths.shape[0],
            "n_reads": int(lengths.shape[0]), "synth_s": t_synth,
            "write_s": time.perf_counter() - t0 - t_synth}


def _dist_cli(dev, ref: dict):
    """The CLI's --dist 1 at 4.6 Mbp: its three files against the
    reference hashes, its route and launches as _check_cli_run's."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="debwt_dist_cli_") as d:
        fa = Path(d) / "in.fa"
        _write_fasta(fa, min(DIST_MBP))
        run = _run_cli(fa, ["--dist", "1", "--timings"], {}, dev, ref)
    _check_cli_run("dist", run)
    say(json.dumps({"dist_cli_mbp": min(DIST_MBP), "ranks": 1,
                    "files_equal_reference": True, "route": run["route"],
                    "process_s": run["process_s"]}))


# the CLI's own entry, as `python -m debwt_tpu_torch.cli` runs it, with
# the kernels' launch counts of the process printed after it returns,
# then its bytes written, its peak resident set (VmHWM, which an exec'd
# process starts anew, where the kernel has it; and statm sampled every
# 50 ms), the card's peak bytes, the seconds of the writer and the LF
# walk (both wrapped here; the CLI prints neither) and the parts of its
# fixed cost: the wall clock at entry and at main's return, the imports,
# and on a card the CUDA context, made here before main
_CLI_MAIN = """\
import time
secs = {"entered_at": time.time()}
import json, os, sys, threading
import torch
secs["torch_import_s"] = time.time() - secs["entered_at"]
from debwt_tpu_torch import io as dio, verify
from debwt_tpu_torch.cli import main
from debwt_tpu_torch.kernels import seg_or, window_keys
secs["imports_s"] = time.time() - secs["entered_at"]
if sys.argv[sys.argv.index("--device") + 1] == "cuda":
    t0 = time.time()
    torch.cuda.mem_get_info()
    secs["cuda_context_s"] = time.time() - t0
rss, done = [0], threading.Event()
def timed(name, fn):
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
    return run
def sample():
    page = os.sysconf("SC_PAGE_SIZE")
    while True:
        with open("/proc/self/statm") as f:
            rss[0] = max(rss[0], int(f.read().split()[1]) * page)
        if done.wait(0.05):
            return
dio.write_bwt = timed("write_s", dio.write_bwt)
verify.lf_verify = timed("verify_s", verify.lf_verify)
threading.Thread(target=sample, daemon=True).start()
try:
    rc = main(sys.argv[1:])
finally:
    secs["returned_at"] = time.time()
    done.set()
    print("[launches] " + json.dumps({
        "window_keys": window_keys.window_keys.launches,
        "window_keys_at": window_keys.window_keys_at.launches,
        "seg_scan_or": seg_or.seg_scan_or.launches}), file=sys.stderr)
    try:
        with open("/proc/self/io") as f:
            io = dict(ln.split(":", 1) for ln in f.read().splitlines())
        print("[io] " + json.dumps({"wchar": int(io["wchar"])}), file=sys.stderr)
    except (OSError, ValueError, KeyError):
        pass
    with open("/proc/self/status") as f:
        hwm = [int(ln.split()[1]) * 1024 for ln in f if ln.startswith("VmHWM:")]
    cuda = torch.cuda.is_initialized()
    print("[process] " + json.dumps({
        "vmhwm_bytes": hwm[0] if hwm else None, "rss_peak_sampled_bytes": rss[0],
        "max_memory_allocated": torch.cuda.max_memory_allocated() if cuda else None,
        "max_memory_reserved": torch.cuda.max_memory_reserved() if cuda else None,
        **secs}), file=sys.stderr)
sys.exit(rc)
"""


def _run_cli(fa: Path, args: list, env: dict, dev, ref: dict,
             timeout: float = CLI_TIMEOUT) -> dict:
    """One CLI process on `fa` with DEBWT_TRACE=1 (the tiers print their
    plans, SP lengths and blue counts): it must exit 0 within `timeout`
    seconds and write the reference's three files. Returns its route
    lines, the plan lines, the kernels' launch counts, the SP length and
    blue count it traced (None where its tier prints none), the ingest
    and build seconds and, under --timings, the stage seconds it reports,
    what _CLI_MAIN prints after it (peak resident set, the card's peak
    bytes, write and LF-walk seconds), its files' hashes, sizes and
    sidecars, and the process's wall seconds."""
    import os
    import re

    from debwt_tpu_torch.io import read_sidecars

    obj = fa.parent / "out.bwt"
    t0, spawned = time.perf_counter(), time.time()
    run = subprocess.run(
        [sys.executable, "-c", _CLI_MAIN, "--device", dev.type, "-o", str(obj),
         *args, str(fa)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), DEBWT_TRACE="1",
                 **env),
        cwd=fa.parent, capture_output=True, text=True, timeout=timeout)
    wall, reaped = time.perf_counter() - t0, time.time()
    se = run.stderr
    if run.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)} exited {run.returncode}:\n{se}")
    sharp, dollar = read_sidecars(str(obj))
    with open(obj, "rb") as f:
        obj_sha = hashlib.file_digest(f, "sha256").hexdigest()
    got = (obj_sha, hashlib.sha256(sharp.tobytes()).hexdigest(), dollar)
    if got != (ref["obj_sha"], ref["sharp_sha"], ref["dollar"]):
        raise AssertionError(f"cli {' '.join(args)}: files differ from the "
                             "reference hashes")
    lines = se.splitlines()

    def tagged(tag):
        return [json.loads(ln.split(" ", 1)[1]) for ln in lines
                if ln.startswith(f"[{tag}] ")]

    for io in tagged("io"):
        note_written(children_wchar=io["wchar"])
    proc = tagged("process")[-1]
    proc["start_s"] = proc.pop("entered_at") - spawned
    proc["exit_s"] = reaped - proc.pop("returned_at")

    def traced(pattern):
        found = re.findall(pattern, se)
        return int(found[-1]) if found else None

    stages = re.findall(r"^\[debwt-torch\]   (.+?) +(-?[0-9.]+)s  \(", se, re.M)
    return {
        "args": args, "env": env,
        "route": [ln.split("route: ", 1)[1] for ln in lines if "route: " in ln],
        "plan": [ln for ln in lines if re.search(r"\] (plan|pass [AB]): ", ln)],
        "verify": [ln for ln in lines if "LF invertibility" in ln],
        "launches": tagged("launches")[-1],
        "sp_len": traced(r"\] SP string: (\d+) events"),
        "n_blue": traced(r"\] blue entries: (\d+)"),
        "ingest_s": float(re.search(r"\(([0-9.]+)s ingest\)", se).group(1)),
        "build_s": float(re.search(r"BWT of \d+ chars in ([0-9.]+)s", se).group(1)),
        "stage_s": {label: float(v) for label, v in stages},
        "process": proc,
        "hashes": dict(zip(("obj_sha", "sharp_sha", "dollar"), got)),
        "file_bytes": {ext: os.path.getsize(f"{obj}{ext}") for ext in ("", ".#", ".$")},
        "sharp_pos": sharp.tolist(),
        "process_s": wall,
    }


# the labels --timings prints beside the build's stages: the CLI's own
_CLI_LABELS = ("ingest", "build", "packed", "write")


def _nccl_answer(stderr: str) -> list:
    """The lines of a rank's stderr that carry NCCL's error, else its
    last line."""
    keys = ("Duplicate GPU", "ncclInvalidUsage", "invalid usage", "Error:")
    lines = [ln.strip()[:400] for ln in stderr.splitlines()
             if any(k in ln for k in keys)]
    return list(dict.fromkeys(lines))[:4] or stderr.strip().splitlines()[-1:]


def _rank_hashes(g: dict) -> tuple:
    """_hashes of one rank's result as the rank worker saved it."""
    import numpy as np

    return (hashlib.sha256(g["packed"].tobytes()).hexdigest(),
            hashlib.sha256(g["sharp"].astype(np.int64).tobytes()).hexdigest(),
            int(g["dollar"]))


def _dist_two_ranks(dev, rows: dict, ref: dict):
    """Two rank processes on the one card (tests/torch_dist_worker.py,
    the CPU tests' rank worker): NCCL asked once, then gloo with host
    staging. The ooc x dist build spills and checkpoints, each rank
    under its own subdirectory of one spill directory."""
    import os
    import tempfile

    import torch

    from debwt_tpu_torch import api
    from debwt_tpu_torch.synth import synth_collection
    from debwt_tpu_torch.types import PipelineConfig

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_dist_worker import launch

    with tempfile.TemporaryDirectory(prefix="debwt_dist_ranks_") as d:
        dev0 = str(torch.device(dev.type, dev.index or 0))
        t0 = time.perf_counter()
        ends = launch(Path(d) / "nccl", 2, [dict(name="probe", kind="probe")],
                      timeout=120, device=dev0, backend="nccl",
                      env={"NCCL_DEBUG": "WARN"}).wait()
        say(json.dumps({"dist_nccl_two_ranks_one_card": {
            "exit_codes": [rc for rc, _se in ends],
            "accepted": all(rc == 0 for rc, _se in ends),
            "answer": [_nccl_answer(se) for _rc, se in ends],
            "seconds": time.perf_counter() - t0}}))

        coll = synth_collection(DIST_GLOO_MBP)
        fused = _hashes(api.build(coll, PipelineConfig(m=32), device=dev))
        del coll
        torch.cuda.empty_cache()
        reference = (ref["obj_sha"], ref["sharp_sha"], ref["dollar"])
        spill = Path(d) / "spill"
        cases = [dict(name="dist_small", kind="build", mbp=min(DIST_MBP)),
                 dict(name="dist_large", kind="build", mbp=DIST_GLOO_MBP),
                 dict(name="ooc_dist", kind="ooc", mbp=min(DIST_MBP),
                      sp_cap=OOC_DIST_SP_CAP, spill_dir=str(spill),
                      checkpoint=True)]
        want = {"dist_small": reference, "dist_large": fused,
                "ooc_dist": reference}
        t0 = time.perf_counter()
        got = launch(Path(d) / "gloo", 2, cases, timeout=RANK_TIMEOUT,
                     device=dev0, backend="gloo").results()
        dt = time.perf_counter() - t0
        spill_dirs = sorted(os.listdir(spill))
        left = [f for r in spill_dirs for f in os.listdir(spill / r)]
    # each rank process's writes: its wchar after its last case
    note_written(children_wchar=sum(
        max(int(got[c["name"]][r]["io_wchar"]) for c in cases) for r in range(2)))
    for name, w in want.items():
        for r, g in enumerate(got[name]):
            launches = {k: int(g["launches_" + k]) for k in _counters()}
            if _rank_hashes(g) != w:
                raise AssertionError(f"gloo rank {r} {name}: hashes differ")
            if name != "ooc_dist" and launches != {"window_keys": 1,
                                                   "window_keys_at": 0,
                                                   "seg_scan_or": 0}:
                raise AssertionError(f"gloo rank {r} {name}: launches {launches}")
            if name == "ooc_dist" and not (
                    bool(g["sharded_rank"]) and launches["seg_scan_or"] >= 3
                    and 3 * launches["window_keys_at"] == launches["seg_scan_or"]):
                raise AssertionError(f"gloo rank {r} {name}: not sharded, or "
                                     f"launches {launches}")
    if spill_dirs != ["rank0", "rank1"] or left:
        raise AssertionError(
            f"ooc x dist spill directory holds {spill_dirs}, files {left[:5]}")
    rows["window_keys"]["launches_dist_two_ranks"] = int(
        got["dist_large"][0]["launches_window_keys"])
    for k in _counters():
        rows[k]["launches_ooc_dist"] = int(got["ooc_dist"][0]["launches_" + k])
    say(json.dumps({
        "dist_two_ranks_one_card": True, "backend": "gloo",
        "devices": [dev0, dev0], "process_s": dt,
        "builds": [dict(
            name=c["name"], mbp=c["mbp"], build_s=float(g["seconds"]),
            stage_s=json.loads(str(g["timings"])),
            launches={k: int(g["launches_" + k]) for k in _counters()},
            **({"sharded_rank": bool(g["sharded_rank"]),
                "sp_len": int(g["sp_len"]), "spill_dirs": spill_dirs}
               if "sharded_rank" in g else {}))
            for c in cases for g in got[c["name"]][:1]],
        "hashes_equal": ["reference", "fused engine", "reference"],
    }))


def phase_cli(dev, rows: dict):
    """The CLI, the entry point a user calls, on every tier: the 140 Mbp
    collection written once as FASTA, its three readers timed and held
    to each other, kernel 1 at w = 24 at full size, then one CLI process
    a route (the routing variables pick the tier), each against the
    reference hashes with its kernel launches against its plan; then
    -k 12 at 4.6 Mbp."""
    import tempfile

    import numpy as np
    import torch

    from debwt_tpu_torch.io import fasta, read_collection, read_fasta
    from debwt_tpu_torch.pipeline import rows_needed

    cache = json.loads((ROOT / ".bench_cache.json").read_text())
    t_phase = time.perf_counter()
    _cli_kernel_shape(dev, rows)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="debwt_cli_") as d:
        fa = Path(d) / "in.fa"
        t0 = time.perf_counter()
        _write_fasta(fa, CLI_MBP)
        t_write = time.perf_counter() - t0

        # ---- (a) the three readers ----
        secs, got = {}, {}
        t0 = time.perf_counter()
        coll = read_collection(str(fa))
        secs["read_collection"] = time.perf_counter() - t0
        got["read_collection"] = (np.delete(coll.x2, coll.sep),
                                  np.diff(coll.sep, prepend=-1) - 1, None)
        t0 = time.perf_counter()
        reads, names = read_fasta(str(fa))     # the native parser
        secs["read_fasta_native"] = time.perf_counter() - t0
        got["read_fasta_native"] = (np.concatenate(reads),
                                    np.array([r.shape[0] for r in reads]), names)
        del reads
        t0 = time.perf_counter()
        reads, names = fasta._parse_fasta_numpy(fasta._read_raw(str(fa)),
                                                fasta.NPolicy.REJECT, 0)
        secs["read_fasta_numpy"] = time.perf_counter() - t0
        got["read_fasta_numpy"] = (np.concatenate(reads),
                                   np.array([r.shape[0] for r in reads]), names)
        del reads
        codes, lengths, _ = got["read_collection"]
        for name, (c, n, nm) in got.items():
            if not (np.array_equal(c, codes) and np.array_equal(n, lengths)):
                raise AssertionError(f"cli ingest: {name} differs from read_collection")
        if got["read_fasta_native"][2] != got["read_fasta_numpy"][2]:
            raise AssertionError("cli ingest: the two read_fasta paths name differently")
        say(json.dumps({"cli_ingest_mbp": CLI_MBP, "bytes": fa.stat().st_size,
                        "n_reads": int(lengths.shape[0]), "readers_agree": True,
                        "seconds": secs, "write_fasta_s": t_write}))
        bound = str(rows_needed(coll, 32) // 2)   # under the rows at m = 32
        del got, codes, lengths, coll

        # ---- (b) one CLI process a route ----
        ref, ref24 = cache[f"ref_mbp{CLI_MBP}"], cache[f"ref_mbp{CLI_MBP}_m24"]
        runs = {
            "fused": _run_cli(fa, [], {}, dev, ref),
            "grouped": _run_cli(fa, ["--check"], {
                "DEBWT_SINGLE_MAX_ROWS": bound,
                "DEBWT_GROUPED_CAP": str(GROUPED_CAP)}, dev, ref),
            "ooc": _run_cli(fa, ["--verify", "--verify-steps", str(VERIFY_STEPS)], {
                "DEBWT_SINGLE_MAX_ROWS": bound, "DEBWT_FORCE_OOC": "1"}, dev, ref),
            "dist": _run_cli(fa, ["--dist", "1"], {}, dev, ref),
            "fused_k24": _run_cli(fa, ["-k", "24"], {}, dev, ref24),
        }
    # ---- (c) small m ----
    with tempfile.TemporaryDirectory(prefix="debwt_cli_") as d:
        fa = Path(d) / "in.fa"
        _write_fasta(fa, CLI_SMALL_MBP)
        runs["fused_k12"] = _run_cli(fa, ["-k", "12"], {}, dev,
                                     cache[f"ref_mbp{CLI_SMALL_MBP}"])
    for tier, run in runs.items():
        _check_cli_run(tier, run)
        for name, n in run["launches"].items():
            rows[name].setdefault("launches_cli", {})[tier] = n
        say(json.dumps({"cli_tier": tier, "mbp": CLI_SMALL_MBP
                        if tier == "fused_k12" else CLI_MBP,
                        "files_equal_reference": True, **run}))
    say(f"[cli] phase {time.perf_counter() - t_phase:.1f}s")


def _check_cli_run(tier: str, run: dict):
    """The route line names the tier, and the launches of both kernels
    follow the plan the tier printed."""
    import re

    kind = tier.split("_")[0]
    route = {"fused": "single-device fused engine",
             "grouped": "grouped device-resident tier",
             "ooc": "out-of-core chunked tier",
             "dist": "distributed over 1 devices"}[kind]
    if not (len(run["route"]) == 1 and run["route"][0].startswith(route)):
        raise AssertionError(f"cli {tier}: route {run['route']}")
    plan = " ".join(run["plan"])
    if kind == "grouped":
        G, _cap, _chunk, n_chunks, _ns_cap = _grouped_plan(run)
        if G < 4:
            raise AssertionError(f"cli grouped: {G} groups, want at least 4")
        want = {"window_keys": G * n_chunks, "window_keys_at": 0,
                "seg_scan_or": G * n_chunks + 3 * G}
    elif tier == "ooc":
        n_chunks = int(re.search(r"pass A: (\d+) chunks", plan).group(1))
        n_cls = int(re.search(r"pass B: \d+ buckets, (\d+) device", plan).group(1))
        want = {"window_keys": n_chunks, "window_keys_at": n_cls,
                "seg_scan_or": 3 * n_cls}
        if run["verify"] != ["[debwt-torch] LF invertibility: OK"]:
            raise AssertionError(f"cli ooc: {run['verify']}")
    elif tier == "dist":
        want = {"window_keys": 1, "window_keys_at": 0, "seg_scan_or": 0}
    else:
        want = EXPECTED_LAUNCHES
    if run["launches"] != want:
        raise AssertionError(f"cli {tier}: launches {run['launches']}, plan {want}")


def _grouped_plan(run: dict) -> tuple:
    """(G, cap, chunk, n_chunks, ns_cap) of the one plan line a grouped
    CLI run traced."""
    import re

    (plan,) = [tuple(map(int, m)) for m in re.findall(
        r"plan: G=(\d+) groups, cap=(\d+), chunk=(\d+) x (\d+), ns_cap=(\d+)",
        " ".join(run["plan"]))]
    return plan


def _cli_kernel_shape(dev, rows: dict):
    """Kernel 1's packed entry at the width and full size of the -k 24
    build (w = 24 on the 140 Mbp N_cap): against its plain version, then
    timed beside the bound and the plain version's time."""
    import torch

    from debwt_tpu_torch import ops
    from debwt_tpu_torch.kernels.window_keys import (
        window_keys_packed, window_keys_packed_plain,
    )

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    wk, w, n_out = Parity("window_keys"), 24, MAIN_N_CAP
    x2w = ops.pack_2bit_words(torch.randint(0, 4, (n_out + w - 1,), generator=gen,
                                            device=dev, dtype=torch.uint8))
    what = f"packed words, n_out {n_out}, w {w} (the -k 24 build)"
    wk.check(window_keys_packed(x2w, w, n_out),
             window_keys_packed_plain(x2w, w, n_out), what)
    b_ms, b_by = bound_ms((n_out + w - 1) / 4 + 8 * n_out, 3 * n_out)
    shape = dict(shape=what,
                 ms=cuda_ms(lambda: window_keys_packed(x2w, w, n_out), reps=20),
                 plain_ms=cuda_ms(lambda: window_keys_packed_plain(x2w, w, n_out),
                                  reps=3, warm=1),
                 bound_ms=b_ms, bound_by=b_by)
    del x2w
    rows["window_keys"]["cli_shapes"] = [shape]
    rows["window_keys"]["max_abs_err"] = max(rows["window_keys"]["max_abs_err"],
                                             wk.max_abs_err)
    say(f"[kernels] window_keys {what}: {shape['ms']:.4f} ms (bound "
        f"{b_ms:.4f} ms by {b_by}, plain {shape['plain_ms']:.4f} ms); "
        f"{wk.cases} case equal")


def profile_build(fn, mbp):
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

    sys.path.insert(0, str(ROOT / "tests"))

    dev = torch.device("cuda")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {name} x{count}")
    rows: dict = {}
    phase_s: dict = {}

    written: dict = {}

    def run(name, fn, *args):
        t0, own0, w0 = time.perf_counter(), own_wchar(), dict(_WRITTEN)
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        written[name] = {"own_wchar": own_wchar() - own0,
                         **{k: v - w0[k] for k, v in _WRITTEN.items()}}
        say(f"[phase] {name}: {phase_s[name]:.1f}s, wrote "
            f"{disk_bytes(written[name]) / 2**30:.2f} GiB to disk and "
            f"{written[name]['tmpfs'] / 2**30:.2f} GiB to tmpfs")
        return out

    t_all = time.perf_counter()
    run("build", phase_build)
    run("kernels", phase_kernels, dev, rows)
    run("e2e", phase_e2e, dev, rows)
    run("near_bound", phase_near_bound, dev)
    run("verify", phase_verify_count, dev)
    run("ooc", phase_ooc, dev, rows, *run("grouped", phase_grouped, dev, rows))
    run("genome", phase_genome, dev, rows)
    run("ooc_rehearsal", phase_ooc_rehearsal, dev, rows)
    run("ooc_past_max_n", phase_ooc_past_max_n, dev, rows)
    run("dist", phase_dist, dev, rows)
    run("cli", phase_cli, dev, rows)
    say(json.dumps({"phase_s": phase_s}))
    # bytes each phase wrote to disk: this process's write calls, its
    # children's and the spilled outputs' mapped bytes, less what went to
    # a tmpfs (counted apart)
    gib = {name: disk_bytes(v) / 2**30 for name, v in written.items()}
    say(json.dumps({"disk_written_gib": gib, "total_gib": sum(gib.values()),
                    "tmpfs_written_gib": {name: v["tmpfs"] / 2**30
                                          for name, v in written.items()},
                    "bytes": written}))
    say(f"[done] {time.perf_counter() - t_all:.1f}s")
    say(json.dumps({"kernels": list(rows.values())}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
