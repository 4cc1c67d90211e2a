"""Command-line interface.

Mirrors the reference CLI (src/main.c:175-186):

  python -m debwt_tpu_torch.cli -o out.bwt [-k 32] [--dist N]
                                [--n-policy reject|random|to-g]
                                [--seed S] [--verify] [--verify-steps S]
                                [--check] [--timings]
                                [--device cuda|cpu] input.fa[.gz]

`-t`/`-j` are accepted for drop-in compatibility and ignored (no
Jellyfish is needed — counting is on the device). Runs on the CUDA card
unless --device cpu is given.

--dist N builds with the multi-device tier over N ranks, one process a
rank: start N processes with DEBWT_COORDINATOR (host:port of rank 0),
DEBWT_NUM_PROCESSES (N) and DEBWT_PROCESS_ID (0 .. N-1) set; they join
one process group (NCCL on cards, gloo with --device cpu) before the
build. Rank 0 alone writes the output and prints; with --verify every
rank walks its own copy of the result and exits 2 if it fails.

The routing variables of api.py (DEBWT_SINGLE_MAX_ROWS, DEBWT_FORCE_OOC,
DEBWT_GROUPED_CAP) steer the tier a build takes.

--timings is the operator's view of a job: after the write it prints
the seconds of every stage the job recorded (tracing.py: the ingest,
the build's stages, the build, the result's pack, the write) and every
count (SP events, blue entries, rows, bytes each way, syncs).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="debwt-torch",
        description="GPU BWT construction (deBWT-compatible output)",
    )
    p.add_argument("source", help="sequence collection (fasta/fastq, .gz ok)")
    p.add_argument("-o", dest="obj", required=True, help="output bwt file")
    p.add_argument("-k", dest="m", type=int, default=32,
                   help="k-mer length (12..32, default 32)")
    p.add_argument("-t", dest="threads", type=int, default=None,
                   help="(compat, ignored — use --dist)")
    p.add_argument("-j", dest="jroot", default=None,
                   help="(compat, ignored — no Jellyfish needed)")
    p.add_argument("--dist", type=int, default=0, metavar="N",
                   help="run distributed over N devices (one process each)")
    p.add_argument("--n-policy", default="reject",
                   choices=["reject", "random", "to-g"],
                   help="handling of N/IUPAC characters")
    p.add_argument("--seed", type=int, default=11,
                   help="seed for --n-policy random")
    p.add_argument("--verify", action="store_true",
                   help="LF-walk invertibility check after construction")
    p.add_argument("--verify-steps", type=int, default=None, metavar="S",
                   help="bound the LF walk to the last S chars (default: full)")
    p.add_argument("--check", action="store_true",
                   help="enable internal invariant checks")
    p.add_argument("--timings", action="store_true",
                   help="print per-stage wall time + Mbp/s and the job's "
                        "counts (the reference prints its stage times "
                        "on every run, src/main.c:86-170)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device to build on (default: the CUDA card)")
    args = p.parse_args(argv)

    import torch.distributed as tdist

    from debwt_tpu_torch import tracing
    from debwt_tpu_torch.parallel.mesh import init_distributed

    with tracing.recording() as rec, tracing.span("cli"):
        # join the process group the DEBWT_* variables name, if any;
        # leave no group this call made (--dist 1 makes a one-rank
        # group itself)
        had_group = tdist.is_initialized()
        if not had_group:
            init_distributed(
                backend="gloo" if args.device == "cpu" else "nccl")
        rank0 = not tdist.is_initialized() or tdist.get_rank() == 0
        try:
            return _run(args, rank0, rec)
        finally:
            if not had_group and tdist.is_initialized():
                tdist.destroy_process_group()


def _run(args, rank0: bool, rec) -> int:
    """The job; rec is its recording (tracing.py)."""
    def say(msg):
        if rank0:
            print(msg, file=sys.stderr)

    from debwt_tpu_torch import tracing
    from debwt_tpu_torch.api import build
    from debwt_tpu_torch.io import read_collection, write_bwt
    from debwt_tpu_torch.types import PipelineConfig

    # pre-flight: output writability (src/main.c:55-58); rank 0 only,
    # since concurrent create/remove of one path races across processes
    if rank0:
        try:
            with open(args.obj, "wb"):
                pass
            os.remove(args.obj)
        except OSError as e:
            say(f"cannot create {args.obj}: {e}")
            return 1

    with tracing.span("ingest", "ingest"):
        coll = read_collection(args.source, args.n_policy, args.seed)
    say(f"[debwt-torch] {coll.n_reads} reads, "
        f"{(coll.bwt_len - coll.n_reads)/1e6:.2f} Mbp "
        f"({rec.timings['ingest']:.2f}s ingest)")
    config = PipelineConfig(m=args.m, check=args.check)

    dist = {"n_devices": args.dist} if args.dist else {}
    t0 = time.perf_counter()
    result = build(coll, config, device=args.device, verbose=rank0, **dist)
    dt = time.perf_counter() - t0
    tracing.add("build", dt)
    say(f"[debwt-torch] BWT of {coll.bwt_len} chars in {dt:.2f}s "
        f"({coll.bwt_len/1e6/dt:.2f} Mbp/s)")

    if rank0:
        with tracing.span("write", "write"):
            write_bwt(result, args.obj)
    say(f"[debwt-torch] wrote {args.obj} (+ .#, .$)")
    if args.timings:
        mbp = coll.bwt_len / 1e6
        for label, secs in rec.timings.items():
            say(f"[debwt-torch]   {label:28s} {secs:8.3f}s"
                f"  ({mbp / max(secs, 1e-9):8.2f} Mbp/s)")
        for name, n in rec.counters.items():
            say(f"[debwt-torch]   {name:28s} {n:12d}")

    if args.verify:
        from debwt_tpu_torch.verify import lf_verify

        ok = lf_verify(result, coll, max_steps=args.verify_steps)
        say(f"[debwt-torch] LF invertibility: {'OK' if ok else 'FAILED'}")
        if not ok:
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
