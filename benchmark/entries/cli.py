"""Entry `cli`: what a CLI user runs, one job after another.

A job is `debwt_tpu_torch.cli.main([fasta, "-o", out, "-k", m])` in this
process: the FASTA in TMPDIR read, the BWT built on the card, `<obj>`,
`<obj>.#` and `<obj>.$` written to TMPDIR. The FASTA holds the genomes
as records genome<i> of `line_width` bases a line.

In the traced run the names that `cli._run` looks up in
debwt_tpu_torch.io when it is called, read_collection and write_bwt,
are wrapped in spans: the ingest and the writer.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.reference.bwt import Answer

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE = {ord(c): i for i, c in enumerate("ACGT")}
_BLOCK_LINES = 1 << 20


def write_fasta(path: Path, codes, lengths, width: int) -> list:
    """Writes the genomes as FASTA; returns each record's first base's
    byte offset."""
    starts, pos = [], 0
    with open(path, "wb") as f:
        for i, n in enumerate(lengths.tolist()):
            head = f">genome{i}\n".encode()
            f.write(head)
            starts.append(f.tell())
            full = n // width
            for j in range(0, full, _BLOCK_LINES):
                rows = min(_BLOCK_LINES, full - j)
                lines = np.empty((rows, width + 1), dtype=np.uint8)
                lines[:, width] = ord("\n")
                lines[:, :width] = _ACGT[codes[pos + width * j:
                                               pos + width * (j + rows)]].reshape(rows, width)
                f.write(memoryview(lines.reshape(-1)))
            if n % width:
                f.write(_ACGT[codes[pos + width * full: pos + n]].tobytes() + b"\n")
            pos += n
    return starts


class Entry:
    def __init__(self, codes, lengths, traffic: dict, dev, workdir, trace):
        self.width = traffic["line_width"]
        self.m = traffic["m"]
        self.dev = dev
        self.trace = trace
        self.workdir = Path(workdir)
        self.fasta = self.workdir / "collection.fa"
        self.out = self.workdir / "out.bwt"
        self.cum = np.concatenate([[0], np.cumsum(lengths)])
        self.starts = write_fasta(self.fasta, codes, lengths, self.width)
        self._fd = os.open(self.fasta, os.O_RDWR)
        self._undo = None
        self.spans = {}
        self._io = None
        if trace:
            self._wrap_io()

    def _offset(self, q: int) -> int:
        r = int(np.searchsorted(self.cum, q, side="right")) - 1
        o = q - int(self.cum[r])
        return self.starts[r] + o + o // self.width

    def set_variant(self, q: int, shift: int):
        """The FASTA with base q shifted by `shift` (and the last job's
        substitution undone), two one-byte writes in place."""
        if self._undo is not None:
            os.pwrite(self._fd, *self._undo)
        off = self._offset(q)
        old = os.pread(self._fd, 1, off)
        self._undo = (old, off)
        os.pwrite(self._fd, bytes([_ACGT[(_CODE[old[0]] + shift) % 4]]), off)

    def _wrap_io(self):
        import debwt_tpu_torch.io as io

        self._io = (io.read_collection, io.write_bwt)

        def timed(name, fn):
            def run(*a, **kw):
                t0 = time.perf_counter()
                with torch.profiler.record_function(f"bench.{name}"):
                    try:
                        return fn(*a, **kw)
                    finally:
                        self.spans[name] = time.perf_counter() - t0
            return run

        io.read_collection = timed("ingest", io.read_collection)
        io.write_bwt = timed("write", io.write_bwt)

    def build(self):
        """One job: (its output files' stem, {"timings": {}, "spans":
        the seconds of its ingest and writer in a traced run})."""
        from debwt_tpu_torch import cli

        self.spans = {}
        span = (torch.profiler.record_function("bench.job") if self.trace
                else contextlib.nullcontext())
        argv = [str(self.fasta), "-o", str(self.out), "-k", str(self.m)]
        if self.dev.type != "cuda":
            argv += ["--device", self.dev.type]
        with span:
            rc = cli.main(argv)
        if rc != 0:
            raise RuntimeError(f"the CLI exited with {rc}")
        return self.out, {"timings": {}, "spans": dict(self.spans)}

    def keep(self, out: Path, build: int) -> Path:
        """Keeps a job's three files past the next job's write."""
        kept = self.workdir / f"kept{build}.bwt"
        for ext in ("", ".#", ".$"):
            os.replace(f"{out}{ext}", f"{kept}{ext}")
        return kept

    def answer(self, kept: Path) -> Answer:
        return Answer.load(kept)

    def close(self):
        if self._io is not None:
            import debwt_tpu_torch.io as io

            io.read_collection, io.write_bwt = self._io
            self._io = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
