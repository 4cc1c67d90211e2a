"""Entry `library`: what a library user runs, one build after another.

A build is `api.build(coll, PipelineConfig(m))` on the card, on the
route api.build picks, then `.packed()`: the `<obj>` bytes, with the '#'
and '$' positions beside them.
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark.reference.bwt import Answer
from benchmark.traffic.genomes import text_index


class Entry:
    def __init__(self, codes, lengths, traffic: dict, dev, workdir, trace):
        from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

        self.coll = SequenceCollection.from_concat(codes, lengths)
        self.lengths = lengths
        self.config = PipelineConfig(m=traffic["m"])
        self.dev = dev
        self.trace = trace
        self.workdir = workdir
        self._undo = None

    def set_variant(self, q: int, shift: int):
        """The collection with code q shifted by `shift` (and the last
        build's substitution undone)."""
        x2 = self.coll.x2
        if self._undo is not None:
            t, old = self._undo
            x2[t] = old
        t = text_index(self.lengths, q)
        self._undo = (t, int(x2[t]))
        x2[t] = (x2[t] + shift) % 4

    def build(self):
        """One build: (Answer, {"timings": the program's, "spans": in a
        traced run the seconds of api.build and of packed()})."""
        from debwt_tpu_torch.api import build

        spans = {}
        with _span(self.trace, "build", spans):
            res = build(self.coll, self.config, device=self.dev)
        with _span(self.trace, "pack", spans):
            ans = Answer(res.packed(), res.sharp_pos, res.dollar_pos)
        return ans, {"timings": dict(res.timings or {}), "spans": spans}

    def keep(self, ans: Answer, build: int) -> str:
        """Writes a build's answer to the run's temporary directory, so
        that answers held for the check take no host memory."""
        stem = f"{self.workdir}/kept{build}.bwt"
        ans.save(stem)
        return stem

    def answer(self, kept: str) -> Answer:
        return Answer.load(kept)

    def close(self):
        self.coll = None


@contextlib.contextmanager
def _span(on: bool, name: str, spans: dict):
    """In a traced run, a profiler span bench.<name> and its seconds in
    spans[name]."""
    if not on:
        yield
        return
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"bench.{name}"):
        yield
    spans[name] = time.perf_counter() - t0
