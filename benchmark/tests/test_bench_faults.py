"""A run with the timed path broken underneath comes out not correct,
for each fault of benchmark/faults.py, at a tiny size on the CPU."""

from __future__ import annotations

import pytest
import torch

import debwt_tpu_torch.api as api
from benchmark import faults, harness

CELLS = ["dmel_140.fused", "dmel_140.cli"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_build_is_not_correct(tiny_root, monkeypatch, name, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = harness.run_cell(harness.load_cell(name, tiny_root), 977, 0.3, False,
                         torch.device("cpu"))
    assert r["correct"] is False
    assert r["failed"] == 0
    assert any(v > lim for v, lim in r["checks"].values()), r["checks"]


def test_a_build_that_raises_is_not_correct(tiny_root, monkeypatch):
    def build(*a, **kw):
        raise RuntimeError("no answer")

    real = api.build
    calls = {"n": 0}

    def first_only(*a, **kw):       # the warm-up answers, the window not
        calls["n"] += 1
        return real(*a, **kw) if calls["n"] == 1 else build()

    monkeypatch.setattr(api, "build", first_only)
    r = harness.run_cell(harness.load_cell("dmel_140.fused", tiny_root),
                         5, 0.2, False, torch.device("cpu"))
    assert r["correct"] is False and r["failed"] == r["attempted"] >= 1
