"""Fresh interpreters: a run loads neither JAX nor the JAX package (by
top-level name: debwt_tpu_torch is not debwt_tpu), the plain reference
loads nothing of the program, and run.py prints no result without a
card or without the checkout's own program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import ROOT, tiny_copy

_RUN_TINY = """
import json, sys, torch
sys.path[:0] = [{src!r}, {root!r}]
from pathlib import Path
from benchmark import harness
r = harness.run_cell(harness.load_cell("dmel_140.cli", Path({tiny!r})),
                     4, 0.2, True, torch.device("cpu"))
print(json.dumps({{"correct": r["correct"], "found": harness.forbidden_modules(),
                  "all": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _py(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax(tmp_path):
    tiny_copy(tmp_path)
    p = _py(_RUN_TINY.format(src=str(ROOT / "src"), root=str(ROOT),
                             tiny=str(tmp_path)))
    assert p.returncode == 0, p.stderr[-2000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["found"] == []
    assert "debwt_tpu_torch" in got["all"]
    assert not {"jax", "jaxlib", "flax", "debwt_tpu"} & set(got["all"])


def test_forbidden_names_compare_whole():
    from benchmark import harness

    saved = dict(sys.modules)
    try:
        sys.modules["debwt_tpu_torch_x"] = sys
        sys.modules["jaxlike"] = sys
        assert "debwt_tpu_torch_x" not in harness.forbidden_modules()
        assert "jaxlike" not in harness.forbidden_modules()
        sys.modules["debwt_tpu.api"] = sys
        assert "debwt_tpu.api" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_reference_loads_nothing_of_the_program():
    p = _py(f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
            "import benchmark.reference.bwt, benchmark.traffic.genomes, "
            "benchmark.measure.roofline, benchmark.measure.trace\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    loaded = p.stdout
    for name in ("debwt_tpu_torch", "debwt_tpu", "jax"):
        assert f"'{name}'" not in loaded


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dmel_140.fused",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_prints_no_result_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():       # decided at run time, not import
        pytest.skip("a CUDA card is present")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_run_prints_no_result_without_the_program(tmp_path):
    tiny_copy(tmp_path)
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "debwt_tpu_torch" in p.stderr
