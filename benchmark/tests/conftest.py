"""CPU tests of the benchmark: `python -m pytest benchmark/tests -q`.

Cells run here at a tiny size on the CPU (harness.run_cell with
torch.device("cpu")); run.py itself refuses to run without a card.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MBP = 0.05


def tiny_copy(dest: Path, mbp: float = TINY_MBP) -> Path:
    """BENCHMARK.json and benchmark/ copied under dest, every
    configuration's collection cut to `mbp`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "benchmark" / "configs").glob("*.json"):
        d = json.loads(f.read_text())
        d["collection"]["mbp"] = mbp
        f.write_text(json.dumps(d))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(tmp_path)
