"""The benchmark of debwt_tpu_torch on CUDA cards.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device (and
with --trace 1 breakdown), then checks: each number compared with the
plain reference, beside its limit, which are also the last lines of
standard error. BENCHMARK.json names the cells and metrics; harness.py
says how a run goes.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), when the program is not the checkout's own
src/debwt_tpu_torch, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _environment():
    """Caches at fixed paths inside the checkout; the program's routing
    and tracing variables cleared, so that a cell takes the default
    route unless its traffic file sets one."""
    cache = ROOT / "_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for k in [k for k in os.environ if k.startswith("DEBWT_")]:
        del os.environ[k]
    # the checkout's program and the benchmark package; not the
    # script's own folder, whose subfolders would shadow top-level names
    here = (ROOT / "benchmark").resolve()
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]


def _fail(msg: str) -> int:
    print(f"[bench] {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        return _fail("--seed must be >= 0 and --seconds > 0")
    _environment()

    import torch

    own = (ROOT / "src" / "debwt_tpu_torch").resolve()
    try:
        import debwt_tpu_torch
    except ImportError as e:
        return _fail(f"the program debwt_tpu_torch is not in {own}: {e}")
    if Path(debwt_tpu_torch.__file__).resolve().parent != own:
        return _fail(f"debwt_tpu_torch comes from {debwt_tpu_torch.__file__},"
                     f" not {own}")
    if not torch.cuda.is_available():
        return _fail("no CUDA device is available")
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} visible")
    for k, v in cell.traffic.get("env", {}).items():
        os.environ[k] = str(v)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        return _fail(f"loaded in this process: {', '.join(found)}")
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
