"""The control of the check: what `correct` reads when the program's
answers are the plain reference's computed one step short of what the
configuration states.

deBWT states an exact suffix order (byte-identical output). The step a
later change might be tempted to take is to sort suffixes on their
first k = 32 characters only, the de Bruijn node's length, and leave
longer branches in text order: reference/bwt.py's suffix_array with
depth 32. For each seed this prints the numbers the run compares, for
the input of the window's first build, with the reference's seconds.

  python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Run on the card at the cell's own size;
tests/test_bench_reference.py::test_the_control_is_not_correct holds
it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEPTH = 32


def readings(col: dict, seed: int, dev, build: int = 1) -> dict:
    """The numbers compared, control against reference, for build
    `build`'s input, and the seconds of each."""
    import torch

    from benchmark.reference import bwt
    from benchmark.traffic import genomes

    codes, lengths = genomes.make_codes(col, seed)
    q, shift = genomes.substitution(seed, build, codes.shape[0])
    codes[q] = (codes[q] + shift) % 4
    x = bwt.text6(codes, lengths, dev)
    del codes
    t0 = time.perf_counter()
    ref = bwt.reference_answer(x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_ref = time.perf_counter() - t0
    packed, sharp, dollar = bwt.reference_answer(x, depth=DEPTH)
    t_ctl = time.perf_counter() - t0 - t_ref
    del x
    ctl = bwt.Answer(packed.cpu().numpy().tobytes(), sharp,
                     dollar[0] if dollar.shape[0] else -1)
    del packed
    out = bwt.compare(ctl, ref)
    out.update(reference_s=t_ref, control_s=t_ctl)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        r = readings(cell.config["collection"], seed, dev)
        print(json.dumps({"control": args.workload, "seed": seed, **r}),
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
