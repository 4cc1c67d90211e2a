"""Faults planted under the timed path, each of which has to make a run
come out not correct: a build that returns its state unchanged (the
answer of the process's first build), one that leaves half of the text
out, and one whose answer is altered where it is produced. Every cell
runs on one chip, so no exchange between chips can be left out.

  python3 benchmark/faults.py --workload <cell> --seed <n> --seconds <s> [--fault stale half altered]

runs the cell once a fault on the card at its own size and prints one
JSON line a fault with what `correct` read and the numbers compared;
exits 1 if any fault came out correct. tests/test_bench_faults.py runs
each at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def stale(patch):
    import debwt_tpu_torch.api as api

    real, first = api.build, {}

    def build(coll, config=None, device=None, **kw):
        if "r" not in first:
            first["r"] = real(coll, config, device=device, **kw)
        return first["r"]

    patch(api, "build", build)


def half(patch):
    import numpy as np

    import debwt_tpu_torch.api as api
    from debwt_tpu_torch.types import SequenceCollection

    real = api.build

    def build(coll, config=None, device=None, **kw):
        h = coll.bwt_len // 2
        sub = SequenceCollection(
            x2=np.append(coll.x2[:h], np.uint8(3)),
            sep=np.append(coll.sep[coll.sep < h], h))
        return real(sub, config, device=device, **kw)

    patch(api, "build", build)


def altered(patch):
    from debwt_tpu_torch.pipeline import BwtResult

    real = BwtResult.packed

    def packed(self):
        b = bytearray(real(self))
        b[len(b) // 2] ^= 0x40
        return bytes(b)

    patch(BwtResult, "packed", packed)


FAULTS = {"stale": stale, "half": half, "altered": altered}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", nargs="+", choices=sorted(FAULTS),
                   default=sorted(FAULTS))
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    caught = True
    for name in args.fault:
        undo = []

        def patch(obj, attr, value):
            undo.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)

        FAULTS[name](patch)
        try:
            r = harness.run_cell(cell, args.seed, args.seconds, False, dev)
        finally:
            for obj, attr, value in reversed(undo):
                setattr(obj, attr, value)
        torch.cuda.empty_cache()
        caught &= r["correct"] is False
        print(json.dumps({"fault": name, "workload": args.workload,
                          "seed": args.seed, "correct": r["correct"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "checks": r["checks"]}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
