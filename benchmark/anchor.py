"""The seed-0 anchor of the copied generators, run once on the card; not
a cell.

At seed 0, with no substitution, traffic/genomes.py's two models give
the collections whose outputs .bench_cache.json recorded:

  STRAINS4_140  the "repeats" model as bench.synth_reads draws it (four
                35 Mbp genomes, a 700 kb fragment): the reference
                binary's hashes (`ref_mbp140.0`), which the program's
                fused build and this benchmark's plain reference must
                both give
  HAP4_1000     the "uniform" model, four 250 Mbp genomes: the JAX
                package's SP length and blue count (`grouped_mbp1000.0`)
                on the program's grouped build, whose bytes the plain
                reference must give too

  python3 benchmark/anchor.py

prints one JSON line a collection and exits 1 if any differs.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REF_140 = {   # .bench_cache.json ref_mbp140.0 (the reference binary)
    "obj_sha": "22238ddf77f4c9174d88441d75593373649767ed4f556e14af61ef7e946cc713",
    "sharp_sha": "f4719fb6f4f2688121643f1faea7183f070bd43243cf3b8534d2999cca92560f",
    "dollar": 89991985,
}
GROUPED_1000 = {"sp_len": 5459003, "n_blue": 5458953}   # grouped_mbp1000.0
STRAINS4_140 = {"model": "repeats", "mbp": 140.0, "genomes": 4,
                "mutation_rate": 0.002, "repeat_frac": 0.1,
                "repeat_len": 700_000}
HAP4_1000 = {"model": "uniform", "mbp": 1000.0, "genomes": 4,
             "mutation_rate": 0.002}


def _hashes(obj: bytes, sharp, dollar) -> dict:
    import numpy as np

    return {"obj_sha": hashlib.sha256(obj).hexdigest(),
            "sharp_sha": hashlib.sha256(
                np.asarray(sharp, dtype=np.int64).tobytes()).hexdigest(),
            "dollar": int(dollar)}


def _one(name: str, col: dict, dev) -> dict:
    import torch

    from benchmark.reference import bwt
    from benchmark.traffic import genomes
    from debwt_tpu_torch.api import build
    from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

    codes, lengths = genomes.make_codes(col, 0)
    coll = SequenceCollection.from_concat(codes, lengths)
    stats = {}
    t0 = time.perf_counter()
    res = build(coll, PipelineConfig(m=32), device=dev, stats=stats)
    prog = bwt.Answer(res.packed(), res.sharp_pos, res.dollar_pos)
    t_build = time.perf_counter() - t0
    del res, coll
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = bwt.reference_answer(bwt.text6(codes, lengths, dev))
    t_ref = time.perf_counter() - t0
    packed, sharp, dollar = ref
    out = {"collection": name, "seconds_build": t_build, "seconds_reference": t_ref,
           "program": _hashes(prog.obj, prog.sharp, prog.dollar),
           "reference": _hashes(packed.cpu().numpy().tobytes(), sharp, dollar[0]),
           "compare": bwt.compare(prog, ref)}
    out["sp_len"], out["n_blue"] = stats.get("sp_len"), stats.get("n_blue")
    return out


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    dev = torch.device("cuda")
    ok = True
    r = _one("STRAINS4_140", STRAINS4_140, dev)
    r["ok"] = r["program"] == REF_140 and r["reference"] == REF_140
    ok &= r["ok"]
    print(json.dumps(r), flush=True)
    torch.cuda.empty_cache()
    r = _one("HAP4_1000", HAP4_1000, dev)
    r["ok"] = (r["sp_len"] == GROUPED_1000["sp_len"]
               and r["n_blue"] == GROUPED_1000["n_blue"]
               and r["program"] == r["reference"])
    ok &= r["ok"]
    print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
