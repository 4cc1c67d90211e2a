"""Witness runs of the plain reference's two paths and of the read-set
model, run once on the card; not a cell.

  python3 benchmark/witness.py genome   the blocked sort alone on
      `uniform` 3000 Mbp, four genomes, 0.2%, seed 0 (N = 3,000,000,004,
      past 2^31): the generator first held to the program's
      synth_concat_codes(3000.0), then the reference's hashes held to
      the program's own 3 Gbp record (chip_smoke.GENOME_HASHES); its
      seconds, rounds, peak device bytes and host peak RSS
  python3 benchmark/witness.py hap4     hap4_1000 at seed 0 by the one
      sort and by the blocked sort: the same bytes
  python3 benchmark/witness.py reads    the E. coli 30x read set at seed
      0 through api.build (route, rows, seconds of each build, the
      special module's seconds) against the reference

Each prints one JSON line and exits 1 where a comparison fails. Run each
in a process of its own, so that its peaks are its own. `--mbp` cuts a
collection for a rehearsal on the CPU (`--device cpu`), where the
recorded hashes are not compared.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GENOME = {"model": "uniform", "mbp": 3000.0, "genomes": 4,
          "mutation_rate": 0.002}
GENOME_HASHES = {   # chip_smoke.GENOME_HASHES: the port's own 3 Gbp build
    "obj_sha": "9de95ddf21d8dce6b441465b6035964d0e722f1f149b6bcaf52a00c4f2090d97",
    "sharp_sha": "eb56453b5bee26e43351f6794c7487aed1cd92e007bbc3d52680624f4b2e6eef",
    "dollar": 2_733_368_556,
}
# E. coli K-12 MG1655 (NC_000913.3, 4,641,652 bp) at 30x in 150-base reads
ECOLI_30X = {"model": "reads", "genome_mbp": 4.641652, "read_len": 150,
             "coverage": 30, "error_rate": 0.001, "rc_share": 0.5}


def _hashes(packed, sharp, dollar) -> dict:
    return {"obj_sha": hashlib.sha256(packed.cpu().numpy().tobytes()).hexdigest(),
            "sharp_sha": hashlib.sha256(sharp.tobytes()).hexdigest(),
            "dollar": int(dollar[0])}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def genome(dev, mbp: float | None) -> dict:
    import numpy as np
    import torch

    from benchmark.measure.host import RssPeak
    from benchmark.reference import bwt
    from benchmark.traffic import genomes
    from debwt_tpu_torch.synth import synth_concat_codes

    col = dict(GENOME, mbp=mbp or GENOME["mbp"])
    out = {"witness": "genome", "mbp": col["mbp"]}
    with RssPeak() as rss:
        t0 = time.perf_counter()
        codes, lengths = genomes.make_codes(col, 0)
        out["generate_s"] = time.perf_counter() - t0
        want_codes, want_lengths = synth_concat_codes(col["mbp"])
        out["synth_equal"] = bool(np.array_equal(codes, want_codes)
                                  and np.array_equal(lengths, want_lengths))
        del want_codes, want_lengths
        t0 = time.perf_counter()
        x = bwt.text6(codes, lengths, dev)
        del codes
        _sync(dev)
        out["N"] = x.shape[0]
        out["text6_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        stats = {}
        t0 = time.perf_counter()
        sa = bwt.blocked_suffix_array(x, stats=stats)
        _sync(dev)
        out["sort_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bwt6 = bwt.bwt_from_sa(x, sa)
        del sa, x
        sharp = bwt._positions(bwt6, bwt.SHARP)
        dollar = bwt._positions(bwt6, bwt.DOLLAR)
        packed = bwt.pack(bwt6)
        del bwt6
        _sync(dev)
        out["finish_s"] = time.perf_counter() - t0
        out.update(stats)
        out["reference"] = _hashes(packed, sharp, dollar)
    out["seconds"] = out["sort_s"] + out["finish_s"]
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else None)
    out["host_peak_rss_bytes"] = rss.bytes
    out["ok"] = out["synth_equal"] and (
        mbp is not None or out["reference"] == GENOME_HASHES)
    return out


def hap4(dev, mbp: float | None) -> dict:
    import numpy as np
    import torch

    from benchmark import harness
    from benchmark.reference import bwt
    from benchmark.traffic import genomes

    col = harness.load_cell("hap4_1000.grouped").config["collection"]
    col = dict(col, mbp=mbp or col["mbp"])
    codes, lengths = genomes.make_codes(col, 0)
    x = bwt.text6(codes, lengths, dev)
    del codes
    out = {"witness": "hap4", "mbp": col["mbp"], "N": x.shape[0],
           "one_sort_fits": bwt.one_sort_fits(x)}
    answers = {}
    for name, blocked in (("one_sort", False), ("blocked", True)):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        stats = {}
        t0 = time.perf_counter()
        answers[name] = bwt.reference_answer(x, blocked=blocked, stats=stats)
        _sync(dev)
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_peak_device_bytes"] = (
            torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
        out.update({f"{name}_{k}": v for k, v in stats.items()})
    (p1, s1, d1), (p2, s2, d2) = answers["one_sort"], answers["blocked"]
    out["obj_bytes_differ"] = (abs(p1.shape[0] - p2.shape[0])
                               + int((p1 != p2).sum()))
    out["sidecars_equal"] = bool(np.array_equal(s1, s2)
                                 and np.array_equal(d1, d2))
    out["hashes"] = _hashes(p2, s2, d2)
    out["ok"] = out["obj_bytes_differ"] == 0 and out["sidecars_equal"]
    return out


def reads(dev, mbp: float | None, builds: int = 3) -> dict:
    import torch

    from benchmark.reference import bwt
    from benchmark.traffic import genomes
    from debwt_tpu_torch import api
    from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

    col = dict(ECOLI_30X, genome_mbp=mbp or ECOLI_30X["genome_mbp"])
    codes, lengths = genomes.make_codes(col, 0)
    coll = SequenceCollection.from_concat(codes, lengths)
    config = PipelineConfig(m=32)
    rows, bound = api.rows_needed(coll, 32), api.single_rows_bound(dev)
    out = {"witness": "reads", "collection": col, "n_reads": len(lengths),
           "bases": int(lengths.sum()), "N": coll.bwt_len,
           "rows_needed": rows, "single_rows_bound": bound,
           "route": "fused" if rows < bound else "grouped or ooc",
           "build_s": [], "special_host_s": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(builds):
        t0 = time.perf_counter()
        res = api.build(coll, config, device=dev, verbose=True)
        ans = bwt.Answer(res.packed(), res.sharp_pos, res.dollar_pos)
        out["build_s"].append(time.perf_counter() - t0)
        out["special_host_s"].append(res.timings.get("special module (host)"))
        out["counters"] = dict(res.counters)
        del res
    out["peak_device_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else None)
    del coll
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x = bwt.text6(codes, lengths, dev)
    out["one_sort_fits"] = bwt.one_sort_fits(x)
    out["compare"] = bwt.compare(ans, bwt.reference_answer(x))
    out["reference_s"] = time.perf_counter() - t0
    out["ok"] = all(v == 0 for v in out["compare"].values())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("witness", choices=("genome", "hap4", "reads"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--mbp", type=float, default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    dev = torch.device(args.device)
    r = {"genome": genome, "hap4": hap4, "reads": reads}[args.witness](
        dev, args.mbp)
    if dev.type == "cuda":
        r["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(r), flush=True)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
