"""The generator: the `repeats` and `uniform` models pinned to the
collections they gave before the `reads` model was added, the `reads`
model's draws, and a read set through the library entry on the CPU
against the plain reference."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.traffic import genomes

# sha256 of codes then lengths (little-endian int64) at 0.2 Mbp
PINNED = {
    ("dmel_140", 0): "00c65ca189d6076b8ba17d96bed0f9366cbef89a9cb4762ee171a5cb43e88135",
    ("dmel_140", 7): "9c6a29ad8a45316b6f9c81fa8850d7d89308c7e1204a8737ff91fefd82e410ef",
    ("dmel_140", 2147483651): "7c9e1ff95549f472e8402f50514e6b449e35c43cd65e6a2699418c0185ccf85c",
    ("hap4_1000", 0): "7718eee30dd77636dedbb825ae553d5c079ed86848f0df2fc081b2fbd27aff40",
    ("hap4_1000", 7): "98a9e2795a7eae39f128a341c4f74a141615710bd64cc1caa2e6eb20bbdccdfd",
    ("hap4_1000", 2147483651): "2d4cb6b9852651de31dde6c8ae2cf36b092881bbcb7ac0b15e54460aef21f75c",
    ("salmonella50_243", 0): "54dba45e2ff57b3845b4e870e8f7626eaa22d91ab39481189ef9bd90a303f2cd",
    ("salmonella50_243", 7): "871596fc439cfc7cc954c18c3ea0aacd1b04558ce4435f4989d06e945b6fda51",
    ("salmonella50_243", 2147483651): "a32b35c8e41e5ee6b68631eaa11b42dcff51c80a2c66a5429077b69618b43d4f",
}
# E. coli K-12 MG1655 (NC_000913.3) at 30x in 150-base reads
ECOLI_30X = {"model": "reads", "genome_mbp": 4.641652, "read_len": 150,
             "coverage": 30, "error_rate": 0.001, "rc_share": 0.5}


def _collection(config: str) -> dict:
    path = harness.ROOT / "benchmark" / "configs" / f"{config}.json"
    return json.loads(path.read_text())["collection"]


@pytest.mark.parametrize("config,seed", sorted(PINNED))
def test_the_genome_models_are_unchanged(config, seed):
    codes, lengths = genomes.make_codes(dict(_collection(config), mbp=0.2),
                                        seed)
    got = hashlib.sha256(codes.tobytes()
                         + lengths.astype("<i8").tobytes()).hexdigest()
    assert got == PINNED[config, seed]


def _reads(seed: int, **kw):
    col = dict(ECOLI_30X, genome_mbp=0.02, read_len=100, coverage=10, **kw)
    return genomes.make_codes(col, seed)


@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_reads_are_the_genome_or_its_reverse_complement(seed):
    codes, lengths = _reads(seed, error_rate=0.0)
    assert lengths.tolist() == [100] * 2000
    genome = np.random.default_rng(seed).integers(0, 4, size=20_000,
                                                  dtype=np.uint8)
    windows = {w.tobytes() for w in
               np.lib.stride_tricks.sliding_window_view(genome, 100)}
    reads = codes.reshape(-1, 100)
    fwd = np.array([r.tobytes() in windows for r in reads])
    rc = np.array([(3 - r[::-1]).tobytes() in windows for r in reads])
    assert (fwd | rc).all()
    assert 0.45 < rc.mean() < 0.55
    assert genomes.make_codes(dict(ECOLI_30X, genome_mbp=0.02, read_len=100,
                                   coverage=10, error_rate=0.0), seed
                              )[0].tobytes() == codes.tobytes()


@pytest.mark.parametrize("seed", [3, 4])
def test_read_errors_are_substitutions_at_the_rate(seed):
    """The draws before the errors do not depend on the rate, so the
    same seed without errors shows where they fell."""
    exact, _ = _reads(seed, error_rate=0.0)
    noisy, _ = _reads(seed, error_rate=0.01)
    off = exact != noisy
    assert abs(off.mean() - 0.01) < 0.001
    assert (noisy < 4).all()


def test_the_ecoli_read_set_sizes():
    codes, lengths = genomes.make_codes(ECOLI_30X, 0)
    assert lengths.shape[0] == 928_330 and codes.shape[0] == 139_249_500
    assert (lengths == 150).all()


@pytest.mark.parametrize("seed", [2**31 + 13, 17])
def test_a_read_set_through_the_library_entry(tiny_root, seed):
    """The program's library entry on 266 reads of 150 bases, every kept
    build compared with the plain reference."""
    b = tiny_root / "benchmark"
    (b / "configs" / "reads_tiny.json").write_text(json.dumps({
        "name": "reads_tiny", "collection": dict(
            ECOLI_30X, genome_mbp=0.01, coverage=4, error_rate=0.002)}))
    (b / "traffic" / "every_m32.json").write_text(json.dumps({
        "entry": "library", "m": 32, "checked_share": 1.0, "env": {}}))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "reads_tiny.fused",
                               "config": "reads_tiny", "traffic": "every_m32",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("reads_tiny.fused")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run_cell(harness.load_cell("reads_tiny.fused", tiny_root),
                         seed, 0.3, False, torch.device("cpu"))
    assert r["correct"] and r["failed"] == 0
    assert r["checks"] == {k: (0, 0) for k in harness.LIMITS}
    assert r["_notes"]["checked_builds"] == list(range(1, r["attempted"] + 1))
