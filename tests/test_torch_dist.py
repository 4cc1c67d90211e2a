"""The port's multi-device tier on the CPU at 2 and 3 ranks: gloo rank
processes (tests/torch_dist_worker.py, one launch a world size, started
before the JAX references are computed) against the JAX tier on the
8-device CPU mesh and golden, exactly. Also the poly-T input on which
the JAX tier fails at m = 32, the ooc x dist composition, the routes of
api.build and the CLI's --dist, and the guards."""

import os
import subprocess
import sys

import numpy as np
import pytest

from debwt_tpu.cli import main as jax_main
from debwt_tpu.parallel import dist_build_bwt as jax_dist
from debwt_tpu.parallel import make_mesh as jax_mesh
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.oocore import OocConfig, build_bwt_ooc
from debwt_tpu_torch.parallel import dist_build_bwt, make_mesh
from debwt_tpu_torch.pipeline import build_bwt, rows_needed
from debwt_tpu_torch.types import PipelineConfig, SequenceCollection

from conftest import random_reads
from torch_dist_worker import SRC, every_rank, launch, poly_t_reads, rand_reads


def ooc_reads():
    """tests/test_oocore.py's repeat-heavy input: a long SP string."""
    rng = np.random.default_rng(0)
    motif = "ACGTTGCAACCGGTT" * 3
    return [motif * 4 + "".join(rng.choice(list("ACGT"), size=60))
            for _ in range(8)]


API_READS = random_reads(np.random.default_rng(0), 6, lo=50, hi=200)
CLI_READS = random_reads(np.random.default_rng(11), 6, lo=50, hi=200)
POLY_T = (32, 33, 34, 40)

CASES = {
    2: [dict(name="rand", kind="build", reads=rand_reads(2))]
    + [dict(name=f"polyT{L}", kind="build", reads=poly_t_reads(L), m=32)
       for L in POLY_T]
    + [dict(name="ooc", kind="ooc", reads=ooc_reads(), m=14, chunk=256,
            n_buckets=8, sp_cap=16),
       dict(name="ooc_spill", kind="ooc", reads=ooc_reads(), m=14, chunk=256,
            n_buckets=8, sp_cap=16, spill_dir="spill", checkpoint=True),
       dict(name="api_n", kind="api", reads=API_READS, n_devices=2),
       dict(name="api_world", kind="api", reads=API_READS,
            single_rows=rows_needed(SequenceCollection.from_reads(API_READS), 32)),
       dict(name="guard", kind="guard", bwt_len=2**33, expect_error=True),
       dict(name="rank_card", kind="rank_card", reads=API_READS, cards=4,
            local_offset=2),
       dict(name="cli_verify", kind="cli", reads=CLI_READS, args=["--verify"]),
       dict(name="cli_verify_tampered", kind="cli", reads=CLI_READS,
            args=["--dist", "2", "--verify"], tamper=True)],
    3: [dict(name="rand", kind="build", reads=rand_reads(3))],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch a world size; a case's spill_dir is made a path in its
    launch's directory."""
    out = {}
    for n, cases in CASES.items():
        d = tmp_path_factory.mktemp(f"ranks{n}")
        cases = [dict(c, spill_dir=str(d / c["spill_dir"])) if "spill_dir" in c
                 else c for c in cases]
        out[n] = launch(d, n, cases)
    return out


def _jax(reads, n, m=32):
    return jax_dist(JaxCollection.from_reads(reads), JaxConfig(m=m), jax_mesh(n))


@pytest.mark.parametrize("n", [2, 3])
def test_random_device_counts(runs, n):
    reads = CASES[n][0]["reads"]
    got = runs[n].results()["rand"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(reads)))
    every_rank(got, _jax(reads, n))


def test_poly_t_at_m32_jax_tier_fails_port_matches_golden(runs):
    """32 'T's in a row at m = 32: the JAX tier takes those edges for
    pads and its stitch comes up short (AssertionError); the port
    builds golden's BWT, which its fused engine builds too."""
    reads = poly_t_reads(32)
    coll = SequenceCollection.from_reads(reads)
    want = golden_bwt(coll)
    every_rank(runs[2].results()["polyT32"], want)
    fused = build_bwt(coll, PipelineConfig(m=32), device="cpu")
    assert fused.packed() == want.packed()
    with pytest.raises(AssertionError):
        _jax(reads, 2)


@pytest.mark.parametrize("L", POLY_T[1:])
def test_poly_t_longer_runs(runs, L):
    every_rank(runs[2].results()[f"polyT{L}"],
                golden_bwt(SequenceCollection.from_reads(poly_t_reads(L))))


def test_ooc_sharded_sp_rank(runs):
    """ooc x dist: a forced-tiny sp_cap shards the SP ranking over the
    2 ranks; the bytes stay golden's."""
    got = runs[2].results()["ooc"]
    want = golden_bwt(SequenceCollection.from_reads(ooc_reads()))
    every_rank(got, want)
    assert all(bool(g["sharded_rank"]) and int(g["sp_len"]) > 16 for g in got)


def test_ooc_ranks_spill_and_checkpoint_apart(runs):
    """ooc x dist with one spill_dir and checkpoints for both ranks (as
    ranks sharing a host have): each rank spills and keeps its manifest
    under spill_dir/rank{r}, ends with that directory empty (no bucket
    file, no bwt6.u8, no manifest), and builds golden's bytes."""
    got = runs[2].results()["ooc_spill"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(ooc_reads())))
    assert all(bool(g["sharded_rank"]) for g in got)
    spill = runs[2].out / "spill"
    assert sorted(os.listdir(spill)) == ["rank0", "rank1"]
    for r in range(2):
        assert os.listdir(spill / f"rank{r}") == []


def test_ooc_past_sp_cap_needs_a_mesh():
    coll = SequenceCollection.from_reads(
        random_reads(np.random.default_rng(0), 6, lo=60, hi=150))
    with pytest.raises(NotImplementedError, match="no multi-device mesh"):
        build_bwt_ooc(coll, PipelineConfig(m=14),
                      OocConfig(chunk=256, n_buckets=4, sp_cap=1), device="cpu")


def test_api_forced_dist(runs):
    """api.build(n_devices=2), as tests/test_api.py's forced route."""
    got = runs[2].results()["api_n"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(API_READS)))
    assert all(int(g["dist_calls"]) == 1 for g in got)


def test_api_routes_a_joined_group_over_the_bound(runs):
    """With the single-device bound lowered under the collection's rows
    and a 2-rank group joined, api.build takes the dist tier."""
    got = runs[2].results()["api_world"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(API_READS)))
    assert all(int(g["dist_calls"]) == 1 for g in got)


def test_api_builds_on_the_rank_card(runs):
    """In a joined group, api.build with no device named sizes its bound
    by and builds on cuda:LOCAL_RANK (LOCAL_RANK = rank + 2 of 4 faked
    cards), made the current device; the bytes are golden's."""
    got = runs[2].results()["rank_card"]
    every_rank(got, golden_bwt(SequenceCollection.from_reads(API_READS)))
    for rank, g in enumerate(got):
        card = [f"cuda:{rank + 2}"]
        assert (g["bound"].tolist(), g["build"].tolist(),
                g["set_device"].tolist()) == (card, card, card)


def test_cli_verify_runs_on_every_rank(runs):
    """--verify walks every rank's own copy: 0 on both ranks for a good
    result, 2 on both for a tampered one (the JAX CLI's behaviour);
    rank 0 alone prints."""
    ok, bad = (runs[2].results()[k] for k in ("cli_verify", "cli_verify_tampered"))
    assert [int(g["rc"]) for g in ok] == [0, 0]
    assert [int(g["rc"]) for g in bad] == [2, 2]
    assert "LF invertibility: OK" in str(ok[0]["stderr"])
    assert "LF invertibility: FAILED" in str(bad[0]["stderr"])
    assert str(ok[1]["stderr"]) == str(bad[1]["stderr"]) == ""


def test_per_shard_guard(runs):
    for g in runs[2].results()["guard"]:
        assert "NotImplementedError" in str(g["error"])
        assert "per-shard" in str(g["error"])


def test_default_device_needs_a_card():
    coll = SequenceCollection.from_reads(API_READS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_build_bwt(coll)


def test_a_mesh_of_several_needs_a_joined_group():
    with pytest.raises(ValueError, match="DEBWT_NUM_PROCESSES"):
        make_mesh(2, device="cpu")


def _write_fasta(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">read{i}\n{r}\n")


def test_cli_dist_two_processes(tmp_path):
    """Two processes run --dist 2 --device cpu joined by the DEBWT_*
    variables; rank 0 writes golden's bytes, which the JAX CLI's
    --dist 2 writes too."""
    fa = tmp_path / "in.fa"
    _write_fasta(fa, CLI_READS)
    out = tmp_path / "torch.bwt"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               DEBWT_COORDINATOR="file://" + str(tmp_path / "rdv"),
               DEBWT_NUM_PROCESSES="2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "debwt_tpu_torch.cli", "--dist", "2",
             "--device", "cpu", "-o", str(out), str(fa)],
            env=dict(env, DEBWT_PROCESS_ID=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)
    ]
    jax_out = tmp_path / "jax.bwt"
    assert jax_main(["--dist", "2", "-o", str(jax_out), str(fa)]) == 0
    logs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    assert "distributed over 2 devices" in logs[0][1]
    assert logs[1][1] == ""                     # rank 1 prints nothing
    g = golden_bwt(SequenceCollection.from_reads(CLI_READS))
    assert out.read_bytes() == g.packed()
    for ext in ("", ".#", ".$"):
        assert (tmp_path / f"torch.bwt{ext}").read_bytes() == (
            tmp_path / f"jax.bwt{ext}").read_bytes()
