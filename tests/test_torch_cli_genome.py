"""The path of chip_smoke.py's genome phase on the CPU at toy sizes: the
synthetic FASTA it writes (plain and gzip) read back by the streaming
ingest, the port's CLI on it pushed onto the grouped tier against the
JAX CLI and api.build, and the harness that runs the CLI in a fresh
process and reads what it prints (the trace's SP length and blue count,
the process's peak memory and the seconds it splits). All data is
integer: every comparison is exact."""

import gzip
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from debwt_tpu import grouped as jgrouped
from debwt_tpu.cli import main as jax_main
from debwt_tpu.io import read_collection as jax_read_collection
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch import api
from debwt_tpu_torch.cli import main as torch_main
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.io import read_collection, write_bwt
from debwt_tpu_torch.synth import (
    synth_codes, synth_collection, synth_concat_codes, synth_concat_collection,
)
from debwt_tpu_torch.types import PipelineConfig

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("_chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

MBP = 0.05                      # N = 50,004: 12,500 bases a genome, 20 on the last line
# the routing variables that push it onto the grouped tier in 3 groups
GROUPED_ENV = {"DEBWT_SINGLE_MAX_ROWS": "1000", "DEBWT_GROUPED_CAP": "20000"}


def _outputs(obj):
    return [Path(f"{obj}{ext}").read_bytes() for ext in ("", ".#", ".$")]


def _line_joined_fasta(path, codes, lengths):
    """The FASTA writer's plain version: a record's bases joined by
    newline every 80."""
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[codes]
    with open(path, "wb") as f:
        start = 0
        for i, n in enumerate(lengths.tolist()):
            seq = text[start : start + n].tobytes()
            start += n
            f.write(f">genome{i}\n".encode())
            f.write(b"\n".join(seq[j : j + 80] for j in range(0, n, 80)) + b"\n")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    fa = tmp_path_factory.mktemp("genome") / "genome.fa"
    made = chip_smoke._write_fasta(fa, MBP, synth_concat_codes)
    return fa, made


@pytest.mark.parametrize("ext", [".fa", ".fa.gz"])
@pytest.mark.parametrize("mbp", [0.05, 0.2])
def test_write_fasta_reads_back_as_synth_concat(tmp_path, mbp, ext):
    """The genome phase's input, plain and gzip at level 1: the streaming
    reader (in chunks smaller than the file) gives synth_concat's text,
    separators and reads, as the JAX package's reader does; the blocked
    writer writes the line-joined writer's bytes."""
    fa = tmp_path / f"g{ext}"
    made = chip_smoke._write_fasta(fa, mbp, synth_concat_codes)
    want = synth_concat_collection(mbp)
    assert (made["n"], made["n_reads"]) == (want.bwt_len, want.n_reads) == (
        int(mbp * 1e6) + 4, 4)
    assert made["synth_s"] >= 0 and made["write_s"] >= 0
    for got in (read_collection(str(fa), chunk_bytes=1 << 14),
                jax_read_collection(str(fa))):
        np.testing.assert_array_equal(got.x2, want.x2)
        np.testing.assert_array_equal(got.sep, want.sep)
        assert got.n_reads == want.n_reads
    plain = tmp_path / "plain.fa"
    _line_joined_fasta(plain, *synth_concat_codes(mbp))
    raw = gzip.decompress(fa.read_bytes()) if ext.endswith(".gz") else fa.read_bytes()
    assert raw == plain.read_bytes()


def test_write_fasta_default_generator_is_synth_codes(tmp_path):
    """Without a generator the writer takes synth_codes (the cli and
    dist phases' input), whose lengths are not multiples of 80."""
    fa = tmp_path / "g.fa"
    made = chip_smoke._write_fasta(fa, MBP)
    want = synth_collection(MBP)
    assert (made["n"], made["n_reads"]) == (want.bwt_len, want.n_reads)
    got = read_collection(str(fa))
    np.testing.assert_array_equal(got.x2, want.x2)
    np.testing.assert_array_equal(got.sep, want.sep)
    plain = tmp_path / "plain.fa"
    _line_joined_fasta(plain, *synth_codes(MBP))
    assert fa.read_bytes() == plain.read_bytes()


def test_port_cli_on_the_grouped_tier_writes_jax_cli_and_api_bytes(
        fasta, tmp_path, monkeypatch, capsys):
    """The port's CLI on the synth_concat FASTA, pushed onto the grouped
    tier by the routing variables, with --check --verify: the JAX CLI's
    three files, and api.build's; it traces the JAX grouped tier's SP
    length and blue count."""
    fa, made = fasta
    for k, v in GROUPED_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DEBWT_TRACE", "1")
    capsys.readouterr()
    assert torch_main(["-o", str(tmp_path / "port.bwt"), "--device", "cpu",
                       "--check", "--verify", str(fa)]) == 0
    err = capsys.readouterr().err
    assert "route: grouped device-resident tier" in err
    assert "[debwt-torch] LF invertibility: OK" in err
    coll = synth_concat_collection(MBP)
    jstats = {}
    jgrouped.build_bwt_grouped(JaxCollection(x2=coll.x2, sep=coll.sep),
                               JaxConfig(m=32), jgrouped.GroupedConfig(cap=20000),
                               stats=jstats)
    assert f"[debwt-torch grouped] SP string: {jstats['sp_len']} events" in err
    assert f"[debwt-torch grouped] blue entries: {jstats['n_blue']}" in err
    assert jax_main(["-o", str(tmp_path / "jax.bwt"), "--check", "--verify",
                     str(fa)]) == 0
    res = api.build(coll, PipelineConfig(m=32, check=True), device="cpu")
    assert "groups.select" in res.timings
    write_bwt(res, str(tmp_path / "api.bwt"))
    assert (_outputs(tmp_path / "port.bwt") == _outputs(tmp_path / "jax.bwt")
            == _outputs(tmp_path / "api.bwt"))
    assert made["n"] == coll.bwt_len


def test_run_cli_reads_the_process(fasta):
    """chip_smoke._run_cli on the CPU: a fresh CLI process on the grouped
    tier held to golden's hashes; what it returns holds the trace's SP
    length and blue count, the plan, the stage seconds, the launches (0:
    the CPU runs the plain versions), and what _CLI_MAIN prints after
    the CLI returns: the peak resident set, no card bytes, the write,
    walk, start, import and exit seconds."""
    fa, made = fasta
    coll = synth_concat_collection(MBP)
    g = golden_bwt(coll)
    ref = {"obj_sha": hashlib.sha256(g.packed()).hexdigest(),
           "sharp_sha": hashlib.sha256(g.sharp_pos.astype(np.int64).tobytes()).hexdigest(),
           "dollar": int(g.dollar_pos)}
    jstats = {}
    jgrouped.build_bwt_grouped(JaxCollection(x2=coll.x2, sep=coll.sep),
                               JaxConfig(m=32), jgrouped.GroupedConfig(cap=20000),
                               stats=jstats)
    written0 = dict(chip_smoke._WRITTEN)
    run = chip_smoke._run_cli(
        fa, ["--check", "--timings", "--verify", "--verify-steps", "4096"],
        GROUPED_ENV, torch.device("cpu"), ref, timeout=120)
    assert run["route"] == [f"grouped device-resident tier (N={coll.bwt_len}, one device)"]
    G, cap, chunk, n_chunks, ns_cap = chip_smoke._grouped_plan(run)
    assert G >= 2 and cap <= 20000 and n_chunks >= 1 and ns_cap > 0
    assert (run["sp_len"], run["n_blue"]) == (jstats["sp_len"], jstats["n_blue"])
    assert run["verify"] == ["[debwt-torch] LF invertibility: OK"]
    assert run["launches"] == {"window_keys": 0, "window_keys_at": 0, "seg_scan_or": 0}
    assert {"groups.select", "groups.classify", "SP rank", "blue fill"} <= set(run["stage_s"])
    assert all(v >= 0 for v in run["stage_s"].values())
    assert run["hashes"] == ref and run["sharp_pos"] == g.sharp_pos.tolist()
    assert run["file_bytes"] == {"": 8 * ((coll.bwt_len + 31) // 32),
                                 ".#": 8 * (coll.n_reads - 1), ".$": 8}
    proc = run["process"]
    assert proc["vmhwm_bytes"] >= proc["rss_peak_sampled_bytes"] > 0
    assert proc["max_memory_allocated"] is None and proc["max_memory_reserved"] is None
    assert "cuda_context_s" not in proc
    assert proc["write_s"] > 0 and proc["verify_s"] > 0
    assert proc["start_s"] > 0 and proc["exit_s"] >= 0
    assert proc["imports_s"] >= proc["torch_import_s"] > 0
    assert 0 < run["ingest_s"] + run["build_s"] < run["process_s"]
    # the child's write calls are counted, its output files among them
    wrote = chip_smoke._WRITTEN["children_wchar"] - written0["children_wchar"]
    assert wrote >= sum(run["file_bytes"].values())
    assert chip_smoke._WRITTEN["tmpfs"] == written0["tmpfs"]


def test_tmpfs_mounts_and_disk_bytes():
    """The tmpfs list the genome phase chooses from, the most free
    first; the disk tally leaves out what went to a tmpfs."""
    mounts = chip_smoke._tmpfs_mounts()
    assert all(set(m) == {"mount", "free_bytes"} and m["free_bytes"] >= 0
               for m in mounts)
    assert len({m["mount"] for m in mounts}) == len(mounts)
    assert not any(m["mount"].startswith(("/sys/", "/proc/")) for m in mounts)
    assert [m["free_bytes"] for m in mounts] == sorted(
        (m["free_bytes"] for m in mounts), reverse=True)
    w = {"own_wchar": 10, "children_wchar": 20, "mapped": 5, "tmpfs": 12}
    assert chip_smoke.disk_bytes(w) == 23
