"""The port's ingest, writer and command line against the JAX package's,
on the CPU, and the port's import isolation from JAX."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from debwt_tpu.cli import main as jax_main
from debwt_tpu.io import read_collection as jax_read_collection
from debwt_tpu.io import read_fasta as jax_read_fasta
from debwt_tpu_torch.cli import main as torch_main
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.io import read_bwt, read_collection, read_reads, write_bwt
from debwt_tpu_torch.types import SequenceCollection

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _write_fasta(path, reads, width=70):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f">read{i} description\n")
            for j in range(0, len(r), width):
                f.write(r[j : j + width] + "\n")


def _reads(rng, n, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(40, 200))))
            for _ in range(n)]


def _outputs(obj):
    return [open(str(obj) + ext, "rb").read() for ext in ("", ".#", ".$")]


@pytest.mark.parametrize(
    "m,policy,alphabet",
    [(32, "reject", "ACGT"), (12, "reject", "ACGT"),
     (24, "random", "ACGTN"), (31, "to-g", "ACGTN")],
)
def test_cli_matches_jax_cli(tmp_path, rng, m, policy, alphabet):
    """Same FASTA, same flags: the three output files are byte-identical."""
    path = tmp_path / "in.fa"
    _write_fasta(path, _reads(rng, 7, alphabet))
    args = ["-k", str(m), "--n-policy", policy, "--seed", "5", "--check",
            "-t", "8", str(path)]
    assert jax_main(["-o", str(tmp_path / "jax.bwt"), *args]) == 0
    assert torch_main(["-o", str(tmp_path / "port.bwt"), "--device", "cpu",
                       *args]) == 0
    assert _outputs(tmp_path / "port.bwt") == _outputs(tmp_path / "jax.bwt")


def test_cli_timings_and_unwritable_output(tmp_path, rng, capsys):
    path = tmp_path / "in.fa"
    _write_fasta(path, _reads(rng, 3))
    assert torch_main(["-o", str(tmp_path / "o.bwt"), "--device", "cpu",
                       "--timings", str(path)]) == 0
    err = capsys.readouterr().err
    assert "stage_graph" in err and "Mbp/s" in err
    assert torch_main(["-o", str(tmp_path / "no" / "o.bwt"), "--device",
                       "cpu", str(path)]) == 1


@pytest.mark.parametrize("fmt,counter", [("fasta", "ingest_native_bytes"),
                                         ("fastq", "ingest_numpy_bytes")])
def test_cli_timings_count_the_ingest_path(tmp_path, rng, capsys, fmt, counter):
    """--timings prints the raw bytes of the path that read the input:
    the native scan for FASTA, the NumPy parser for FASTQ."""
    reads = _reads(rng, 3)
    path = tmp_path / f"in.{fmt}"
    if fmt == "fastq":
        path.write_text("".join(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n"
                                for i, r in enumerate(reads)))
    else:
        _write_fasta(path, reads)
    assert torch_main(["-o", str(tmp_path / "o.bwt"), "--device", "cpu",
                       "--timings", str(path)]) == 0
    counts = {}
    for line in capsys.readouterr().err.splitlines():
        words = line.split()
        if len(words) == 3 and words[1].startswith("ingest_"):
            counts[words[1]] = int(words[2])
    assert counts == {counter: path.stat().st_size}


def test_cli_verify_matches_jax_cli(tmp_path, rng, capsys):
    """--verify: the same three files as the JAX CLI's --verify, the
    invertibility line with the port's prefix, exit code 0; bounded by
    --verify-steps likewise."""
    path = tmp_path / "in.fa"
    _write_fasta(path, _reads(rng, 6))
    assert jax_main(["-o", str(tmp_path / "jax.bwt"), "--verify", str(path)]) == 0
    assert "[debwt-tpu] LF invertibility: OK" in capsys.readouterr().err
    assert torch_main(["-o", str(tmp_path / "port.bwt"), "--device", "cpu",
                       "--verify", str(path)]) == 0
    assert "[debwt-torch] LF invertibility: OK" in capsys.readouterr().err
    assert _outputs(tmp_path / "port.bwt") == _outputs(tmp_path / "jax.bwt")
    assert torch_main(["-o", str(tmp_path / "port2.bwt"), "--device", "cpu",
                       "--verify", "--verify-steps", "40", str(path)]) == 0
    assert "LF invertibility: OK" in capsys.readouterr().err
    assert torch_main(["-o", str(tmp_path / "port3.bwt"), "--device", "cpu",
                       str(path)]) == 0
    assert "LF invertibility" not in capsys.readouterr().err


def test_cli_verify_exits_2_on_a_tampered_result(tmp_path, rng, capsys, monkeypatch):
    from debwt_tpu_torch import api
    from debwt_tpu_torch.pipeline import BwtResult

    path = tmp_path / "in.fa"
    _write_fasta(path, _reads(rng, 4))
    real = api.build

    def tampered(coll, config, device=None, verbose=False):
        r = real(coll, config, device=device, verbose=verbose)
        bad = r.bwt6.copy()
        bad[int(np.nonzero(bad < 4)[0][9])] ^= 1
        return BwtResult.from_bwt6(torch.from_numpy(bad), coll.n_reads)

    monkeypatch.setattr(api, "build", tampered)
    assert torch_main(["-o", str(tmp_path / "o.bwt"), "--device", "cpu",
                       "--verify", str(path)]) == 2
    assert "[debwt-torch] LF invertibility: FAILED" in capsys.readouterr().err
    # without --verify the same result goes unnoticed
    assert torch_main(["-o", str(tmp_path / "o.bwt"), "--device", "cpu",
                       str(path)]) == 0


def test_cli_default_device_needs_a_card(tmp_path, rng, monkeypatch):
    path = tmp_path / "in.fa"
    _write_fasta(path, _reads(rng, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["-o", str(tmp_path / "o.bwt"), str(path)])


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "fasta.gz"])
@pytest.mark.parametrize("policy", ["reject", "random", "to-g"])
def test_read_collection_matches_jax(tmp_path, rng, fmt, policy):
    alphabet = {"reject": "ACGT", "random": "ACGTNRYSWKM", "to-g": "ACGTN"}[policy]
    reads = _reads(rng, 5, alphabet)
    path = tmp_path / f"in.{fmt}"
    if fmt == "fastq":
        with open(path, "w") as f:
            for i, r in enumerate(reads):
                f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    elif fmt == "fasta.gz":
        with gzip.open(path, "wt") as f:
            f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    else:
        _write_fasta(path, reads, width=33)
    got = read_collection(str(path), policy, 9)
    want = jax_read_collection(str(path), policy, 9)
    np.testing.assert_array_equal(got.x2, want.x2)
    np.testing.assert_array_equal(got.sep, want.sep)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
@pytest.mark.parametrize("chunk_bytes", [1 << 26, 61])
def test_read_reads_matches_jax_read_fasta(tmp_path, rng, fmt, chunk_bytes):
    """The streaming parser's records and names equal the JAX package's
    whole-file parser's, short reads and nameless records included, also
    when a record spans several regions."""
    reads = _reads(rng, 4) + ["ACGTTGCA"]
    path = tmp_path / f"in.{fmt}"
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            name = "" if i == 2 else f"r{i} some text"
            if fmt == "fastq":
                f.write(f"@{name}\n{r}\n+\n{'I' * len(r)}\n")
            else:
                f.write(f">{name}\n" + "".join(
                    r[j : j + 33] + "\n" for j in range(0, len(r), 33)))
    codes, lengths, names = read_reads(str(path), chunk_bytes=chunk_bytes)
    want, want_names = jax_read_fasta(str(path))
    # the JAX package's own parsers disagree on what to call a nameless
    # record; the port calls it read<j>
    assert names[2] == "read2"
    assert names[:2] + names[3:] == want_names[:2] + want_names[3:]
    assert lengths.tolist() == [len(r) for r in want] and lengths[-1] == 8
    np.testing.assert_array_equal(codes, np.concatenate(want))


def test_writer_roundtrip(tmp_path, rng):
    coll = SequenceCollection.from_reads(_reads(rng, 4))
    g = golden_bwt(coll)
    write_bwt(g, str(tmp_path / "o.bwt"))
    bwt6, sharp, dollar = read_bwt(str(tmp_path / "o.bwt"), coll.bwt_len)
    np.testing.assert_array_equal(bwt6, g.bwt6)
    np.testing.assert_array_equal(sharp, g.sharp_pos)
    assert dollar == g.dollar_pos


def test_import_loads_no_jax():
    """Importing every module of the port (and chip_smoke), and a toy
    build of the out-of-core rehearsal's worker, load neither jax nor
    any module of the JAX package. Runs in a fresh interpreter, since
    this test process has both loaded."""
    code = (
        "import importlib, pkgutil, sys, tempfile\n"
        "import debwt_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    debwt_tpu_torch.__path__, 'debwt_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, torch_dist_worker, torch_ooc_worker\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    assert torch_ooc_worker.main(['0.004', d + '/sp', 'cpu',\n"
        "        '--chunk', '1024', '--buckets', '4']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'debwt_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 25, names\n"
        "new = ['grouped', 'oocore', 'bluesort', 'verify', 'count', 'model',\n"
        "       'transfer_n', 'io.native', 'parallel.mesh',\n"
        "       'parallel.collectives', 'parallel.dist', 'parallel.sprank']\n"
        "assert all('debwt_tpu_torch.' + n in names for n in new), names\n"
        "from debwt_tpu_torch import count_kmers, read_kmer_dump\n"
        "from debwt_tpu_torch import dist_build_bwt, make_mesh\n"
        "from debwt_tpu_torch.io import read_fasta\n"
        "from debwt_tpu_torch.io.native import parse_fasta\n"
        "from debwt_tpu_torch.verify import build_occ\n"
        "print(len(names))\n"
    )
    root = os.path.join(SRC, "..")
    tests = os.path.dirname(os.path.abspath(__file__))
    rc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": os.pathsep.join([SRC, root, tests]),
             "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", "/tmp")},
        cwd=root, timeout=120,
    )
    assert rc.returncode == 0, rc.stderr
