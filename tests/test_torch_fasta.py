"""The port's read_fasta (the native parser and the NumPy one) against
the JAX package's read_fasta, on the CPU. All data is integer: every
comparison is exact."""

import gzip

import numpy as np
import pytest

from debwt_tpu.io import native as jax_native
from debwt_tpu.io import read_fasta as jax_read_fasta
from debwt_tpu.io.fasta import NPolicy as JaxPolicy
from debwt_tpu.io.fasta import _parse_fasta_numpy as jax_parse_numpy
from debwt_tpu_torch.io import native, read_fasta
from debwt_tpu_torch.io.fasta import NPolicy, _parse_fasta_numpy
from debwt_tpu_torch.kernels import _build

ALPHABET = {"reject": "ACGTacgt", "to-g": "ACGTNn", "random": "ACGTNRYSWKMBDHVn"}


def _text(rng, fmt, policy, crlf):
    """Six named records of the policy's alphabet: FASTA in lines of 33
    with empty lines between records and no final newline, or FASTQ."""
    reads = ["".join(rng.choice(list(ALPHABET[policy]),
                                size=int(rng.integers(1, 150))))
             for _ in range(6)]
    if fmt == "fastq":
        text = "".join(f"@q{i} x\n{r}\n+\n{'I' * len(r)}\n"
                       for i, r in enumerate(reads))
    else:
        text = "\n".join(f">r{i} some>text\n" + "".join(
            r[j : j + 33] + "\n" for j in range(0, len(r), 33))
            for i, r in enumerate(reads)).rstrip("\n")
    return text.replace("\n", "\r\n") if crlf else text


def _write(path, text):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(text.encode())


def _same(got, want):
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert got[1] == want[1]


@pytest.mark.parametrize("crlf", [False, True])
@pytest.mark.parametrize("fmt", ["fa", "fq", "fa.gz"])
@pytest.mark.parametrize("policy", ["reject", "to-g", "random"])
def test_read_fasta_matches_jax(tmp_path, fmt, policy, crlf):
    """Codes and names equal the JAX read_fasta's on FASTA (native path
    for reject and to-g, NumPy for random), FASTQ and gzip, with CRLF
    line ends, empty lines and a '>' inside a header."""
    rng = np.random.default_rng(len(fmt) * 7 + len(policy) + crlf)
    path = tmp_path / f"in.{fmt}"
    _write(path, _text(rng, "fastq" if fmt == "fq" else "fasta", policy, crlf))
    _same(read_fasta(str(path), policy, 5), jax_read_fasta(str(path), policy, 5))


@pytest.mark.parametrize("policy", ["reject", "to-g", "random"])
def test_a_gt_inside_a_sequence_raises_like_jax(tmp_path, policy):
    """A '>' that does not start a line is a sequence character, which
    no policy accepts; it also enters the parser's record bound."""
    path = tmp_path / "in.fa"
    _write(path, ">r0\nACGT>AC\n>r1\nGG\n")
    with pytest.raises(ValueError):
        jax_read_fasta(str(path), policy, 1)
    with pytest.raises(ValueError):
        read_fasta(str(path), policy, 1)


@pytest.mark.parametrize("policy", ["reject", "to-g"])
@pytest.mark.parametrize("text", [
    ">a\nACGT\n>\nGGTA\n>\nTT\n",
    ">a x\r\nAC\r\n\r\ngT\r\n> \t\r\nNN\n>>b\n>c\nA",
    ">only\n",
    ">x>y\n\n\nACGTTGCA\n>\n",
])
def test_native_parse_matches_numpy_parse(policy, text):
    raw = text.encode()
    if "N" in text and policy == "reject":
        with pytest.raises(ValueError, match="non-ACGT character 'N'"):
            native.parse_fasta(raw, policy, 0)
        with pytest.raises(ValueError, match="non-ACGT character 'N'"):
            _parse_fasta_numpy(raw, NPolicy(policy), 0)
        return
    _same(native.parse_fasta(raw, policy, 0),
          _parse_fasta_numpy(raw, NPolicy(policy), 0))


def test_native_parse_of_other_iupac_codes_raises():
    with pytest.raises(ValueError, match="non-ACGT character 'R'"):
        native.parse_fasta(b">a\nACNRT\n", "to-g", 0)
    with pytest.raises(ValueError, match="IUPAC code 'R'"):
        _parse_fasta_numpy(b">a\nACNRT\n", NPolicy.TO_G, 0)


def test_unnamed_records_are_numbered_by_record(tmp_path):
    """JAX's native path numbers a nameless record by its line, its
    NumPy path by its record; the port by its record on every path."""
    text = ">a\nACGT\n>\nGGTA\n>\nTT\n"
    path = tmp_path / "in.fa"
    _write(path, text)
    assert jax_native.available()        # JAX read_fasta takes its native path
    jax_reads, jax_names = jax_read_fasta(str(path))
    assert jax_names == ["a", "read2", "read4"]
    assert jax_parse_numpy(text.encode(), JaxPolicy.REJECT, 0)[1] == [
        "a", "read1", "read2"]
    reads, names = read_fasta(str(path))
    assert names == ["a", "read1", "read2"]
    assert names[:1] == jax_names[:1] and names[1] != jax_names[1]
    _same((reads, names), (jax_reads, names))


def test_a_header_of_blanks_names_the_record(tmp_path):
    """'> ' raises IndexError on both JAX paths; the port names it."""
    text = ">a\nACGT\n> \nGG\n"
    path = tmp_path / "in.fa"
    _write(path, text)
    with pytest.raises(IndexError):
        jax_read_fasta(str(path))
    with pytest.raises(IndexError):
        jax_parse_numpy(text.encode(), JaxPolicy.REJECT, 0)
    reads, names = read_fasta(str(path))
    assert names == ["a", "read1"]
    assert [r.tolist() for r in reads] == [[0, 1, 2, 3], [2, 2]]
    assert _parse_fasta_numpy(text.encode(), NPolicy.REJECT, 0)[1] == names


def test_read_fasta_rejects_what_jax_rejects(tmp_path):
    for body, match in ((b"", "empty input"), (b"ACGT\n", "not FASTA/FASTQ")):
        path = tmp_path / "bad.fa"
        path.write_bytes(body)
        with pytest.raises(ValueError, match=match):
            jax_read_fasta(str(path))
        with pytest.raises(ValueError, match=match):
            read_fasta(str(path))
    with pytest.raises(ValueError, match="start with '>'"):
        native.parse_fasta(b"@q\nAC\n+\nII\n", "reject", 0)


def test_parser_that_fails_to_build_raises(monkeypatch, tmp_path):
    """No quiet turn to the NumPy parser: a failed build is an error."""
    path = tmp_path / "in.fa"
    _write(path, ">a\nACGT\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "CXX_FLAGS", ("-std=c++17", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="build failed for fasta_parser"):
        read_fasta(str(path))
