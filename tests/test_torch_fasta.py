"""The port's read_fasta (the native parser and the NumPy one) against
the JAX package's read_fasta, and its read_collection (the native scan)
against its own NumPy path, on the CPU. All data is integer: every
comparison is exact."""

import gzip

import numpy as np
import pytest

from debwt_tpu.io import native as jax_native
from debwt_tpu.io import read_fasta as jax_read_fasta
from debwt_tpu.io.fasta import NPolicy as JaxPolicy
from debwt_tpu.io.fasta import _parse_fasta_numpy as jax_parse_numpy
from debwt_tpu_torch.io import native, read_collection, read_fasta
from debwt_tpu_torch.io.fasta import (
    NPolicy, _parse_fasta_numpy, _read_collection_numpy,
)
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


# ---- read_collection: the native scan against the plain NumPy version ----

IUPAC_RUN = {"reject": "", "to-g": "Nn", "random": "NRYSWKMBDHVnrk"}


def _collection_text(rng, policy, *, n_records=6, lo=40, hi=400,
                     width=60, crlf=False, stray_cr=False, lower=False,
                     blank=False, names="named", run=0, final_newline=True):
    """FASTA of n_records reads over the policy's alphabet (ACGT, and
    N/IUPAC where the policy takes them), each longer than 32, in lines
    of `width`; options for the layouts a reader must take the same
    way on both paths."""
    reads = []
    for _ in range(n_records):
        r = "".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))
        if run and IUPAC_RUN[policy]:
            at = int(rng.integers(0, len(r)))
            r = r[:at] + "".join(rng.choice(list(IUPAC_RUN[policy]), size=run)) + r[at:]
        if stray_cr:
            at = int(rng.integers(0, len(r)))
            r = r[:at] + "\r" + r[at:]
        reads.append(r.lower() if lower and rng.integers(0, 2) else r)
    heads = {"named": lambda i: f">r{i} a description",
             "nameless": lambda i: ">" if i % 2 else f">r{i}",
             "blank": lambda i: "> \t" if i % 2 else f">r{i}"}[names]
    parts = []
    for i, r in enumerate(reads):
        parts.append(heads(i) + "\n" + "".join(
            r[j : j + width] + "\n" for j in range(0, len(r), width)))
        if blank:
            parts.append("\n")
    text = "".join(parts)
    if not final_newline:
        text = text.rstrip("\n")
    return text.replace("\n", "\r\n") if crlf else text


COLLECTION_CASES = {
    "crlf_lower_blank": dict(crlf=True, stray_cr=True, lower=True, blank=True),
    "nameless_headers": dict(names="nameless"),
    "blank_headers": dict(names="blank", blank=True),
    "many_records_no_final_newline": dict(n_records=300, lo=33, hi=90,
                                          final_newline=False),
    "records_and_runs_across_regions": dict(n_records=5, lo=1500, hi=6000,
                                            width=80, run=700),
    "gz": dict(n_records=8, lo=300, hi=3000, run=300, crlf=True),
}


def _ingest(read, path, policy, seed, chunk_bytes):
    """(collection, counters) of one read."""
    from debwt_tpu_torch import tracing

    with tracing.recording() as rec:
        coll = read(str(path), policy, seed, chunk_bytes)
    return coll, rec.counters


@pytest.mark.parametrize("chunk_bytes", [1 << 10, 1 << 14])
@pytest.mark.parametrize("policy,seed", [
    ("reject", 0), ("to-g", 0), ("random", 3), ("random", 2**31 + 5)])
@pytest.mark.parametrize("case", sorted(COLLECTION_CASES))
def test_read_collection_matches_the_numpy_path(tmp_path, case, policy, seed,
                                                chunk_bytes):
    """The native scan's x2 and sep are the NumPy path's (_stream_reads,
    then from_concat) byte for byte, random draws included, when records,
    lines and IUPAC runs straddle the regions; the counters say which
    path read the bytes."""
    rng = np.random.default_rng(sorted(COLLECTION_CASES).index(case))
    text = _collection_text(rng, policy, **COLLECTION_CASES[case])
    path = tmp_path / ("in.fa.gz" if case == "gz" else "in.fa")
    _write(path, text)
    got, counted = _ingest(read_collection, path, policy, seed, chunk_bytes)
    want, plain_counted = _ingest(_read_collection_numpy, path, policy, seed,
                                  chunk_bytes)
    assert got.x2.dtype == np.uint8 and got.sep.dtype == np.int64
    np.testing.assert_array_equal(got.x2, want.x2)
    np.testing.assert_array_equal(got.sep, want.sep)
    assert got.x2.max() <= 3 and got.sep[-1] == got.x2.shape[0] - 1
    assert counted == {"ingest_native_bytes": len(text.encode())}
    assert plain_counted == {"ingest_numpy_bytes": len(text.encode())}


ERROR_CASES = [
    ("reject", b">a\n" + b"A" * 40 + b"N\n"),
    ("reject", b">a\n" + b"A" * 40 + b"\n>b\nACGT>AC" + b"G" * 40 + b"\n"),
    ("reject", b">a\n" + b"C" * 40 + b"\r\n>b\n" + b"G" * 40 + b" \n"),
    ("to-g", b">a\n" + b"ACNn" * 10 + b"R\n"),
    ("random", b">a\n" + b"ACNR" * 10 + b"X\n"),
    ("random", b">a\n" + b"ACNR" * 10 + b"\n>b\n" + b"T" * 9 + b">\n"),
    ("reject", b">a\n" + b"A" * 40 + b"\n>b\n" + b"A" * 32 + b"\n"),
    ("to-g", b">a\n" + b"A" * 40 + b"\n>b\n"),
    ("random", b">\n\n>b\n" + b"A" * 40),
    # a short read early, a bad byte in a later region: the bad byte
    ("reject", b">a\nAC\n>b\n" + b"A" * 3000 + b"\n>c\n" + b"A" * 40 + b"x\n"),
    ("reject", b""),
    ("reject", b"ACGT\n>a\n"),
    ("random", b"\n>a\nACGT\n"),
]


@pytest.mark.parametrize("case", range(len(ERROR_CASES)))
def test_read_collection_errors_match_the_numpy_path(tmp_path, case):
    """Each input either path refuses: the same exception, message and
    all (a non-ACGT byte, a '>' inside a line, an IUPAC code to-g does
    not cover, an unrecognized byte under random, a read of 32 bases or
    fewer, an empty input, neither FASTA nor FASTQ)."""
    policy, raw = ERROR_CASES[case]
    path = tmp_path / "bad.fa"
    path.write_bytes(raw)
    with pytest.raises(ValueError) as plain:
        _read_collection_numpy(str(path), NPolicy(policy), 7, 1 << 10)
    with pytest.raises(ValueError) as native_err:
        read_collection(str(path), policy, 7, 1 << 10)
    assert type(native_err.value) is type(plain.value)
    assert str(native_err.value) == str(plain.value)


@pytest.mark.parametrize("suffix", [".fa", ".fa.gz"])
def test_read_collection_grows_x2_and_sep(tmp_path, suffix):
    """More records than sep's first 1,024 slots, and in gzip a text
    far past x2's first guess (four times the compressed size): both
    grow, and the collection is still the NumPy path's."""
    text = "".join(f">r{i}\n" + "ACGT" * (10 + i % 7) + "\n" for i in range(3000))
    path = tmp_path / f"in{suffix}"
    _write(path, text)
    if suffix == ".fa.gz":
        assert 4 * path.stat().st_size < len(text)
    got = read_collection(str(path), "reject", 0, 1 << 12)
    want = _read_collection_numpy(str(path), NPolicy.REJECT, 0, 1 << 12)
    assert got.n_reads == 3000
    np.testing.assert_array_equal(got.x2, want.x2)
    np.testing.assert_array_equal(got.sep, want.sep)
