"""The out-of-core tier killed and resumed across processes, on the CPU:
tests/torch_ooc_worker.py (the child chip_smoke.py runs at 1 Gbp on the
card) at a toy size of the same synth_concat collection, SIGKILLed in
pass B and resumed by a fresh process, against golden and the JAX
package's build_bwt_ooc computed here; and the launcher's watch(),
which kills a child from outside. All comparisons are exact."""

import hashlib
import json
import os
import signal

import numpy as np
import pytest

from debwt_tpu import oocore as joocore
from debwt_tpu.types import PipelineConfig as JaxConfig
from debwt_tpu.types import SequenceCollection as JaxCollection
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.synth import synth_concat_collection

from torch_ooc_worker import Child, save_collection, watch

MBP = 0.004                  # synth_concat: N = 4004, 4 reads
CHUNK, BUCKETS = 1024, 16    # 4 chunks; tools/bench_ooc.py's knobs scaled
KNOBS = ("--chunk", str(CHUNK), "--buckets", str(BUCKETS))
TIMEOUT = 120


def _hashes(r):
    return (hashlib.sha256(r.packed()).hexdigest(),
            hashlib.sha256(r.sharp_pos.astype(np.int64).tobytes()).hexdigest(),
            int(r.dollar_pos))


@pytest.fixture(scope="module")
def want():
    """(collection, golden's hashes), with the JAX tier's equal to them."""
    coll = synth_concat_collection(MBP)
    gold = _hashes(golden_bwt(coll))
    jax = joocore.build_bwt_ooc(
        JaxCollection(x2=coll.x2, sep=coll.sep), JaxConfig(m=32),
        joocore.OocConfig(chunk=CHUNK, n_buckets=BUCKETS))
    assert _hashes(jax) == gold
    return coll, gold


def _result(child) -> dict:
    assert child.proc.wait(timeout=TIMEOUT) == 0, child.tail()
    return child.lines()


def _got(res: dict) -> tuple:
    return res["obj_sha"], res["sharp_sha"], res["dollar"]


def _manifest(spill) -> dict:
    return json.loads((spill / "manifest.json").read_text())


@pytest.mark.parametrize("kill_at", [1, 4, BUCKETS])
def test_sigkill_in_pass_b_then_resume_in_a_fresh_process(tmp_path, want, kill_at):
    """The child SIGKILLs itself at its kill_at-th classification (the
    first, a middle one, the last); a second child resumes from the
    manifest without pass A, classifies only the buckets left and
    builds golden's and the JAX tier's bytes, leaving nothing behind."""
    coll, gold = want
    save_collection(coll, tmp_path / "coll")
    spill = tmp_path / "spill"
    first = Child(tmp_path / "c1.log", tmp_path / "coll", spill, "cpu", *KNOBS,
                  "--kill-at", str(kill_at))
    assert first.proc.wait(timeout=TIMEOUT) == -signal.SIGKILL, first.tail()
    l1 = first.lines()
    assert "RESULT" not in l1
    assert l1["PASS_B"]["calls"] == {"_chunk_keys": 4, "_row_keys": 1,
                                     "_classify_bucket": 1}
    st = _manifest(spill)
    done = kill_at - 1     # no bucket is empty at this size
    assert st["stage"] == ("A" if done == 0 else "B")
    assert st.get("next_bucket", 0) == done
    res = _result(Child(tmp_path / "c2.log", tmp_path / "coll", spill, "cpu",
                        *KNOBS))
    out = res["RESULT"]
    assert res["START"]["x2_sha"] == l1["START"]["x2_sha"]
    assert res["START"]["n"] == coll.bwt_len
    assert out["calls"] == {"_chunk_keys": 0, "_row_keys": BUCKETS - done,
                            "_classify_bucket": BUCKETS - done}
    assert out["stats"]["classifications"] == BUCKETS - done
    assert "pass A (resume attach)" in out["stats"]["stage_s"]
    assert (out["stats"]["n_chunks"], out["stats"]["n_buckets"]) == (4, BUCKETS)
    assert _got(out) == gold
    assert os.listdir(spill) == []
    assert out["rss_peak_bytes"] > 0 and l1["PASS_B"]["rss_peak_bytes"] > 0


def test_watch_kills_in_pass_b_then_waits_for_the_resume(tmp_path, want):
    """chip_smoke.py's helper against a child slowed by a sleep in each
    classification: it kills the child from outside once the manifest
    reaches the bucket, never earlier, and samples the spill; a second
    child, watched without a kill, resumes to golden's bytes."""
    _coll, gold = want
    spill = tmp_path / "spill"
    at = BUCKETS // 2
    first = Child(tmp_path / "c1.log", MBP, spill, "cpu", *KNOBS,
                  "--sleep", "0.2")
    w1 = watch(first.proc, spill, kill_at=at, interval=0.02, timeout=TIMEOUT)
    assert w1["returncode"] == -signal.SIGKILL and "RESULT" not in first.lines()
    st = _manifest(spill)
    assert st["stage"] == "B" and at <= w1["killed_at"] <= st["next_bucket"] < BUCKETS
    # 6 bytes a bucket row: 4 of offset, 2 of metadata
    assert w1["spill_peak"] > 0 and w1["spill_peak_apparent"] >= 6 * 3000
    assert w1["rss_peak"] > 0
    second = Child(tmp_path / "c2.log", MBP, spill, "cpu", *KNOBS)
    w2 = watch(second.proc, spill, interval=0.02, timeout=TIMEOUT)
    assert (w2["returncode"], w2["killed_at"]) == (0, None), second.tail()
    out = second.lines()["RESULT"]
    assert out["calls"]["_chunk_keys"] == 0
    assert out["calls"]["_classify_bucket"] == BUCKETS - st["next_bucket"]
    assert _got(out) == gold
    assert os.listdir(spill) == []
    assert out["rss_peak_bytes"] > 0


def test_watch_kills_a_child_past_its_timeout(tmp_path):
    """A child that outlives the timeout is killed, and watch raises."""
    spill = tmp_path / "spill"
    child = Child(tmp_path / "c.log", MBP, spill, "cpu", *KNOBS, "--sleep", "30")
    with pytest.raises(TimeoutError, match="outlived"):
        watch(child.proc, spill, interval=0.05, timeout=1.0)
    assert child.proc.poll() == -signal.SIGKILL


def test_whole_build_prints_its_fields(tmp_path, want):
    """Without --kill-at the child builds the whole text from its seed
    (no saved text) and reports bwt_len, the spill peak, the bytes it
    wrote and, with --verify-steps, an LF walk over the whole text:
    golden's hashes, every kernel's launch count (0 on the CPU) and one
    gathered key call a classification."""
    coll, gold = want
    spill = tmp_path / "spill"
    child = Child(tmp_path / "c.log", MBP, spill, "cpu", *KNOBS,
                  "--verify-steps", str(coll.bwt_len + 5))
    res = _result(child)
    out = res["RESULT"]
    assert res["START"]["x2_sha"] is None and res["START"]["n"] == coll.bwt_len
    assert out["bwt_len"] == coll.bwt_len and _got(out) == gold
    assert out["n_sharp"] == coll.n_reads - 1
    assert out["lf_verify"]["ok"] is True
    assert out["lf_verify"]["steps"] == coll.bwt_len
    assert out["lf_verify"]["seconds"] >= 0
    assert out["launches"] == {"window_keys": 0, "window_keys_at": 0,
                               "seg_scan_or": 0}
    assert out["calls"] == {"_chunk_keys": 4, "_row_keys": BUCKETS,
                            "_classify_bucket": BUCKETS}
    assert out["stats"]["classifications"] == BUCKETS
    assert out["stats"]["oversized_buckets"] == 0
    # at least the rows' 6 bytes a position reached the disk
    assert out["spill_peak_bytes"] >= 6 * 3000
    assert res["PASS_B"]["spill_bytes"] >= 6 * 3000
    if out["io_bytes"]:
        assert out["io_bytes"]["wchar"] >= out["io_bytes_build"]["wchar"] >= 6 * 3000
    assert os.listdir(spill) == []
