"""The plain reference and the copied generators, against the program's
golden model and its synth module (imported here, in the test only),
and the control, which has to come out not correct."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import control
from benchmark.reference import bwt
from benchmark.traffic import genomes
from debwt_tpu_torch.golden import golden_bwt
from debwt_tpu_torch.synth import synth_codes, synth_concat_codes
from debwt_tpu_torch.types import SequenceCollection

MODELS = {
    "repeats": ({"model": "repeats", "genomes": 4, "mutation_rate": 2e-3,
                 "repeat_frac": 0.1, "repeat_len": 300}, synth_codes),
    "uniform": ({"model": "uniform", "genomes": 4, "mutation_rate": 2e-3},
                synth_concat_codes),
}
SEEDS = [0, 7, 2**31 + 3]


def _config(name: str) -> dict:
    import json

    from benchmark.harness import ROOT

    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())["collection"]


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mbp", [0.04, 0.3])
def test_generators_are_the_programs(model, seed, mbp):
    col, synth = MODELS[model]
    # the program's fragment: a 50th of a genome
    col = dict(col, mbp=mbp, repeat_len=int(mbp * 1e6) // 4 // 50)
    codes, lengths = genomes.make_codes(col, seed)
    want_codes, want_lengths = synth(mbp, seed)
    assert np.array_equal(codes, want_codes)
    assert np.array_equal(lengths, want_lengths)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_the_repeat_is_copied_whole(seed):
    """dmel_140's model: one genome, a fifth or so of it exact copies of
    one repeat_len-base element."""
    col = dict(_config("dmel_140"), mbp=4.0)
    codes, lengths = genomes.make_codes(col, seed)
    assert lengths.tolist() == [4_000_000]
    parts = genomes._pieces(np.random.default_rng(seed), 4_000_000,
                            col["repeat_len"], col["repeat_frac"])
    frag = max(parts, key=lambda p: sum(q is p for q in parts))
    starts = np.cumsum([0] + [len(p) for p in parts])
    at = [int(a) for a, p in zip(starts, parts) if p is frag and a + len(p) <= 4e6]
    assert 0.15 < len(at) * col["repeat_len"] / 4e6 < 0.3
    for a in at:
        assert np.array_equal(codes[a:a + len(frag)], frag)


@pytest.mark.parametrize("model", sorted(MODELS) + ["dmel_140"])
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_is_the_golden_bwt(model, seed):
    col = _config(model) if model == "dmel_140" else MODELS[model][0]
    codes, lengths = genomes.make_codes(dict(col, mbp=0.06), seed)
    q, shift = genomes.substitution(seed, 3, codes.shape[0])
    codes[q] = (codes[q] + shift) % 4
    coll = SequenceCollection.from_concat(codes, lengths)
    x = bwt.text6(codes, lengths, "cpu")
    assert np.array_equal(x.numpy(), coll.x6)
    g = golden_bwt(coll)
    packed, sharp, dollar = bwt.reference_answer(x)
    assert packed.numpy().tobytes() == g.packed()
    assert np.array_equal(sharp, g.sharp_pos)
    assert dollar.tolist() == [g.dollar_pos]
    got = bwt.compare(bwt.Answer(g.packed(), g.sharp_pos, g.dollar_pos),
                      (packed, sharp, dollar))
    assert got == {"obj_bytes_off": 0, "sharp_off": 0, "dollar_off": 0}


def test_substitution_lands_on_a_base():
    lengths = np.array([40, 50, 60], dtype=np.int64)
    x_sep = set((np.cumsum(lengths + 1) - 1).tolist())
    for q in range(int(lengths.sum())):
        assert genomes.text_index(lengths, q) not in x_sep
    assert genomes.text_index(lengths, 40) == 41


@pytest.mark.parametrize("col", [_config("dmel_140"),
                                 dict(MODELS["uniform"][0], mbp=1.0)],
                         ids=["dmel_140", "uniform"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_is_not_correct(col, seed):
    """Suffixes sorted on 32 characters only: the comparison fails."""
    from benchmark.harness import LIMITS

    r = control.readings(dict(col, mbp=0.2), seed, __import__("torch").device("cpu"))
    assert r["obj_bytes_off"] > LIMITS["obj_bytes_off"]
