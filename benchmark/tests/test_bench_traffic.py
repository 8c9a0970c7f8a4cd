"""The traffic generator: seeded, repeatable, the same lengths for every seed,
at the corpus's stated mean and clip."""

import numpy as np
import pytest

from benchmark.harness import manifest
from benchmark.harness.traffic import (Traffic, fused_request, length_set, load_mix, note_name,
                                       phoneme_input, phones_of)
from benchmark.reference import frontend

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _cell(name):
    cell = manifest.cell(BENCH, name)
    return manifest.config(BENCH, cell["config"]), load_mix(cell["traffic"])


@pytest.mark.parametrize("config", ["ds_beta6_lj", "ds1000_cpop"])
@pytest.mark.parametrize("n", [64, 128])
def test_length_set_mean_and_clip(config, n):
    corpus = manifest.config(BENCH, config)["corpus"]
    s = length_set(corpus, n)
    assert s.mean() == pytest.approx(corpus["mean_s"], rel=1e-6)
    lo, hi = corpus["clip_s"]
    assert s.min() >= lo - 1e-12 and s.max() <= hi + 1e-12
    assert np.all(np.diff(s) >= 0)


@pytest.mark.parametrize("name", CELLS)
def test_seeded_and_repeatable(name):
    config, mix = _cell(name)
    big = 2 ** 31 + 987654321
    a, b, c = Traffic(mix, config, big), Traffic(mix, config, big), Traffic(mix, config, big + 1)
    if mix["kind"] == "batch_calls":
        got = [a.call(k) for k in range(3)]
        again = [b.call(k) for k in range(3)]
        other = [c.call(k) for k in range(3)]
        flat = [s for call in got for s in call]
        # every call holds the whole length set
        for call in got + other:
            assert sorted(s["n_phones"] for s in call) == sorted(a.n_phones.tolist())
    else:
        got, again, other = [a.phrases()], [b.phrases()], [c.phrases()]
        flat = got[0]
        assert sorted(s["n_phones"] for s in other[0]) == sorted(a.n_phones.tolist())
    for x, y in zip(got, again):
        for s, t in zip(x, y):
            assert s["n_phones"] == t["n_phones"] and np.array_equal(s["tokens"], t["tokens"])
    assert any(not np.array_equal(s["tokens"], t["tokens"]) if s["n_phones"] == t["n_phones"]
               else True for s, t in zip(got[0], other[0]))
    vocab = config["vocab_size"]
    for s in flat:
        assert s["tokens"].min() >= 3 and s["tokens"].max() < vocab
        assert s["frames"] == s["n_phones"] * config["corpus"]["frames_per_phone"]
    assert a.draw_seed(3, 0, 1) == b.draw_seed(3, 0, 1) != a.draw_seed(3, 0, 2)
    assert 0 <= a.draw_seed(3, 0, 1) < 2 ** 63


def test_phones_follow_the_corpus_rate():
    corpus = manifest.config(BENCH, "ds1000_cpop")["corpus"]
    # 36 frames of hop 128 at 24 kHz: 0.192 s a phone
    assert phones_of(corpus, np.array([0.192 * 10])).tolist() == [10]


def test_phoneme_input_round_trips_through_the_reference_frontend():
    config, mix = _cell("cpop_b1")
    spec = Traffic(mix, config, 5).phrases()[0]
    inp = phoneme_input(spec, frontend.CPOP_PHONES)
    batch = frontend.phoneme_batch(inp)
    assert np.array_equal(batch["txt_tokens"][0], spec["tokens"])
    assert np.array_equal(batch["pitch_midi"][0], spec["midi"])
    assert np.array_equal(batch["is_slur"][0], spec["is_slur"])
    assert np.allclose(batch["midi_dur"][0], 0.192)
    fused, frames = fused_request(spec)
    assert frames == spec["frames"] and np.array_equal(fused["pitch_midi"], batch["pitch_midi"])


@pytest.mark.parametrize("midi", [48, 61, 70, 76])
def test_note_names(midi):
    assert frontend.note_to_midi(note_name(midi)) == midi
