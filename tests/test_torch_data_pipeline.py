"""The port's data pipeline against the JAX package's on the same inputs.

The numpy modules (misc, pitch extraction, TextGrid alignment, loudness and
silence trimming, the F0 codecs) are copies and must agree exactly; the mel
is numpy float64 FFTs against XLA's float32 ones: within 1e-4 on the log10
mel, the returned waveform equal. The binarizers run under ``N_PROC=1`` (the
JAX package's tests do the same: a worker pool would fork a process that
holds JAX) and must give the same splits, items and arrays (the mel within
1e-4, the rest exactly) and the same side files. The indexed-dataset format
is shared: either builder's files are read by either reader."""

import json
import os

import numpy as np
import pytest

from diffsinger_tpu.data import audio_norm as jan
from diffsinger_tpu.data import binarize as jbin
from diffsinger_tpu.data import indexed_dataset as jidx
from diffsinger_tpu.data import pitch_extract as jpe
from diffsinger_tpu.data import textgrid as jtg
from diffsinger_tpu.ops import mel as jmel
from diffsinger_tpu.utils import misc as jmisc
from diffsinger_tpu.utils import pitch as jpitch
from diffsinger_tpu.utils import text_encoder as jtext
from diffsinger_tpu_torch.config.hparams import load_config
from diffsinger_tpu_torch.data import audio_norm as tan
from diffsinger_tpu_torch.data import binarize as tbin
from diffsinger_tpu_torch.data import indexed_dataset as tidx
from diffsinger_tpu_torch.data import pitch_extract as tpe
from diffsinger_tpu_torch.data import textgrid as ttg
from diffsinger_tpu_torch.ops import mel as tmel
from diffsinger_tpu_torch.tools.fixtures import write_lj_corpus
from diffsinger_tpu_torch.utils import misc as tmisc
from diffsinger_tpu_torch.utils import pitch as tpitch
from diffsinger_tpu_torch.utils import text_encoder as ttext
from tests.test_data_pipeline import _make_opencpop_raw

SR = 22050


def _voice(seconds=1.5, sr=SR, seed=0):
    """Harmonic tone with vibrato, a silent gap and a noise floor."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 180 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t))
    ph = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.5 ** k * np.sin((k + 1) * ph) for k in range(4)) * 0.2
    wav[int(0.6 * sr): int(0.8 * sr)] = 0.0
    return (wav + rng.randn(len(t)) * 0.003).astype(np.float32)


def _equal(a, b, what=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


# ------------------------------------------------------------------ numpy copies
def test_misc_collate_batching_and_meters():
    rng = np.random.RandomState(0)
    seqs = [rng.randn(n).astype(np.float32) for n in (3, 7, 5)]
    mats = [rng.randn(n, 4).astype(np.float32) for n in (3, 7, 5)]
    for kw in ({}, {"max_len": 9}, {"shift_right": True}):
        _equal(tmisc.collate_1d(seqs, 0.5, **kw), jmisc.collate_1d(seqs, 0.5, **kw), str(kw))
    _equal(tmisc.collate_2d(mats, -1.0, 8), jmisc.collate_2d(mats, -1.0, 8))
    sizes = rng.randint(5, 300, size=40)
    idx = np.argsort(sizes, kind="mergesort")
    for kw in ({"max_tokens": 1200, "max_sentences": 6},
               {"max_tokens": 900, "required_batch_size_multiple": 4}):
        assert tmisc.batch_by_size(idx, lambda i: int(sizes[i]), **kw) == \
            jmisc.batch_by_size(idx, lambda i: int(sizes[i]), **kw)
    tm, jm = tmisc.MetricsDict(), jmisc.MetricsDict()
    for vals, n in (({"a": 1.0, "b": float("nan")}, 2), ({"a": 4.0, "b": 2.0}, 3)):
        tm.update(vals, n)
        jm.update(vals, n)
    assert tm.averages() == jm.averages()


def test_misc_wav_io_round_trip(tmp_path):
    wav = _voice(0.3)
    tmisc.save_wav(wav, str(tmp_path / "a.wav"), SR, norm=True)
    jmisc.save_wav(wav, str(tmp_path / "b.wav"), SR, norm=True)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    for sr in (SR, 16000):
        _equal(tmisc.load_wav(str(tmp_path / "a.wav"), sr),
               jmisc.load_wav(str(tmp_path / "a.wav"), sr), f"load at {sr}")


def test_f0_codecs():
    f0 = np.abs(np.random.RandomState(1).randn(50) * 150 + 200).astype(np.float32)
    f0[[3, 4, 20, 49]] = 0.0
    _equal(tpitch.f0_to_coarse_np(f0.copy()), jpitch.f0_to_coarse_np(f0.copy()))
    for kw in ({}, {"pitch_norm": "standard", "f0_mean": 200.0, "f0_std": 50.0},
               {"use_uv": False}):
        for a, b in zip(tpitch.norm_interp_f0_np(f0, **kw), jpitch.norm_interp_f0_np(f0, **kw)):
            _equal(a, b, str(kw))


@pytest.mark.parametrize("hop", [128, 256])
def test_pitch_extraction(hop):
    wav = _voice()
    _equal(tpe.extract_f0_ac(wav, SR, hop), jpe.extract_f0_ac(wav, SR, hop))
    mel = np.zeros((len(wav) // hop + 1, 80), np.float32)
    hp = {"hop_size": hop, "audio_sample_rate": SR}
    for a, b in zip(tpe.get_pitch(wav, mel, hp), jpe.get_pitch(wav, mel, hp)):
        _equal(a, b)


TEXTGRID = """File type = "ooTextFile"
Object class = "TextGrid"
xmin = 0
xmax = 1.0
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        intervals [1]:
            xmin = 0
            xmax = 1.0
            text = "hello"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        intervals [1]:
            xmin = 0
            xmax = 0.1
            text = "sil"
        intervals [2]:
            xmin = 0.1
            xmax = 0.3
            text = "HH"
        intervals [3]:
            xmin = 0.3
            xmax = 0.5
            text = "AH0"
        intervals [4]:
            xmin = 0.5
            xmax = 0.55
            text = "sp"
        intervals [5]:
            xmin = 0.55
            xmax = 0.8
            text = "L"
        intervals [6]:
            xmin = 0.8
            xmax = 1.0
            text = ""
"""


def test_textgrid_alignment():
    _equal(ttg.parse_textgrid(TEXTGRID), jtg.parse_textgrid(TEXTGRID))
    for ph in ("| HH AH0 | L |", "| HH | AH0 | L |"):
        for a, b in zip(ttg.mel2ph_from_textgrid(TEXTGRID, ph, 90, SR, 256),
                        jtg.mel2ph_from_textgrid(TEXTGRID, ph, 90, SR, 256)):
            _equal(a, b, ph)
    for mod in (ttg, jtg):  # a pause the phones do not have
        with pytest.raises(AssertionError):
            mod.mel2ph_from_textgrid(TEXTGRID, "| HH AH0 L |", 90, SR, 256)
    _equal(ttg.mel2ph_from_durs([0.1, 0.33, 0.2, 0.05], 70, 24000, 128),
           jtg.mel2ph_from_durs([0.1, 0.33, 0.2, 0.05], 70, 24000, 128))
    assert [ttg.is_sil_phoneme(p) for p in ("", "|", "SP", "a")] == \
        [jtg.is_sil_phoneme(p) for p in ("", "|", "SP", "a")]


def test_loudness_and_silence_trimming():
    wav = np.concatenate([_voice(1.0), np.zeros(SR // 2, np.float32), _voice(0.8, seed=1)])
    assert tan.integrated_loudness(wav, SR) == jan.integrated_loudness(wav, SR)
    _equal(tan.normalize_loudness(wav, SR), jan.normalize_loudness(wav, SR))
    for kw in ({}, {"return_raw_wav": True}, {"norm": False, "vad_max_silence_length": 4}):
        for a, b in zip(tan.trim_long_silences(wav, SR, **kw),
                        jan.trim_long_silences(wav, SR, **kw)):
            _equal(a, b, str(kw))
    hp = {"trim_long_sil": True, "loud_norm": True}
    _equal(tbin.condition_wav(wav, hp, SR), jbin.condition_wav(wav, hp, SR))


def test_phone_encoder(tmp_path):
    with open(tmp_path / "phone_set.json", "w") as f:
        json.dump(["AA", "B", "|", ",", "SP"], f)
    t, j = ttext.build_phone_encoder(str(tmp_path)), jtext.build_phone_encoder(str(tmp_path))
    assert len(t) == len(j) and t.sil_phonemes() == j.sil_phonemes()
    assert t.encode("AA | B XX SP") == j.encode("AA | B XX SP")


# ------------------------------------------------------------------ mel
@pytest.mark.parametrize("cfg", [dict(), dict(sample_rate=24000, n_fft=512, hop_size=128,
                                               win_length=384, fmin=30, fmax=12000)])
def test_wav2spec_matches_jax(cfg):
    wav = _voice(1.3, sr=cfg.get("sample_rate", SR))[:-37]  # not a multiple of the hop
    w_t, m_t = tmel.wav2spec(wav, tmel.MelConfig(**cfg))
    w_j, m_j = jmel.wav2spec(wav, jmel.MelConfig(**cfg))
    _equal(w_t, np.asarray(w_j))
    assert m_t.shape == m_j.shape and m_t.dtype == np.float32
    np.testing.assert_allclose(m_t, np.asarray(m_j), rtol=0, atol=1e-4)
    _equal(tmel.mel_filterbank(22050, 1024, 80, 80, 7600),
           jmel.mel_filterbank(22050, 1024, 80, 80, 7600))


# ------------------------------------------------------------------ indexed datasets
@pytest.mark.parametrize("writer,reader", [(tidx, jidx), (jidx, tidx), (tidx, tidx)])
def test_indexed_dataset_is_shared(tmp_path, writer, reader):
    rng = np.random.RandomState(0)
    items = [{"item_name": f"x{i}", "mel": rng.randn(i + 3, 4).astype(np.float32),
              "phone": [1, 2, i], "sec": 0.5 * i} for i in range(5)]
    b = writer.IndexedDatasetBuilder(str(tmp_path / "d" / "train"))
    for it in items:
        b.add_item(it)
    b.finalize()
    ds = reader.IndexedDataset(str(tmp_path / "d" / "train"))
    assert len(ds) == len(items)
    for i, it in enumerate(items):
        got = ds[i]
        assert got.keys() == it.keys()
        for k in it:
            _equal(got[k], it[k], k)
    with pytest.raises(IndexError):
        ds[len(items)]
    ds.close()


# ------------------------------------------------------------------ binarizers
def _compare_binary_dirs(dir_t, dir_j):
    assert sorted(os.listdir(dir_t)) == sorted(os.listdir(dir_j))
    for fn in os.listdir(dir_t):
        if fn.endswith(".json") or fn.endswith(".npy") and "lengths" in fn:
            assert open(os.path.join(dir_t, fn), "rb").read() == \
                open(os.path.join(dir_j, fn), "rb").read(), fn
        elif fn.endswith("mean_std.npy"):
            _equal(np.load(os.path.join(dir_t, fn)), np.load(os.path.join(dir_j, fn)), fn)
    n_items = 0
    for split in ("train", "valid", "test"):
        a = tidx.IndexedDataset(os.path.join(dir_t, split))
        b = jidx.IndexedDataset(os.path.join(dir_j, split))
        assert len(a) == len(b) > 0, split
        for i in range(len(a)):
            x, y = a[i], b[i]
            assert x.keys() == y.keys(), (split, i)
            for k in x:
                if k == "mel":
                    np.testing.assert_allclose(x[k], y[k], rtol=0, atol=1e-4)
                else:
                    _equal(x[k], y[k], f"{split}[{i}].{k}")
            n_items += 1
        a.close()
        b.close()
    return n_items


def test_lj_binarizer_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("N_PROC", "1")
    write_lj_corpus(str(tmp_path / "raw"), str(tmp_path / "proc"), 6, seed=1)
    hp = dict(load_config("configs/lj/ds_beta6.yaml"), raw_data_dir=str(tmp_path / "raw"),
              processed_data_dir=str(tmp_path / "proc"), test_num=1, valid_num=1)
    for mod, name in ((tbin, "bt"), (jbin, "bj")):
        os.makedirs(tmp_path / name)
        mod.binarize(dict(hp, binary_data_dir=str(tmp_path / name)))
    n = _compare_binary_dirs(str(tmp_path / "bt"), str(tmp_path / "bj"))
    assert n == 4 + 2 + 1
    item = tidx.IndexedDataset(str(tmp_path / "bt" / "train"))[0]
    assert {"cwt_spec", "mel2ph", "f0", "pitch", "phone"} <= set(item)
    assert int(item["mel2ph"].max()) == len(item["phone"])


def test_opencpop_binarizer_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("N_PROC", "1")
    raw = str(tmp_path / "raw")
    _make_opencpop_raw(raw)
    hp = {"binarizer_cls": "opencpop", "raw_data_dir": raw, "processed_data_dir": raw,
          "binarization_args": {"with_wav": False, "with_align": True, "with_f0": True,
                                "with_txt": True, "shuffle": False},
          "audio_sample_rate": 24000, "hop_size": 128, "fft_size": 512, "win_size": 512,
          "audio_num_mel_bins": 80, "fmin": 30, "fmax": 12000,
          "test_prefixes": ["000002000", "000002001"], "test_num": 1, "valid_num": 1,
          "num_spk": 1, "reset_phone_dict": True}
    assert tbin.get_binarizer_cls(hp) is tbin.OpencpopBinarizer
    for mod, name in ((tbin, "bt"), (jbin, "bj")):
        mod.binarize(dict(hp, binary_data_dir=str(tmp_path / name)))
    assert _compare_binary_dirs(str(tmp_path / "bt"), str(tmp_path / "bj")) == 4 + 2 + 2


def test_binarizer_registry_names():
    for name in ("base", "zh", "singing", "midisinging", "opencpop",
                 "data_gen.tts.base_binarizer.BaseBinarizer",
                 "data_gen.singing.binarize.OpencpopBinarizer"):
        t, j = tbin.get_binarizer_cls({"binarizer_cls": name}), \
            jbin.get_binarizer_cls({"binarizer_cls": name})
        assert t.__name__ == j.__name__
    with pytest.raises(KeyError):
        tbin.get_binarizer_cls({"binarizer_cls": "nope"})
