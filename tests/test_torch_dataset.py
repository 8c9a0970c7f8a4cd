"""The port's training datasets against the JAX package's on the same
binarized data (``tests/helpers.py:make_synthetic_dataset``): items, batch
order and shuffles by seed, bucket padding, eval batching limits, the pitch
variants and the raw-wav test inputs. Everything is numpy on both sides and
must agree exactly (the test-input mel within 1e-4, as ``wav2spec``)."""

import os

import numpy as np
import pytest

from diffsinger_tpu.data import dataset as jds
from diffsinger_tpu_torch.data import dataset as tds
from tests.helpers import make_synthetic_dataset, tiny_hparams


def _batches(mod, cls_name, hp, prefix, shuffle, **kw):
    np.random.seed(11)  # ordered_indices shuffles with numpy's global generator
    ds = getattr(mod, cls_name)(dict(hp), prefix, shuffle=shuffle)
    return list(ds.iter_batches(**kw)), ds


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    return {"plain": make_synthetic_dataset(str(root / "plain"), n_train=9, n_valid=3),
            "midi": make_synthetic_dataset(str(root / "midi"), n_train=7, n_valid=3,
                                           midi=True, seed=1)}


@pytest.mark.parametrize("pitch_type", ["frame", "cwt", "ph"])
@pytest.mark.parametrize("kw", [dict(shuffle_batches=True, seed=3),
                                dict(max_tokens=60, max_sentences=2),
                                dict(shuffle_batches=True, seed=4, max_sentences=3)])
def test_fastspeech_batches_match_jax(data_dirs, pitch_type, kw):
    hp = tiny_hparams(data_dirs["plain"], pitch_type=pitch_type)
    got, ds = _batches(tds, "FastSpeechDataset", hp, "train", True, **kw)
    want, jd = _batches(jds, "FastSpeechDataset", hp, "train", True, **kw)
    _assert_batches_equal(got, want)
    assert ds.hp["f0_mean"] == jd.hp["f0_mean"]  # the train f0 statistics were read
    # padded to the buckets of the JAX package
    assert all(b["mels"].shape[1] % tds.FRAME_BUCKET == 0 for b in got)


def test_eval_batches_and_test_ids_match_jax(data_dirs):
    hp = tiny_hparams(data_dirs["plain"], num_test_samples=2, test_ids=[0])
    for prefix in ("valid", "test"):
        got, ds = _batches(tds, "FastSpeechDataset", hp, prefix, False, max_sentences=1)
        want, _ = _batches(jds, "FastSpeechDataset", hp, prefix, False, max_sentences=1)
        _assert_batches_equal(got, want)
        assert all(b["nsamples"] == 1 for b in got)
    assert len(ds) == 3  # num_test_samples plus test_ids


def test_opencpop_batches_match_jax(data_dirs):
    hp = tiny_hparams(data_dirs["midi"], use_midi=True)
    got, _ = _batches(tds, "OpencpopDataset", hp, "train", True, shuffle_batches=True,
                      seed=1, max_sentences=3)
    want, _ = _batches(jds, "OpencpopDataset", hp, "train", True, shuffle_batches=True,
                       seed=1, max_sentences=3)
    _assert_batches_equal(got, want)
    assert got[0]["pitch_midi"].shape == got[0]["txt_tokens"].shape


def test_offline_dataset_reads_the_fs2_mels(data_dirs, tmp_path):
    """ShallowDiffusionOfflineDataset: eval splits take <fs2_ckpt dir>/P_mels_npy."""
    fs2_dir = tmp_path / "fs2"
    (fs2_dir / "P_mels_npy").mkdir(parents=True)
    hp = tiny_hparams(data_dirs["plain"], fs2_ckpt=str(fs2_dir / "model_ckpt_steps_1.ckpt"))
    rng = np.random.RandomState(0)
    for i in range(3):
        np.save(fs2_dir / "P_mels_npy" / f"valid_{i}.npy",
                rng.randn(12, 80).astype(np.float32))
    got, _ = _batches(tds, "ShallowDiffusionOfflineDataset", hp, "valid", False)
    want, _ = _batches(jds, "ShallowDiffusionOfflineDataset", hp, "valid", False)
    _assert_batches_equal(got, want)
    assert "fs2_mels" in got[0]
    train, _ = _batches(tds, "ShallowDiffusionOfflineDataset", hp, "train", False)
    assert "fs2_mels" not in train[0]


def test_load_test_inputs_matches_jax(tmp_path):
    from diffsinger_tpu_torch.utils.misc import save_wav

    rng = np.random.RandomState(2)
    sr = 22050
    for i, sec in enumerate((0.7, 1.1)):
        t = np.arange(int(sec * sr)) / sr
        wav = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) + rng.randn(len(t)) * 0.003
        save_wav(wav, str(tmp_path / f"in{i}.wav"), sr)
    hp = tiny_hparams(str(tmp_path), fft_size=1024, win_size=1024, fmin=80, fmax=7600)
    got_items, got_sizes = tds.load_test_inputs(hp, str(tmp_path))
    want_items, want_sizes = jds.load_test_inputs(hp, str(tmp_path))
    np.testing.assert_array_equal(got_sizes, want_sizes)
    for g, w in zip(got_items, want_items):
        assert g.keys() == w.keys() and g["item_name"] == w["item_name"]
        np.testing.assert_allclose(g["mel"], w["mel"], rtol=0, atol=1e-4)
        for k in ("f0", "pitch", "phone"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    hp["test_input_dir"] = str(tmp_path)
    ds = tds.FastSpeechDataset(hp, "test")
    assert len(ds) == 2 and os.path.basename(ds[0]["item_name"]) == "in0.wav"
