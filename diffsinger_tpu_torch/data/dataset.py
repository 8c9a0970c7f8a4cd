"""Training datasets (counterpart of diffsinger_tpu/data/dataset.py): item ->
numpy features, token-bucket batching, padding to bucketed shapes.

Feature derivation as upstream tasks/tts/fs2_utils.py (energy =
sqrt(sum(exp(mel)^2)), norm_interp f0/uv, ph-level f0 scatter-mean, CWT extras,
max_frames/max_input_tokens truncation) and usr/diffsinger_task.py:254-270
(the Opencpop extras: pitch_midi, midi_dur, is_slur, word_boundary);
size-sorted shuffled ordering and token bucketing (``misc.batch_by_size``).

Batches are padded to multiples of ``FRAME_BUCKET`` / ``TOKEN_BUCKET``, as the
JAX package pads them, so both see the same batches; they stay numpy, and
``Trainer.prepare_batch`` moves them to the device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from diffsinger_tpu_torch.data.indexed_dataset import IndexedDataset
from diffsinger_tpu_torch.utils.misc import batch_by_size, collate_1d, collate_2d
from diffsinger_tpu_torch.utils.pitch import norm_interp_f0_np

TOKEN_BUCKET = 32
FRAME_BUCKET = 128


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class FastSpeechDataset:
    """Reads a binarized split and yields per-item numpy feature dicts."""

    def __init__(self, hp: Dict[str, Any], prefix: str, shuffle: bool = False):
        self.hp = hp
        self.prefix = prefix
        self.shuffle = shuffle
        self.data_dir = hp["binary_data_dir"]
        self.indexed_ds: Optional[IndexedDataset] = None
        self._items_override: Optional[List[Dict[str, Any]]] = None
        self.avail_idxs: Optional[List[int]] = None
        if prefix == "test" and hp.get("test_input_dir"):
            # raw-wav ingestion (reference tasks/tts/fs2_utils.py:154-173)
            self._items_override, self.sizes = load_test_inputs(
                hp, hp["test_input_dir"])
            return
        self.sizes = np.load(f"{self.data_dir}/{prefix}_lengths.npy")
        f0_stats_fn = f"{self.data_dir}/train_f0s_mean_std.npy"
        if os.path.exists(f0_stats_fn):
            mean, std = np.load(f0_stats_fn)
            hp["f0_mean"], hp["f0_std"] = float(mean), float(std)
        if prefix == "test" and hp.get("num_test_samples", 0) > 0:
            self.avail_idxs = (list(range(hp["num_test_samples"]))
                               + list(hp.get("test_ids", [])))
            self.sizes = np.asarray([self.sizes[i] for i in self.avail_idxs])

    def _get_item(self, index: int) -> Dict[str, Any]:
        if self._items_override is not None:
            return self._items_override[index]
        if self.avail_idxs is not None:
            index = self.avail_idxs[index]
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(f"{self.data_dir}/{self.prefix}")
        return self.indexed_ds[index]

    def __len__(self) -> int:
        return len(self.sizes)

    def num_tokens(self, index: int) -> int:
        return min(int(self.sizes[index]), self.hp["max_frames"])

    def __getitem__(self, index: int) -> Dict[str, Any]:
        hp = self.hp
        item = self._get_item(index)
        max_frames = hp["max_frames"]
        spec = np.asarray(item["mel"], np.float32)[:max_frames]
        energy = np.sqrt((np.exp(spec) ** 2).sum(-1))
        mel2ph = (np.asarray(item["mel2ph"], np.int64)[:max_frames]
                  if "mel2ph" in item else None)
        f0, uv = norm_interp_f0_np(np.asarray(item["f0"])[:max_frames],
                                   pitch_norm=hp.get("pitch_norm", "log"),
                                   f0_mean=hp.get("f0_mean") or 0.0,
                                   f0_std=hp.get("f0_std") or 1.0,
                                   use_uv=hp.get("use_uv", True))
        phone = np.asarray(item["phone"], np.int64)[: hp["max_input_tokens"]]
        sample = {
            "id": index,
            "item_name": item["item_name"],
            "text": item.get("txt", ""),
            "txt_token": phone,
            "mel": spec,
            "pitch": np.asarray(item["pitch"], np.int64)[:max_frames]
                     if item.get("pitch") is not None else None,
            "energy": energy,
            "f0": f0,
            "uv": uv,
            "mel2ph": mel2ph,
        }
        if hp.get("use_spk_embed"):
            sample["spk_embed"] = np.asarray(item["spk_embed"], np.float32)
        if hp.get("use_spk_id"):
            sample["spk_id"] = int(item.get("spk_id", 0))
        if hp.get("pitch_type") == "cwt":
            sample["cwt_spec"] = np.asarray(item["cwt_spec"], np.float32)[:max_frames]
            # per-utterance log-f0 stats; stored as scalars or per-scale arrays
            fm = item.get("f0_mean", item.get("cwt_mean"))
            fs = item.get("f0_std", item.get("cwt_std"))
            sample["f0_mean"] = float(np.mean(fm)) if fm is not None else 0.0
            sample["f0_std"] = float(np.mean(fs)) if fs is not None else 1.0
        elif hp.get("pitch_type") == "ph" and mel2ph is not None:
            f0_sum = np.zeros(len(phone) + 1, np.float32)
            f0_cnt = np.zeros(len(phone) + 1, np.float32)
            np.add.at(f0_sum, mel2ph, f0)
            np.add.at(f0_cnt, mel2ph, 1.0)
            sample["f0_ph"] = f0_sum[1:] / np.maximum(f0_cnt[1:], 1)
        return sample

    def ordered_indices(self) -> np.ndarray:
        """Size-sorted (shuffled within) ordering (reference base_task.py:56-68)."""
        if self.shuffle:
            indices = np.random.permutation(len(self))
            if self.hp.get("sort_by_len", True):
                indices = indices[np.argsort(self.sizes[indices], kind="mergesort")]
        else:
            indices = np.arange(len(self))
        return indices

    # ----------------------------------------------------------------- batching
    def collater(self, samples: List[Dict[str, Any]],
                 pad_to_buckets: bool = True) -> Dict[str, Any]:
        if len(samples) == 0:
            return {}
        hp = self.hp
        max_txt = max(len(s["txt_token"]) for s in samples)
        max_mel = max(s["mel"].shape[0] for s in samples)
        if pad_to_buckets:
            max_txt = min(round_up(max_txt, TOKEN_BUCKET), hp["max_input_tokens"])
            max_mel = min(round_up(max_mel, FRAME_BUCKET), hp["max_frames"])
        batch = {
            "id": np.asarray([s["id"] for s in samples], np.int64),
            "item_name": [s["item_name"] for s in samples],
            "nsamples": len(samples),
            "text": [s["text"] for s in samples],
            "txt_tokens": collate_1d([s["txt_token"] for s in samples], 0, max_txt),
            "txt_lengths": np.asarray([len(s["txt_token"]) for s in samples],
                                      np.int64),
            "mels": collate_2d([s["mel"] for s in samples], 0.0, max_mel),
            "mel_lengths": np.asarray([s["mel"].shape[0] for s in samples], np.int64),
            "energy": collate_1d([s["energy"] for s in samples], 0.0, max_mel),
            "f0": collate_1d([s["f0"] for s in samples], 0.0, max_mel),
            "uv": collate_1d([s["uv"] for s in samples], 0.0, max_mel),
        }
        if samples[0].get("mel2ph") is not None:
            batch["mel2ph"] = collate_1d([s["mel2ph"] for s in samples], 0, max_mel)
        if samples[0].get("pitch") is not None:
            batch["pitch"] = collate_1d([s["pitch"] for s in samples], 0, max_mel)
        if hp.get("use_spk_embed"):
            batch["spk_embed"] = np.stack([s["spk_embed"] for s in samples])
        if hp.get("use_spk_id"):
            batch["spk_ids"] = np.asarray([s["spk_id"] for s in samples], np.int64)
        if hp.get("pitch_type") == "cwt":
            batch["cwt_spec"] = collate_2d([s["cwt_spec"] for s in samples], 0.0,
                                           max_mel)
            batch["f0_mean"] = np.asarray([s["f0_mean"] for s in samples], np.float32)
            batch["f0_std"] = np.asarray([s["f0_std"] for s in samples], np.float32)
        elif hp.get("pitch_type") == "ph":
            batch["f0"] = collate_1d([s["f0_ph"] for s in samples], 0.0, max_txt)
        return batch

    def batches(self, max_tokens: Optional[int] = None,
                max_sentences: Optional[int] = None, shuffle_batches: bool = False,
                seed: int = 0, required_batch_size_multiple: int = 1,
                ) -> List[List[int]]:
        hp = self.hp
        max_tokens = max_tokens if max_tokens is not None else hp["max_tokens"]
        max_sentences = (max_sentences if max_sentences is not None
                         else hp["max_sentences"])
        indices = self.ordered_indices()
        batches = batch_by_size(indices, self.num_tokens, max_tokens=max_tokens,
                                max_sentences=max_sentences,
                                required_batch_size_multiple=
                                required_batch_size_multiple)
        if shuffle_batches:
            np.random.RandomState(seed).shuffle(batches)
        return batches

    def iter_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        for batch_idx in self.batches(**kw):
            yield self.collater([self[i] for i in batch_idx])


def load_test_inputs(hp: Dict[str, Any], test_input_dir: str):
    """Ingest raw wavs as test items: mel + F0, no text/alignment
    (reference tasks/tts/fs2_utils.py:154-173)."""
    import glob as _glob

    from diffsinger_tpu_torch.data.pitch_extract import get_pitch
    from diffsinger_tpu_torch.ops.mel import MelConfig, wav2spec
    from diffsinger_tpu_torch.utils.misc import load_wav

    cfg = MelConfig.from_hparams(hp)
    items, sizes = [], []
    for wav_fn in sorted(_glob.glob(os.path.join(test_input_dir, "*.wav"))):
        wav = load_wav(wav_fn, cfg.sample_rate)
        wav, mel = wav2spec(wav, cfg)
        f0, pitch = get_pitch(wav, mel, hp)
        items.append({"item_name": os.path.basename(wav_fn), "txt": "",
                      "phone": np.zeros(1, np.int64), "mel": mel, "f0": f0,
                      "pitch": pitch})
        sizes.append(mel.shape[0])
    return items, np.asarray(sizes)


class ShallowDiffusionOfflineDataset(FastSpeechDataset):
    """Adds precomputed FFT-Singer boost mels for eval/test splits
    (reference usr/diffsinger_task.py:102-118: loads
    ``<fs2_ckpt_dir>/P_mels_npy/<item>.npy``)."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        sample = super().__getitem__(index)
        hp = self.hp
        if self.prefix != "train" and hp.get("fs2_ckpt"):
            fs2_dir = os.path.dirname(hp["fs2_ckpt"]) or hp["fs2_ckpt"]
            fn = os.path.join(fs2_dir, "P_mels_npy",
                              f"{sample['item_name']}.npy")
            if os.path.exists(fn):
                sample["fs2_mel"] = np.load(fn).astype(np.float32)
        return sample

    def collater(self, samples, pad_to_buckets: bool = True):
        batch = super().collater(samples, pad_to_buckets)
        if batch and all("fs2_mel" in s for s in samples):
            batch["fs2_mels"] = collate_2d([s["fs2_mel"] for s in samples], 0.0,
                                           batch["mels"].shape[1])
        return batch


class OpencpopDataset(FastSpeechDataset):
    """Adds MIDI features (reference usr/diffsinger_task.py:254-270)."""

    def __getitem__(self, index: int) -> Dict[str, Any]:
        sample = super().__getitem__(index)
        item = self._get_item(index)
        n = len(sample["txt_token"])
        sample["pitch_midi"] = np.asarray(item["pitch_midi"], np.int64)[:n]
        sample["midi_dur"] = np.asarray(item["midi_dur"], np.float32)[:n]
        sample["is_slur"] = np.asarray(item["is_slur"], np.int64)[:n]
        sample["word_boundary"] = np.asarray(item["word_boundary"], np.int64)[:n]
        return sample

    def collater(self, samples, pad_to_buckets: bool = True):
        batch = super().collater(samples, pad_to_buckets)
        if not batch:
            return batch
        max_txt = batch["txt_tokens"].shape[1]
        batch["pitch_midi"] = collate_1d([s["pitch_midi"] for s in samples], 0,
                                         max_txt)
        batch["midi_dur"] = collate_1d([s["midi_dur"] for s in samples], 0.0,
                                       max_txt)
        batch["is_slur"] = collate_1d([s["is_slur"] for s in samples], 0, max_txt)
        batch["word_boundary"] = collate_1d([s["word_boundary"] for s in samples], 0,
                                            max_txt)
        return batch
