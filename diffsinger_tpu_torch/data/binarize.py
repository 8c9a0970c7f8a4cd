"""Offline binarization: raw corpora -> IndexedDataset splits (counterpart of
diffsinger_tpu/data/binarize.py).

    python -m diffsinger_tpu_torch.data.binarize --config <yaml> [--hparams k=v,...]

Host work, as in the JAX package: every utterance is read, conditioned
(``trim_long_sil``, ``loud_norm``), turned into a mel (``ops/mel.py``, numpy),
an F0 contour (``data/pitch_extract.py``), its CWT (``with_f0cwt``) and a
frame alignment, in ``N_PROC`` worker processes on the CPU. Nothing here
touches CUDA. The workers come from a fork server that has imported this
module once, not from the parent: a worker forked from the parent would
inherit its threads and any CUDA context it holds, which it cannot use, and
a spawned one would import torch anew.

  * ``BaseBinarizer``: ``metadata_phone.csv``, ``dict.txt`` and
    ``mfa_outputs/<item>.TextGrid`` per processed dir; test / valid / train
    split by ``test_num`` / ``valid_num``; ``spk_map.json``,
    ``phone_set.json``, ``<split>_lengths.npy``, ``<split>_f0s_mean_std.npy``;
  * ``ZhBinarizer``: the Chinese duration post-process;
  * ``SingingBinarizer``, ``MidiSingingBinarizer``, ``OpencpopBinarizer``:
    the singing corpora (``_wf0.wav`` globs, ``meta.json``,
    ``transcriptions.txt``) split by ``test_prefixes``.

The speaker encoder is the dotted-path protocol of the JAX package:
``speaker_encoder_cls`` names a class with ``embed(wav, sample_rate) -> [D]``
(``resemblyzer`` by default, skipped with a warning when not installed).

Also here: ``note_to_midi``, ``get_f0cwt`` (the CWT extras of one utterance)
and ``collate_cwt`` (the cwt keys of a ``pitch_type: cwt`` batch).
"""

from __future__ import annotations

import csv
import glob
import importlib
import json
import multiprocessing
import os
import random
import re
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from diffsinger_tpu_torch.data.audio_norm import normalize_loudness, trim_long_silences
from diffsinger_tpu_torch.data.indexed_dataset import IndexedDatasetBuilder
from diffsinger_tpu_torch.data.pitch_extract import get_pitch
from diffsinger_tpu_torch.data.text.pinyin import ALL_SHENGMU, ALL_YUNMU
from diffsinger_tpu_torch.data.textgrid import mel2ph_from_durs, mel2ph_from_textgrid
from diffsinger_tpu_torch.ops.mel import MelConfig, wav2spec
from diffsinger_tpu_torch.utils.cwt import get_cont_lf0, get_lf0_cwt
from diffsinger_tpu_torch.utils.misc import load_wav
from diffsinger_tpu_torch.utils.text_encoder import TokenTextEncoder, build_phone_encoder

NOTE_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}
BINARIZERS: Dict[str, type] = {}


class BinarizationError(Exception):
    pass


def note_to_midi(note: str) -> int:
    """'A4' / 'C#5' / 'Db4' -> midi number (librosa.note_to_midi semantics)."""
    m = re.match(r"([A-Ga-g])([#b♯♭!]*)(-?\d+)", note.strip())
    if not m:
        raise ValueError(f"bad note {note!r}")
    pitch = NOTE_OFFSETS[m.group(1).upper()]
    for acc in m.group(2):
        pitch += 1 if acc in "#♯" else -1
    octave = int(m.group(3))
    return 12 * (octave + 1) + pitch


def get_f0cwt(f0: np.ndarray, res: Dict[str, Any]) -> None:
    """Add the CWT of the continuous log-F0 of ``f0`` (Hz, 0 = unvoiced) to
    ``res``: ``cwt_spec`` [T, 10], ``cwt_scales`` [10] and the log-F0 mean
    and std it was normalized with."""
    _, cont_lf0 = get_cont_lf0(f0)
    mean, std = np.mean(cont_lf0), np.std(cont_lf0)
    w, scales = get_lf0_cwt((cont_lf0 - mean) / std)
    if np.any(np.isnan(w)):
        raise BinarizationError("NaN CWT")
    res["cwt_spec"] = w
    res["cwt_scales"] = scales
    res["f0_mean"] = mean
    res["f0_std"] = std


def collate_cwt(items: Sequence[Dict[str, Any]], t_mel: int) -> Dict[str, np.ndarray]:
    """The cwt keys of a batch of ``get_f0cwt`` results: ``cwt_spec``
    [B, t_mel, 10] (cut or zero-padded to t_mel frames), ``f0_mean`` and
    ``f0_std`` [B] float32."""
    spec = np.zeros((len(items), t_mel, 10), np.float32)
    for i, it in enumerate(items):
        w = np.asarray(it["cwt_spec"], np.float32)[:t_mel]
        spec[i, : len(w)] = w
    return {"cwt_spec": spec,
            "f0_mean": np.asarray([float(np.mean(it["f0_mean"])) for it in items], np.float32),
            "f0_std": np.asarray([float(np.mean(it["f0_std"])) for it in items], np.float32)}


def condition_wav(wav: np.ndarray, hp, sample_rate: int) -> np.ndarray:
    """Pre-mel waveform hooks: ``trim_long_sil`` removes long silent
    stretches, ``loud_norm`` gains to -22 LUFS (BS.1770)."""
    if hp.get("trim_long_sil"):
        wav, _, _ = trim_long_silences(wav, sample_rate, norm=False)
    if hp.get("loud_norm"):
        wav = normalize_loudness(wav, sample_rate, target_lufs=-22.0)
    return wav


class ResemblyzerEncoder:
    """Default speaker encoder; the import is deferred so corpora binarize
    without resemblyzer (``spk_embed`` skipped)."""

    def __init__(self):
        from resemblyzer import VoiceEncoder

        self._enc = VoiceEncoder()

    def embed(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        return np.asarray(self._enc.embed_utterance(wav), np.float32)


def get_speaker_encoder(hp) -> Optional[Any]:
    """``speaker_encoder_cls``: 'resemblyzer' or a dotted path to a class with
    ``embed(wav, sample_rate) -> [D] float32``."""
    name = str(hp.get("speaker_encoder_cls", "resemblyzer"))
    if name == "resemblyzer":
        try:
            return ResemblyzerEncoder()
        except ImportError:
            print("| warning: resemblyzer not available; spk_embed skipped")
            return None
    mod, cls = name.rsplit(".", 1)
    return getattr(importlib.import_module(mod), cls)()


def register_binarizer(name):
    def deco(cls):
        BINARIZERS[name] = cls
        return cls
    return deco


def get_binarizer_cls(hp) -> type:
    """Short names ('base', 'singing', 'opencpop', ...) or reference dotted
    paths both resolve."""
    name = str(hp.get("binarizer_cls", "base"))
    short = name.split(".")[-1].lower().replace("binarizer", "") or "base"
    for key in (name, short):
        if key in BINARIZERS:
            return BINARIZERS[key]
    raise KeyError(f"unknown binarizer {name}")


def _base_item(item_name, ph, txt, wav_fn, spk_id, hp) -> Tuple[Dict[str, Any], np.ndarray,
                                                                np.ndarray]:
    """Read, condition and mel one utterance: (res, wav, mel)."""
    cfg = MelConfig.from_hparams(hp)
    wav = load_wav(wav_fn, cfg.sample_rate) if isinstance(wav_fn, str) else wav_fn
    wav = condition_wav(wav, hp, cfg.sample_rate)
    wav, mel = wav2spec(wav, cfg)
    res = {"item_name": item_name, "txt": txt, "ph": ph, "mel": mel, "wav": wav,
           "wav_fn": wav_fn, "sec": len(wav) / cfg.sample_rate, "len": mel.shape[0],
           "spk_id": spk_id}
    return res, wav, mel


@register_binarizer("base")
class BaseBinarizer:
    def __init__(self, hp: Dict[str, Any]):
        self.hp = hp
        self.processed_data_dirs = str(hp["processed_data_dir"]).split(",")
        self.binarization_args = hp["binarization_args"]
        self.item2txt: Dict[str, str] = {}
        self.item2ph: Dict[str, str] = {}
        self.item2wavfn: Dict[str, str] = {}
        self.item2tgfn: Dict[str, str] = {}
        self.item2spk: Dict[str, str] = {}
        self.item_names: List[str] = []

    # -------------------------------------------------------------- metadata
    def load_meta_data(self):
        """metadata_phone.csv of each processed dir."""
        hp = self.hp
        for ds_id, pdir in enumerate(self.processed_data_dirs):
            with open(os.path.join(pdir, "metadata_phone.csv")) as f:
                for r in csv.DictReader(f):
                    item_name = raw = r["item_name"]
                    if len(self.processed_data_dirs) > 1:
                        item_name = f"ds{ds_id}_{item_name}"
                    self.item2txt[item_name] = r["txt"]
                    self.item2ph[item_name] = r["ph"]
                    wav_base = os.path.basename(r["wav_fn"])
                    wav_base = wav_base.split("_")[1] if "_" in wav_base else wav_base
                    self.item2wavfn[item_name] = os.path.join(
                        hp["raw_data_dir"], "wavs", wav_base)
                    self.item2spk[item_name] = r.get("spk", "SPK1")
                    self.item2tgfn[item_name] = os.path.join(
                        pdir, "mfa_outputs", f"{raw}.TextGrid")
        self.item_names = sorted(self.item2txt.keys())
        if self.binarization_args.get("shuffle"):
            random.seed(1234)
            random.shuffle(self.item_names)

    @property
    def train_item_names(self):
        return self.item_names[self.hp["test_num"] + self.hp["valid_num"]:]

    @property
    def valid_item_names(self):
        return self.item_names[: self.hp["test_num"] + self.hp["valid_num"]]

    @property
    def test_item_names(self):
        return self.item_names[: self.hp["test_num"]]

    # -------------------------------------------------------------- vocab/spk
    def build_spk_map(self) -> Dict[str, int]:
        spk_map = {x: i for i, x in enumerate(sorted(set(self.item2spk.values())))}
        assert len(spk_map) <= self.hp["num_spk"], len(spk_map)
        return spk_map

    def _phone_set(self) -> List[str]:
        ph_set = []
        for pdir in self.processed_data_dirs:
            dict_fn = os.path.join(pdir, "dict.txt")
            if os.path.exists(dict_fn):
                with open(dict_fn) as f:
                    ph_set += [x.split(" ")[0] for x in f]
        return sorted(set(ph_set))

    def build_phone_encoder(self) -> TokenTextEncoder:
        hp = self.hp
        ph_set_fn = os.path.join(hp["binary_data_dir"], "phone_set.json")
        if hp.get("reset_phone_dict") or not os.path.exists(ph_set_fn):
            with open(ph_set_fn, "w") as f:
                json.dump(self._phone_set(), f, ensure_ascii=False)
        return build_phone_encoder(hp["binary_data_dir"])

    # -------------------------------------------------------------- process
    def meta_data(self, prefix: str) -> Iterator[Tuple]:
        names = {"valid": self.valid_item_names, "test": self.test_item_names,
                 "train": self.train_item_names}[prefix]
        for item_name in names:
            yield (item_name, self.item2ph[item_name], self.item2txt[item_name],
                   self.item2tgfn.get(item_name), self.item2wavfn[item_name],
                   self.spk_map[self.item2spk[item_name]])

    def item_args(self, meta: Tuple) -> List[Any]:
        """The ``process_item`` arguments of one ``meta_data`` row."""
        return list(meta) + [self.phone_encoder, self.binarization_args, self.hp]

    def process(self):
        hp = self.hp
        self.load_meta_data()
        os.makedirs(hp["binary_data_dir"], exist_ok=True)
        self.spk_map = self.build_spk_map()
        with open(os.path.join(hp["binary_data_dir"], "spk_map.json"), "w") as f:
            json.dump(self.spk_map, f, ensure_ascii=False)
        self.phone_encoder = self.build_phone_encoder()
        self.spk_encoder = (get_speaker_encoder(hp)
                            if self.binarization_args.get("with_spk_embed") else None)
        workers = int(os.getenv("N_PROC", max(1, (os.cpu_count() or 2) // 3)))
        pool = None
        if workers > 1:
            ctx = multiprocessing.get_context("forkserver")
            pool = ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
        try:
            for prefix in ("valid", "test", "train"):
                self.process_data(prefix, pool)
        finally:
            if pool is not None:
                pool.shutdown()

    def process_data(self, prefix: str, pool: Optional[ProcessPoolExecutor] = None):
        hp = self.hp
        data_dir = hp["binary_data_dir"]
        builder = IndexedDatasetBuilder(os.path.join(data_dir, prefix))
        lengths, f0s, total_sec = [], [], 0.0
        args = [self.item_args(m) for m in self.meta_data(prefix)]
        for item in _parallel_map(type(self).process_item, args, pool):
            if item is None:
                continue
            if self.spk_encoder is not None and "wav" in item:
                # the embedding runs in the parent over the worker's wav
                item["spk_embed"] = self.spk_encoder.embed(item["wav"],
                                                           int(hp["audio_sample_rate"]))
            if not self.binarization_args.get("with_wav") and "wav" in item:
                del item["wav"]
            builder.add_item(item)
            lengths.append(item["len"])
            total_sec += item["sec"]
            if item.get("f0") is not None:
                f0s.append(item["f0"])
        builder.finalize()
        np.save(os.path.join(data_dir, f"{prefix}_lengths.npy"), lengths)
        if f0s:
            f0s = np.concatenate(f0s, 0)
            f0s = f0s[f0s != 0]
            np.save(os.path.join(data_dir, f"{prefix}_f0s_mean_std.npy"),
                    [np.mean(f0s).item(), np.std(f0s).item()])
        print(f"| {prefix}: {len(lengths)} items, {total_sec:.1f}s audio")

    # -------------------------------------------------------------- per item
    @classmethod
    def process_item(cls, item_name, ph, txt, tg_fn, wav_fn, spk_id, encoder,
                     binarization_args, hp):
        res, wav, mel = _base_item(item_name, ph, txt, wav_fn, spk_id, hp)
        try:
            if binarization_args.get("with_f0", True):
                cls.get_f0(wav, mel, res, hp)
                if binarization_args.get("with_f0cwt"):
                    get_f0cwt(res["f0"], res)
            if binarization_args.get("with_txt", True):
                try:
                    res["phone"] = encoder.encode(ph)
                except Exception:
                    traceback.print_exc()
                    raise BinarizationError("Empty phoneme")
                if binarization_args.get("with_align", True):
                    cls.get_align(tg_fn, ph, mel, res["phone"], res, hp)
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            return None
        return res

    @staticmethod
    def get_f0(wav, mel, res, hp):
        f0, coarse = get_pitch(wav, mel, hp)
        if f0.sum() == 0:
            raise BinarizationError("Empty f0")
        res["f0"], res["pitch"] = f0, coarse

    @staticmethod
    def get_align(tg_fn, ph, mel, phone_encoded, res, hp):
        if tg_fn is None or not os.path.exists(tg_fn):
            raise BinarizationError("Align not found")
        with open(tg_fn) as f:
            mel2ph, dur = mel2ph_from_textgrid(f.read(), ph, mel.shape[0],
                                               hp["audio_sample_rate"], hp["hop_size"])
        if mel2ph.max() - 1 >= len(phone_encoded):
            raise BinarizationError("Align does not match")
        res["mel2ph"], res["dur"] = mel2ph, dur


@register_binarizer("zh")
class ZhBinarizer(BaseBinarizer):
    """Chinese duration post-processing: a separator's leading voiced frames
    move into the previous yunmu (short separators vanish entirely), then
    each shengmu+yunmu pair splits its combined duration 50/50."""

    @staticmethod
    def get_align(tg_fn, ph, mel, phone_encoded, res, hp):
        if tg_fn is None or not os.path.exists(tg_fn):
            raise BinarizationError("Align not found")
        with open(tg_fn) as f:
            _, dur = mel2ph_from_textgrid(f.read(), ph, mel.shape[0],
                                          hp["audio_sample_rate"], hp["hop_size"])
        ph_list = ph.split(" ")
        assert len(dur) == len(ph_list)
        dur = list(dur)
        dur_cumsum = np.pad(np.cumsum(dur), (1, 0))
        for i in range(len(dur)):
            p = ph_list[i]
            if p and p[0] != "<" and not p[0].isalpha():
                uv_ = res["f0"][dur_cumsum[i]: dur_cumsum[i + 1]] == 0
                j = 0
                while j < len(uv_) and not uv_[j]:
                    j += 1
                dur[i - 1] += j
                dur[i] -= j
                if dur[i] < 100:
                    dur[i - 1] += dur[i]
                    dur[i] = 0
        for i in range(len(dur)):
            if ph_list[i] in ALL_SHENGMU and i + 1 < len(ph_list):
                p_next = ph_list[i + 1]
                if not (dur[i] > 0 and p_next and p_next[0].isalpha()
                        and p_next not in ALL_SHENGMU):
                    continue
                total = dur[i + 1] + dur[i]
                dur[i] = total // 2
                dur[i + 1] = total - dur[i]
        mel2ph = np.concatenate([np.full(d, i + 1, np.int64)
                                 for i, d in enumerate(dur)]) if sum(dur) else \
            np.zeros(0, np.int64)
        if len(mel2ph) and mel2ph.max() - 1 >= len(phone_encoded):
            raise BinarizationError("Align does not match")
        res["mel2ph"] = mel2ph
        res["dur"] = np.asarray(dur)


@register_binarizer("singing")
class SingingBinarizer(BaseBinarizer):
    def load_meta_data(self):
        """``<dir>/<song>/<piece>_wf0.wav`` with ``.txt`` / ``_ph.txt`` sidecars."""
        for ds_id, pdir in enumerate(self.processed_data_dirs):
            for piece in glob.glob(f"{pdir}/*/*_wf0.wav"):
                item_name = piece[len(pdir) + 1:].replace("/", "-")[: -len("_wf0.wav")]
                if len(self.processed_data_dirs) > 1:
                    item_name = f"ds{ds_id}_{item_name}"
                with open(piece.replace("_wf0.wav", ".txt")) as f:
                    self.item2txt[item_name] = f.readline()
                with open(piece.replace("_wf0.wav", "_ph.txt")) as f:
                    self.item2ph[item_name] = f.readline()
                self.item2wavfn[item_name] = piece
                self.item2spk[item_name] = re.split("-|#", piece.split("/")[-2])[0]
                self.item2tgfn[item_name] = piece.replace("_wf0.wav", ".TextGrid")
        self.item_names = sorted(self.item2txt.keys())
        if self.binarization_args.get("shuffle"):
            random.seed(1234)
            random.shuffle(self.item_names)
        self._split_train_test()

    def _split_train_test(self):
        prefixes = self.hp.get("test_prefixes", [])
        self._test_item_names = [x for x in self.item_names
                                 if any(ts in x for ts in prefixes)]
        test = set(self._test_item_names)
        self._train_item_names = [x for x in self.item_names if x not in test]

    @property
    def train_item_names(self):
        return self._train_item_names

    @property
    def valid_item_names(self):
        return self._test_item_names

    @property
    def test_item_names(self):
        return self._test_item_names

    def _phone_set(self):
        ph_set = []
        for ph_sent in self.item2ph.values():
            ph_set += ph_sent.split(" ")
        return sorted(set(ph_set))


class _MidiMixin:
    """MIDI metadata columns shared by the MidiSinging and Opencpop binarizers."""

    def _init_midi(self):
        self.item2midi: Dict[str, List[int]] = {}
        self.item2midi_dur: Dict[str, List[float]] = {}
        self.item2is_slur: Dict[str, List[int]] = {}
        self.item2ph_durs: Dict[str, List[float]] = {}
        self.item2wdb: Dict[str, List[int]] = {}

    @classmethod
    def process_item(cls, item_name, ph, txt, tg_fn, wav_fn, spk_id, encoder,
                     binarization_args, hp, midi_meta=None):
        res, wav, mel = _base_item(item_name, ph, txt, wav_fn, spk_id, hp)
        try:
            midi, midi_dur, is_slur, wdb, ph_durs = midi_meta
            res["pitch_midi"] = np.asarray(midi)
            res["midi_dur"] = np.asarray(midi_dur, np.float32)
            res["is_slur"] = np.asarray(is_slur)
            res["word_boundary"] = np.asarray(wdb)
            assert res["pitch_midi"].shape == res["midi_dur"].shape \
                == res["is_slur"].shape, (res["pitch_midi"].shape,)
            if binarization_args.get("with_f0", True):
                BaseBinarizer.get_f0(wav, mel, res, hp)
            if binarization_args.get("with_txt", True):
                try:
                    res["phone"] = encoder.encode(ph)
                except Exception:
                    raise BinarizationError("Empty phoneme")
                if binarization_args.get("with_align", True):
                    res["mel2ph"] = mel2ph_from_durs(ph_durs, mel.shape[0],
                                                     hp["audio_sample_rate"], hp["hop_size"])
        except BinarizationError as e:
            print(f"| Skip item ({e}). item_name: {item_name}")
            return None
        return res

    def meta_data(self, prefix):
        for m in super().meta_data(prefix):  # type: ignore[misc]
            item_name = m[0]
            yield tuple(m) + ((self.item2midi[item_name], self.item2midi_dur[item_name],
                               self.item2is_slur[item_name], self.item2wdb[item_name],
                               self.item2ph_durs[item_name]),)

    def item_args(self, meta):
        return list(meta[:-1]) + [self.phone_encoder, self.binarization_args, self.hp,
                                  meta[-1]]


@register_binarizer("midisinging")
class MidiSingingBinarizer(_MidiMixin, SingingBinarizer):
    def __init__(self, hp):
        super().__init__(hp)
        self._init_midi()

    def load_meta_data(self):
        """meta.json with the note lists of each song."""
        for ds_id, pdir in enumerate(self.processed_data_dirs):
            with open(os.path.join(pdir, "meta.json")) as f:
                meta = json.load(f)
            for song in meta:
                item_name = song["item_name"]
                if len(self.processed_data_dirs) > 1:
                    item_name = f"ds{ds_id}_{item_name}"
                self.item2wavfn[item_name] = song["wav_fn"]
                self.item2txt[item_name] = song["txt"]
                self.item2ph[item_name] = " ".join(song["phs"])
                self.item2wdb[item_name] = [
                    1 if x in ALL_YUNMU + ["AP", "SP", "<SIL>"] else 0 for x in song["phs"]]
                self.item2ph_durs[item_name] = song["ph_dur"]
                self.item2midi[item_name] = song["notes"]
                self.item2midi_dur[item_name] = song["notes_dur"]
                self.item2is_slur[item_name] = song["is_slur"]
                self.item2spk[item_name] = "pop-cs"
        self.item_names = sorted(self.item2txt.keys())
        self._split_train_test()


@register_binarizer("opencpop")
class OpencpopBinarizer(_MidiMixin, SingingBinarizer):
    def __init__(self, hp):
        super().__init__(hp)
        self._init_midi()

    def _split_train_test(self):
        prefixes = self.hp.get("test_prefixes", [])
        self._test_item_names = [x for x in self.item_names
                                 if any(x.startswith(ts) for ts in prefixes)]
        test = set(self._test_item_names)
        self._train_item_names = [x for x in self.item_names if x not in test]

    def load_meta_data(self):
        """transcriptions.txt: item|txt|ph|notes|notes_dur|ph_dur|is_slur."""
        raw = self.hp["raw_data_dir"]
        with open(os.path.join(raw, "transcriptions.txt")) as f:
            lines = f.readlines()
        for line in lines:
            info = line.strip("\n").split("|")
            if len(info) < 7:
                continue
            item_name = info[0]
            self.item2wavfn[item_name] = f"{raw}/wavs/{item_name}.wav"
            self.item2txt[item_name] = info[1]
            self.item2ph[item_name] = info[2]
            self.item2wdb[item_name] = [
                1 if x in ALL_YUNMU + ["AP", "SP"] else 0 for x in info[2].split()]
            self.item2midi[item_name] = [
                note_to_midi(x.split("/")[0]) if x != "rest" else 0
                for x in info[3].split(" ")]
            self.item2midi_dur[item_name] = [float(x) for x in info[4].split(" ")]
            self.item2ph_durs[item_name] = [float(x) for x in info[5].split(" ")]
            self.item2is_slur[item_name] = [int(x) for x in info[6].split(" ")]
            self.item2spk[item_name] = "opencpop"
        self.item_names = sorted(self.item2txt.keys())
        self._split_train_test()


def _parallel_map(fn, args_list, pool: Optional[ProcessPoolExecutor]):
    """Ordered map over ``pool``; serial without one or for fewer than 4 jobs."""
    if pool is None or len(args_list) < 4:
        for args in args_list:
            yield fn(*args)
        return
    futures = [pool.submit(fn, *args) for args in args_list]
    for fut in futures:
        yield fut.result()


def binarize(hp: Dict[str, Any]):
    get_binarizer_cls(hp)(hp).process()


if __name__ == "__main__":
    # through the module's own name, so that the workers unpickle its classes
    # from the module the fork server has imported
    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.data.binarize import binarize as _binarize

    _binarize(set_hparams())
