"""Raw-input singing synthesis: lyrics + MIDI notes -> waveform (counterpart of
diffsinger_tpu/inference/svs.py).

``BaseSVSInfer`` turns an opencpop-style input into a MIDI batch: phoneme
level (the ``transcriptions.txt`` format: phonemes, notes, note durations,
slur flags) or word level (Chinese lyrics through pinyin, one note group per
word, the extra notes of a word sung as slurs on its last phone). The batch
runs through the port's ``FusedSynthesizer`` (``fused_infer``, on unless set
false, with a HiFiGAN vocoder): conditioner, reverse diffusion,
PitchExtractor (``DiffSingerE2EInfer``) or the model's own F0
(``DiffSingerCascadeInfer``), and the NSF vocoder, all on the device. With
``fused_infer: false`` (or a vocoder the synthesizer does not take, such as
PWG) it runs the JAX package's unfused path: ``task.inference``, the mel cut
to its frames, the class's ``extract_f0`` and ``vocoder.spec2wav``. Every
request draws from a generator seeded with ``hp['seed']`` afresh, so one
input gives one waveform whatever the thread or the request before it.

What the caller does not pass is built from the run's files, as the JAX
``build_model`` / ``_build_pe`` do: the task from the newest checkpoint of
``work_dir`` (through ``Trainer.initialize``), the vocoder of ``hp['vocoder']``
(``vocoder_ckpt``) and the PitchExtractor from ``pe_ckpt`` (``pe_enable``).
An object passed for a part whose checkpoint is also on disk raises rather
than silently leave one of the two unused.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from diffsinger_tpu_torch.data.binarize import note_to_midi
from diffsinger_tpu_torch.data.text.pinyin import build_pinyin2ph_map
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer, _as_noise
from diffsinger_tpu_torch.inference.synthesize import _maybe_load_pe, _PEWrapper
from diffsinger_tpu_torch.inference.vocoder import HifiGAN, get_vocoder_cls
from diffsinger_tpu_torch.utils.device import resolve_device
from diffsinger_tpu_torch.utils.misc import save_wav
from diffsinger_tpu_torch.utils.text_encoder import TokenTextEncoder

# the opencpop models' 60-phone Chinese vocabulary (ids 3-62 after the reserved ones)
CPOP_PHONE_LIST = [
    "AP", "SP", "a", "ai", "an", "ang", "ao", "b", "c", "ch", "d", "e", "ei",
    "en", "eng", "er", "f", "g", "h", "i", "ia", "ian", "iang", "iao", "ie",
    "in", "ing", "iong", "iu", "j", "k", "l", "m", "n", "o", "ong", "ou", "p",
    "q", "r", "s", "sh", "t", "u", "ua", "uai", "uan", "uang", "ui", "un",
    "uo", "v", "van", "ve", "vn", "w", "x", "y", "z", "zh"]

# pypinyin polyphone workarounds applied before the lookup
_POLYPHONE_FIXES = [("最长", "最常"), ("长睫毛", "常睫毛"), ("那么长", "那么常"),
                    ("多长", "多常"), ("很长", "很常")]


def _lazy_pinyin(text: str):
    try:
        from pypinyin import lazy_pinyin
    except ImportError:
        from diffsinger_tpu_torch.data.text.hanzi_pinyin import lazy_pinyin_fallback

        return lazy_pinyin_fallback(text)
    return lazy_pinyin(text, strict=False)


def _existing_checkpoint(path: str) -> bool:
    return bool(path) and (os.path.isfile(path) or (os.path.isdir(path)
                                                    and bool(os.listdir(path))))


class BaseSVSInfer:
    # whether the synthesizer takes its F0 from the PitchExtractor
    uses_pe = True

    def __init__(self, hp: Dict[str, Any], task=None, vocoder=None, pe=None, device="cuda"):
        dev = resolve_device(device)
        for key, obj in (("work_dir", task), ("vocoder_ckpt", vocoder), ("pe_ckpt", pe)):
            if obj is not None and _existing_checkpoint(hp.get(key) or ""):
                raise ValueError(f"{key}={hp[key]} holds a checkpoint and an object for it "
                                 "was passed as well: pass one of the two")
        self.hp = hp
        self.device = dev
        self.ph_encoder = TokenTextEncoder(CPOP_PHONE_LIST, replace_oov=",")
        self.pinyin2phs = build_pinyin2ph_map()
        self.spk_map = {"opencpop": 0}
        if task is None:
            task = self.build_model(dev)
        if vocoder is None:
            vocoder = get_vocoder_cls(hp)(hp, device=dev)
        self.pe = None
        if self.uses_pe:
            self.pe = (_maybe_load_pe(hp, device=dev) if pe is None
                       else _PEWrapper(pe, hp, dev))
        self.task, self.vocoder = task, vocoder
        self.fused = None
        if hp.get("fused_infer", True) and isinstance(vocoder, HifiGAN):
            self.fused = FusedSynthesizer(
                hp, task, vocoder, pe=self.pe.module if self.pe is not None else None,
                device=dev)
        else:
            for part in (task, vocoder):
                if part.device != dev:
                    part.to(dev)
            task.device = dev

    def build_model(self, device):
        """The task with the newest checkpoint of ``work_dir`` restored."""
        from diffsinger_tpu_torch.training.tasks import DiffSingerTask
        from diffsinger_tpu_torch.training.trainer import Trainer

        task = DiffSingerTask(self.hp, vocab_size=len(self.ph_encoder), device=device)
        Trainer(self.hp, task, device=device).initialize()
        return task

    # ------------------------------------------------------------- frontend
    def preprocess_word_level_input(self, inp: Dict[str, str]):
        text_raw = inp["text"]
        for a, b in _POLYPHONE_FIXES:
            text_raw = text_raw.replace(a, b)
        pinyins = _lazy_pinyin(text_raw)
        ph_per_word = [self.pinyin2phs[p.strip()] for p in pinyins
                       if p.strip() in self.pinyin2phs]
        note_per_word = [x.strip() for x in inp["notes"].split("|") if x.strip()]
        dur_per_word = [x.strip() for x in inp["notes_duration"].split("|") if x.strip()]
        if not (len(note_per_word) == len(ph_per_word) == len(dur_per_word)):
            print("| word/notes count mismatch:", len(ph_per_word), len(note_per_word),
                  len(dur_per_word))
            return None
        ph_lst, note_lst, dur_lst, is_slur = [], [], [], []
        for phs, notes, durs in zip(ph_per_word, note_per_word, dur_per_word):
            phs, notes, durs = phs.split(), notes.split(), durs.split()
            for ph in phs:
                ph_lst.append(ph)
                note_lst.append(notes[0])
                dur_lst.append(durs[0])
                is_slur.append(0)
            # extra notes on the same word: repeat the last phone as a slur
            for k in range(1, len(notes)):
                ph_lst.append(phs[-1])
                note_lst.append(notes[k])
                dur_lst.append(durs[k])
                is_slur.append(1)
        return " ".join(ph_lst), note_lst, dur_lst, is_slur

    def preprocess_phoneme_level_input(self, inp: Dict[str, str]):
        ph_seq = inp["ph_seq"]
        note_lst = inp["note_seq"].split()
        dur_lst = inp["note_dur_seq"].split()
        is_slur = [int(float(x)) for x in inp["is_slur_seq"].split()]
        if not (len(note_lst) == len(ph_seq.split()) == len(dur_lst)):
            print("| phoneme/notes count mismatch")
            return None
        return ph_seq, note_lst, dur_lst, is_slur

    def preprocess_input(self, inp: Dict[str, str],
                         input_type: str = "word") -> Optional[Dict[str, Any]]:
        if input_type == "word":
            ret = self.preprocess_word_level_input(inp)
        elif input_type == "phoneme":
            ret = self.preprocess_phoneme_level_input(inp)
        else:
            print("| invalid input type")
            return None
        if ret is None:
            return None
        ph_seq, note_lst, dur_lst, is_slur = ret
        midis = [note_to_midi(x.split("/")[0]) if x != "rest" else 0 for x in note_lst]
        return {
            "item_name": inp.get("item_name", "<ITEM_NAME>"),
            "text": inp["text"], "ph": ph_seq,
            "spk_id": self.spk_map.get(inp.get("spk_name", "opencpop"), 0),
            "ph_token": self.ph_encoder.encode(ph_seq),
            "pitch_midi": np.asarray(midis),
            "midi_dur": np.asarray([float(x) for x in dur_lst], np.float32),
            "is_slur": np.asarray(is_slur),
        }

    def input_to_batch(self, item: Dict[str, Any]) -> Dict[str, Any]:
        mf = self.hp.get("max_frames", 8000)
        return {
            "item_name": [item["item_name"]], "text": [item["text"]], "ph": [item["ph"]],
            "txt_tokens": np.asarray(item["ph_token"], np.int64)[None],
            "spk_ids": np.asarray([item["spk_id"]], np.int64),
            "pitch_midi": item["pitch_midi"][None, :mf],
            "midi_dur": item["midi_dur"][None, :mf],
            "is_slur": item["is_slur"][None, :mf],
        }

    # ------------------------------------------------------------- forward
    def estimate_t_mel(self, item) -> int:
        """Frames for the notes' total duration, with 20% and 64 frames of
        headroom, clamped to [64, max_frames]."""
        total_dur = float(item["midi_dur"].sum())
        frames = int(total_dur * self.hp["audio_sample_rate"] / self.hp["hop_size"] * 1.2) + 64
        return min(max(frames, 64), int(self.hp.get("max_frames", 8000)))

    def forward_model(self, item, noise=None, source=None,
                      seed: Optional[int] = None) -> np.ndarray:
        """One item to a waveform; ``noise`` and ``source`` fix the draws as
        in ``FusedSynthesizer.__call__`` (unfused: the sampler's noise at the
        item's own ``t_mel``, and the NSF source draws of the trimmed mel);
        a generator seeded with ``seed`` (default ``hp['seed']``) draws the
        rest."""
        batch, t_mel = self.input_to_batch(item), self.estimate_t_mel(item)
        if self.fused is not None:
            return self.fused(batch, t_mel, noise=noise, seed=seed, source=source)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.hp.get("seed", 1234) if seed is None else seed))
        with torch.no_grad():
            out = self.task.inference(batch, t_mel=t_mel, use_gt_dur=False, use_gt_f0=False,
                                      noise=None if noise is None else _as_noise(noise),
                                      generator=gen)
        mel = out["mel_out"][0].float().cpu().numpy()
        n = int((out["mel2ph"][0] > 0).sum()) or mel.shape[0]
        mel = mel[:n]
        f0 = self.extract_f0(out, mel)
        kw = {"source": source} if isinstance(self.vocoder, HifiGAN) else {}
        return self.vocoder.spec2wav(mel, f0=f0, generator=gen, **kw)

    def extract_f0(self, out: Dict[str, Any], mel: np.ndarray) -> Optional[np.ndarray]:
        """The F0 [T] (Hz) that drives an NSF vocoder on the unfused path."""
        raise NotImplementedError

    def infer_once(self, inp: Dict[str, str], **kw) -> np.ndarray:
        item = self.preprocess_input(inp, inp.get("input_type", "word"))
        if item is None:
            raise ValueError("the input's phonemes, notes and durations do not line up")
        return self.forward_model(item, **kw)

    @classmethod
    def example_run(cls, hp: Dict[str, Any], inp: Dict[str, str],
                    out_fn: str = "infer_out/example_out.wav", device="cuda") -> str:
        """Build the model from the run's files, sing ``inp`` and write the
        waveform to ``out_fn``."""
        wav = cls(hp, device=device).infer_once(inp)
        os.makedirs(os.path.dirname(out_fn) or ".", exist_ok=True)
        save_wav(wav, out_fn, hp["audio_sample_rate"])
        return out_fn


def _f0_denorm(out: Dict[str, Any], mel: np.ndarray) -> Optional[np.ndarray]:
    if out.get("f0_denorm") is None:
        return None
    return out["f0_denorm"][0, : mel.shape[0]].float().cpu().numpy()


class DiffSingerE2EInfer(BaseSVSInfer):
    """e2e: F0 re-extracted from the generated mel by the PitchExtractor (the
    model's own ``f0_denorm`` when no PitchExtractor is given)."""

    def extract_f0(self, out, mel):
        if self.pe is not None:
            return self.pe.predict(mel)
        return _f0_denorm(out, mel)


class DiffSingerCascadeInfer(BaseSVSInfer):
    """cascade: F0 from the model's pitch predictor, even when a
    PitchExtractor is given."""

    uses_pe = False

    def extract_f0(self, out, mel):
        return _f0_denorm(out, mel)


# phoneme-level example in the opencpop transcription format (a slur on the
# second word: the final 'iu' repeats on a new note with is_slur=1)
EXAMPLE_INPUT = {
    "text": "小酒窝",
    "ph_seq": "SP x iao j iu iu w o AP",
    "note_seq": "rest C#4/Db4 C#4/Db4 F#4/Gb4 F#4/Gb4 G#4/Ab4 A#4/Bb4 A#4/Bb4 rest",
    "note_dur_seq": "0.25 0.41 0.41 0.38 0.38 0.24 0.51 0.51 0.25",
    "is_slur_seq": "0 0 0 0 0 1 0 0 0",
    "input_type": "phoneme",
}
