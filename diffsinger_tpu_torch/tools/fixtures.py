"""Synthetic corpora and checkpoints in the upstream layouts, for smoke runs
and tests where the released data and weights are not at hand.

  * ``write_lj_corpus``: an LJSpeech-style raw corpus (``wavs/*.wav`` at
    22.05 kHz, ``metadata_phone.csv``, ``dict.txt`` and one
    ``mfa_outputs/<item>.TextGrid`` per utterance) of harmonic tones: a few
    harmonics with vibrato for voiced phones, soft noise for unvoiced ones,
    silences at the ends and now and then between words, over a noise floor;
  * ``write_task_ckpt``: a ``model_ckpt_steps_<step>.ckpt`` whose state_dict
    is flat with the ``model.`` prefix (upstream's released checkpoints);
  * ``write_hifigan_dir``: a vocoder directory (``config.yaml`` with the
    generator's geometry, ``model_ckpt_steps_<step>.ckpt`` with the generator
    under ``model_gen`` and its convolutions in weight-norm form);
  * ``write_pwg_dir``: a ParallelWaveGAN directory in upstream's layout or
    the official releases' (``checkpoint-<step>steps.pkl`` + ``stats.npy``);
  * ``weight_norm_split``: the inverse of ``fold_weight_norm``.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

VOICED = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY", "OW", "OY",
          "UH", "UW", "B", "D", "G", "L", "M", "N", "NG", "R", "V", "W", "Y", "Z", "DH"]
UNVOICED = ["CH", "F", "HH", "K", "P", "S", "SH", "T", "TH"]
WORD_SEP = "|"   # the word boundary: a silence phone (first character not a letter)


def _textgrid(intervals: List[tuple]) -> str:
    """A long-form TextGrid with one IntervalTier 'phones'."""
    xmax = intervals[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0", f"xmax = {xmax}", "tiers? <exists>", "size = 1", "item []:",
             "    item [1]:", '        class = "IntervalTier"', '        name = "phones"',
             "        xmin = 0", f"        xmax = {xmax}",
             f"        intervals: size = {len(intervals)}"]
    for i, (a, b, text) in enumerate(intervals, 1):
        lines += [f"        intervals [{i}]:", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{text}"']
    return "\n".join(lines) + "\n"


def _phone_audio(rng, phone: str, n: int, sr: int, f0: float, phase: float):
    """(samples, end phase) of one phone lasting n samples."""
    if phone in UNVOICED:
        return (rng.randn(n) * 0.01).astype(np.float32), phase
    t = np.arange(n) / sr
    inst = f0 * (1.0 + 0.03 * np.sin(2 * np.pi * 5.0 * t + rng.uniform(0, 6.28)))
    ph = phase + 2 * np.pi * np.cumsum(inst) / sr
    # a vowel-like spectrum: phone-dependent weights of harmonics 1-5
    weights = 0.5 ** np.arange(5) * (0.6 + 0.8 * np.random.RandomState(
        sum(map(ord, phone))).rand(5))
    y = sum(w * np.sin((k + 1) * ph) for k, w in enumerate(weights))
    ramp = np.minimum(1.0, np.minimum(np.arange(n), np.arange(n)[::-1]) / 64.0 + 0.2)
    return (0.25 * y * ramp).astype(np.float32), float(ph[-1]) if n else phase


def write_lj_corpus(raw_dir: str, processed_dir: str, n_items: int, seed: int = 0,
                    sample_rate: int = 22050, hop_size: int = 256,
                    seconds=(2.0, 6.0), phone_frames=(3, 12)) -> List[str]:
    """Write the corpus; returns the item names (LJ-style, sorted)."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(raw_dir, "wavs"), exist_ok=True)
    os.makedirs(os.path.join(processed_dir, "mfa_outputs"), exist_ok=True)
    frame_s = hop_size / sample_rate
    names, rows = [], []
    for i in range(n_items):
        name = f"LJ{1 + i // 100:03d}-{i % 100 + 1:04d}"
        target = int(rng.uniform(*seconds) / frame_s)
        f0 = rng.uniform(110.0, 220.0)
        # (phone, frames); leading and trailing silences are the separators
        segs: List[tuple] = [(WORD_SEP, int(rng.randint(5, 12)))]
        used = segs[0][1]
        while used < target - 30:
            for _ in range(rng.randint(2, 6)):
                p = (VOICED[rng.randint(len(VOICED))] if rng.rand() < 0.9
                     else UNVOICED[rng.randint(len(UNVOICED))])
                d = int(rng.randint(phone_frames[0], phone_frames[1] + 1))
                segs.append((p, d))
                used += d
            pause = int(rng.randint(4, 10)) if rng.rand() < 0.2 else 0
            segs.append((WORD_SEP, pause))
            used += pause
        segs[-1] = (WORD_SEP, int(rng.randint(6, 12)))
        total_frames = sum(d for _, d in segs)
        wav, phase, pos = [], 0.0, 0
        intervals = []
        for p, d in segs:
            n = d * hop_size
            if p == WORD_SEP:
                wav.append(np.zeros(n, np.float32))
                if d:
                    intervals.append((pos * frame_s, (pos + d) * frame_s, ""))
            else:
                y, phase = _phone_audio(rng, p, n, sample_rate, f0, phase)
                wav.append(y)
                intervals.append((pos * frame_s, (pos + d) * frame_s, p))
            pos += d
        assert pos == total_frames
        # a broadband floor 40 dB under the tones, as a recording has: without
        # it the mel bins above the 5th harmonic hold only FFT rounding noise
        wav = np.concatenate(wav) + (rng.randn(total_frames * hop_size) * 0.003
                                     ).astype(np.float32)
        wavfile.write(os.path.join(raw_dir, "wavs", f"{name}.wav"), sample_rate,
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        with open(os.path.join(processed_dir, "mfa_outputs", f"{name}.TextGrid"), "w") as f:
            f.write(_textgrid(intervals))
        ph = " ".join(p for p, _ in segs)
        rows.append({"item_name": name, "spk": "SPK1", "wav_fn": f"wavs/{name}.wav",
                     "txt": " ".join(p.lower() for p, _ in segs if p != WORD_SEP),
                     "ph": ph})
        names.append(name)
    with open(os.path.join(processed_dir, "metadata_phone.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["item_name", "spk", "wav_fn", "txt", "ph"])
        w.writeheader()
        w.writerows(rows)
    with open(os.path.join(processed_dir, "dict.txt"), "w") as f:
        for p in sorted(VOICED + UNVOICED + [WORD_SEP]):
            f.write(f"{p} {p}\n")
    return sorted(names)


def write_task_ckpt(path_dir: str, state_dict: Dict[str, torch.Tensor], step: int = 0,
                    prefix: str = "model.") -> str:
    """``model_ckpt_steps_<step>.ckpt`` with a flat ``state_dict`` of
    ``prefix + key``, as upstream's released task checkpoints hold them."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"model_ckpt_steps_{step}.ckpt")
    torch.save({"state_dict": {prefix + k: v.detach().cpu() for k, v in state_dict.items()},
                "global_step": step}, path)
    return path


def weight_norm_split(sd: Dict[str, torch.Tensor],
                      skip: Iterable[str] = ("noise_convs", "m_source")
                      ) -> Dict[str, torch.Tensor]:
    """Every 3-d ``<name>.weight`` -> ``weight_g`` (its norm over all dims
    but 0) and ``weight_v`` (the weight), except under ``skip`` prefixes."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.dim() == 3 and not k.startswith(tuple(skip)):
            base = k[: -len(".weight")]
            out[base + ".weight_g"] = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
            out[base + ".weight_v"] = v.clone()
        else:
            out[k] = v
    return out


def write_hifigan_dir(path_dir: str, generator_sd: Dict[str, torch.Tensor],
                      geometry: Dict[str, Any], step: int = 1000,
                      extra_config: Optional[Dict[str, Any]] = None) -> str:
    """A vocoder directory in upstream's layout: ``config.yaml`` and the
    generator (weight-norm form) under ``state_dict.model_gen``."""
    import yaml

    os.makedirs(path_dir, exist_ok=True)
    with open(os.path.join(path_dir, "config.yaml"), "w") as f:
        yaml.safe_dump({**geometry, **(extra_config or {})}, f)
    sd = weight_norm_split({k: v.detach().cpu() for k, v in generator_sd.items()})
    path = os.path.join(path_dir, f"model_ckpt_steps_{step}.ckpt")
    torch.save({"state_dict": {"model_gen": sd}, "global_step": step}, path)
    return path


def write_pwg_dir(path_dir: str, generator_sd: Dict[str, torch.Tensor],
                  generator_params: Dict[str, Any], official: bool = False, step: int = 1000,
                  stats: Optional[np.ndarray] = None) -> str:
    """A ParallelWaveGAN directory: ``config.yaml`` (``generator_params``)
    and the generator in weight-norm form, under ``state_dict.model_gen`` of
    ``model_ckpt_steps_<step>.ckpt`` (upstream's layout) or, ``official``,
    under ``model.generator`` of ``checkpoint-<step>steps.pkl`` (the
    ParallelWaveGAN releases'), with ``stats`` [2, M] (mel mean and scale)
    as ``stats.npy`` when given."""
    import yaml

    os.makedirs(path_dir, exist_ok=True)
    with open(os.path.join(path_dir, "config.yaml"), "w") as f:
        yaml.safe_dump({"generator_params": generator_params, "format": "npy"}, f)
    sd = weight_norm_split({k: v.detach().cpu() for k, v in generator_sd.items()}, skip=())
    if official:
        path = os.path.join(path_dir, f"checkpoint-{step}steps.pkl")
        torch.save({"model": {"generator": sd}, "steps": step}, path)
    else:
        path = os.path.join(path_dir, f"model_ckpt_steps_{step}.ckpt")
        torch.save({"state_dict": {"model_gen": sd}, "global_step": step}, path)
    if stats is not None:
        np.save(os.path.join(path_dir, "stats.npy"), np.asarray(stats, np.float32))
    return path
