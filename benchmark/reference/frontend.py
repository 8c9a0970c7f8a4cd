"""What the program derives from a request before the model runs, worked out
again: Opencpop's phone ids, note names to MIDI numbers, the mel length the
singing entry sizes a phrase to, and the serving buckets."""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np

# the Opencpop models' 60-phone vocabulary, after the reserved <pad>, <EOS>, <UNK>
CPOP_PHONES = [
    "AP", "SP", "a", "ai", "an", "ang", "ao", "b", "c", "ch", "d", "e", "ei",
    "en", "eng", "er", "f", "g", "h", "i", "ia", "ian", "iang", "iao", "ie",
    "in", "ing", "iong", "iu", "j", "k", "l", "m", "n", "o", "ong", "ou", "p",
    "q", "r", "s", "sh", "t", "u", "ua", "uai", "uan", "uang", "ui", "un",
    "uo", "v", "van", "ve", "vn", "w", "x", "y", "z", "zh"]
RESERVED = 3
_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def round_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def note_to_midi(note: str) -> int:
    """'C#4' -> 61; 'rest' -> 0."""
    if note == "rest":
        return 0
    m = re.match(r"([A-G])([#b]*)(-?\d+)$", note.split("/")[0])
    if not m:
        raise ValueError(f"bad note {note!r}")
    pitch = _OFFSETS[m.group(1)] + sum(1 if a == "#" else -1 for a in m.group(2))
    return 12 * (int(m.group(3)) + 1) + pitch


def phoneme_batch(inp: Dict[str, str]) -> Dict[str, np.ndarray]:
    """A phoneme-level singing input -> the model's one-row batch."""
    ids = [CPOP_PHONES.index(p) + RESERVED for p in inp["ph_seq"].split()]
    return {"txt_tokens": np.asarray([ids], np.int64),
            "pitch_midi": np.asarray([[note_to_midi(n) for n in inp["note_seq"].split()]],
                                     np.int64),
            "midi_dur": np.asarray([[float(d) for d in inp["note_dur_seq"].split()]],
                                   np.float32),
            "is_slur": np.asarray([[int(s) for s in inp["is_slur_seq"].split()]], np.int64)}


def singing_t_mel(hp: Dict[str, Any], midi_dur: np.ndarray) -> int:
    """The frames the singing entry gives a phrase: its notes' length with 20%
    and 64 frames of headroom, within [64, max_frames]."""
    frames = int(float(midi_dur.sum()) * hp["audio_sample_rate"] / hp["hop_size"] * 1.2) + 64
    return min(max(frames, 64), int(hp.get("max_frames", 8000)))


def pad_batch(rows: List[Dict[str, np.ndarray]], txt_mult: int, b_pad: int) -> Dict[str, np.ndarray]:
    """One-row batches -> one batch: token keys zero-padded to a multiple of
    ``txt_mult``, rows padded to ``b_pad`` by repeating the first."""
    t_txt = round_up(max(r["txt_tokens"].shape[1] for r in rows), txt_mult)
    out = {}
    for k in rows[0]:
        a = np.concatenate([np.pad(r[k], ((0, 0), (0, t_txt - r[k].shape[1]))) for r in rows])
        out[k] = np.concatenate([a] + [a[:1]] * (b_pad - a.shape[0]))
    return out


def plan(t_mels: List[int], mel_mult: int, max_b: int) -> List[tuple]:
    """The serving batcher's device batches: requests grouped by their mel
    bucket (ascending), chunks of at most ``max_b`` in input order, each
    padded to a power-of-two row count: (t_mel bucket, [request index], rows)."""
    groups: Dict[int, List[int]] = {}
    for i, t in enumerate(t_mels):
        groups.setdefault(round_up(t, mel_mult), []).append(i)
    out = []
    for t_b in sorted(groups):
        idx = groups[t_b]
        for s in range(0, len(idx), max_b):
            chunk = idx[s:s + max_b]
            rows = 1
            while rows < len(chunk):
                rows *= 2
            out.append((t_b, chunk, min(rows, max_b)))
    return out
