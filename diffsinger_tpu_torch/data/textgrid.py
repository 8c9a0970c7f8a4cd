"""TextGrid parsing + phoneme alignment -> frame-level mel2ph (the port's own
copy of diffsinger_tpu/data/textgrid.py).

Behavioral parity: data_gen/tts/data_gen_utils.py:197-337 (TextGrid IntervalTier
parser, silence-interval merging, textgrid<->phoneme reconciliation, boundary ->
frame conversion with round(x*sr/hop + 0.5), scatter into mel2ph/dur).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np


def is_sil_phoneme(p: str) -> bool:
    return p == "" or not p[0].isalpha()


def parse_textgrid(text: str) -> List[Dict]:
    """Parse a (long-form) TextGrid; returns the items of the LAST IntervalTier
    as [{'xmin': float, 'xmax': float, 'text': str}]."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    tiers: List[List[Dict]] = []
    cur: List[Dict] = None  # type: ignore
    item: Dict = {}
    for ln in lines:
        if re.match(r"item \[\d+\]:?", ln):
            cur = []
            tiers.append(cur)
            continue
        m = re.match(r"intervals \[\d+\]:?", ln)
        if m is not None and cur is not None:
            item = {}
            cur.append(item)
            continue
        m = re.match(r"xmin = (.*)", ln)
        if m and cur is not None and cur:
            item["xmin"] = float(m.group(1))
            continue
        m = re.match(r"xmax = (.*)", ln)
        if m and cur is not None and cur:
            item["xmax"] = float(m.group(1))
            continue
        m = re.match(r'text = "(.*)"', ln)
        if m and cur is not None and cur:
            item["text"] = m.group(1)
    if not tiers:
        raise ValueError("no IntervalTier found in TextGrid")
    return [it for it in tiers[-1] if "text" in it]


def merge_silences(intervals: List[Dict]) -> List[Dict]:
    """Normalize sil labels to '' and merge adjacent silences
    (reference data_gen_utils.py:285-296)."""
    out: List[Dict] = []
    for x in intervals:
        x = dict(x)
        if x["text"] in ("sil", "sp", "", "SIL", "PUNC"):
            x["text"] = ""
            if out and out[-1]["text"] == "":
                out[-1]["xmax"] = x["xmax"]
                continue
        out.append(x)
    return out


def mel2ph_from_textgrid(tg_text: str, ph: str, n_frames: int, sample_rate: int,
                         hop_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Align TextGrid intervals with the phoneme string and rasterize to frames
    (reference get_mel2ph, data_gen_utils.py:274-337)."""
    ph_list = ph.split(" ")
    tg_align = merge_silences(parse_textgrid(tg_text))
    tg_len = len([x for x in tg_align if x["text"] != ""])
    ph_len = len([x for x in ph_list if not is_sil_phoneme(x)])
    assert tg_len == ph_len, (tg_len, ph_len, [x["text"] for x in tg_align], ph_list)

    split = np.full(len(ph_list) + 1, -1.0)
    tg_idx = 0
    ph_idx = 0
    while tg_idx < len(tg_align) or ph_idx < len(ph_list):
        if tg_idx == len(tg_align) and is_sil_phoneme(ph_list[ph_idx]):
            split[ph_idx] = 1e8
            ph_idx += 1
            continue
        x = tg_align[tg_idx]
        if x["text"] == "" and ph_idx == len(ph_list):
            tg_idx += 1
            continue
        assert ph_idx < len(ph_list)
        p = ph_list[ph_idx]
        if x["text"] == "" and not is_sil_phoneme(p):
            raise AssertionError((ph_list, [t["text"] for t in tg_align]))
        if x["text"] != "" and is_sil_phoneme(p):
            ph_idx += 1
        else:
            assert (x["text"] == "" and is_sil_phoneme(p)) \
                or x["text"].lower() == p.lower() or x["text"].lower() == "sil", \
                (x["text"], p)
            split[ph_idx] = x["xmin"]
            if ph_idx > 0 and split[ph_idx - 1] == -1 and is_sil_phoneme(
                    ph_list[ph_idx - 1]):
                split[ph_idx - 1] = split[ph_idx]
            ph_idx += 1
            tg_idx += 1
    assert tg_idx == len(tg_align), (tg_idx, [x["text"] for x in tg_align])
    assert ph_idx >= len(ph_list) - 1

    mel2ph = np.zeros(n_frames, np.int64)
    split[0] = 0
    split[-1] = 1e8
    for i in range(len(split) - 1):
        assert split[i] != -1 and split[i] <= split[i + 1], (split,)
    frames = [int(s * sample_rate / hop_size + 0.5) for s in split]
    for i in range(len(ph_list)):
        mel2ph[frames[i]: frames[i + 1]] = i + 1
    dur = np.bincount(mel2ph, minlength=len(ph_list) + 1)[1:]
    return mel2ph, dur


def mel2ph_from_durs(ph_durs: List[float], n_frames: int, sample_rate: int,
                     hop_size: int) -> np.ndarray:
    """Second-domain phone durations -> mel2ph (reference
    data_gen/singing/binarize.py:241-255)."""
    mel2ph = np.zeros(n_frames, np.int64)
    start = 0.0
    for i, d in enumerate(ph_durs):
        a = int(start * sample_rate / hop_size + 0.5)
        b = int((start + d) * sample_rate / hop_size + 0.5)
        mel2ph[a:b] = i + 1
        start += d
    return mel2ph
