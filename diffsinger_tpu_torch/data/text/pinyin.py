"""Mandarin pinyin phonology: initial/final segmentation (the port's own
copy of diffsinger_tpu/data/text/pinyin.py).

The syllable -> phones map is generated from the segmentation rules (the
opencpop 61-phone set), not shipped as a table.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

ALL_SHENGMU = ['zh', 'ch', 'sh', 'b', 'p', 'm', 'f', 'd', 't', 'n', 'l', 'g',
               'k', 'h', 'j', 'q', 'x', 'r', 'z', 'c', 's', 'y', 'w']
ALL_YUNMU = ['a', 'ai', 'an', 'ang', 'ao', 'e', 'ei', 'en', 'eng', 'er', 'i',
             'ia', 'ian', 'iang', 'iao', 'ie', 'in', 'ing', 'iong', 'iu', 'ng',
             'o', 'ong', 'ou', 'u', 'ua', 'uai', 'uan', 'uang', 'ui', 'un',
             'uo', 'v', 'van', 've', 'vn']

# j/q/x/y never precede back [u]; written u after them is the front rounded
# vowel, spelled v in this phone set (ju -> j v, yuan -> y van, ...)
_U_TO_V = {"u": "v", "ue": "ve", "uan": "van", "un": "vn", "u:": "v"}
_U_TO_V_INITIALS = {"j", "q", "x", "y"}


def split_pinyin(syllable: str) -> List[str]:
    """Segment one toneless pinyin syllable into [shengmu, yunmu] (or [yunmu]).

    Matches the opencpop table semantics: longest shengmu prefix; special forms
    'ng' -> ['n', 'g'], bare 'm'/'n'/'er' stay whole; u->v after j/q/x/y.
    """
    s = syllable.strip().lower()
    if s in ("m", "n", "er"):
        return [s]
    if s == "ng":
        return ["n", "g"]
    if s == "hm":  # interjection
        return ["h", "m"]
    for sm in sorted(ALL_SHENGMU, key=len, reverse=True):
        if s.startswith(sm) and len(s) > len(sm):
            rest = s[len(sm):]
            if sm in _U_TO_V_INITIALS:
                rest = _U_TO_V.get(rest, rest)
            return [sm, rest]
    return [s]


def build_pinyin2ph_map() -> Dict[str, str]:
    """Full syllable->phones map covering every standard pinyin syllable
    (capability parity with cpop_pinyin2ph_func, reference
    inference/svs/opencpop/map.py:1-8)."""
    syllables = set()
    # enumerate valid combinations: bare finals + initial x final
    for ym in ALL_YUNMU:
        syllables.add(ym)
    for sm in ALL_SHENGMU:
        for ym in ALL_YUNMU:
            syl = sm + ym
            # undo the v-spelling for the written form after j/q/x/y
            if sm in _U_TO_V_INITIALS:
                inv = {v: k for k, v in _U_TO_V.items()}
                if ym in inv:
                    syl = sm + inv[ym]
                elif ym.startswith("v"):
                    syl = sm + "u" + ym[1:]
            syllables.add(syl)
    syllables.update(["m", "n", "ng", "er", "hm"])
    out = {s: " ".join(split_pinyin(s)) for s in sorted(syllables)}
    # breath/silence pseudo-syllables, seeded exactly like the reference map
    # (inference/svs/opencpop/map.py:3) so word-level input with AP/SP marks
    # ('你 说 你 不 SP 懂 ... AP') keeps its note alignment
    out.update({"AP": "AP", "SP": "SP"})
    return out
