"""Text -> phoneme processors (counterpart of diffsinger_tpu/data/text/processors.py).

  * ``en``: text normalisation, then ARPAbet phonemes from ``g2p_en`` when it
    imports, else a deterministic fallback of one pseudo-phone per letter;
    ``|`` separates words.
  * ``zh`` / ``zh_g2pM``: shengmu / yunmu (with tones) from ``pypinyin`` (and
    ``g2pM`` + ``jieba``), which raise ``ImportError`` when absent; the
    pinyin segmentation is the port's own ``data/text/pinyin.py``.
Host code only.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from diffsinger_tpu_torch.data.text.pinyin import split_pinyin

PUNCS = '!,.?;:'

REGISTERED_PROCESSORS = {}


def register_processor(name):
    def deco(cls):
        REGISTERED_PROCESSORS[name] = cls
        return cls
    return deco


def get_txt_processor(name: str):
    if name not in REGISTERED_PROCESSORS:
        raise KeyError(f"unknown txt_processor {name}")
    return REGISTERED_PROCESSORS[name]


class BaseTxtProcessor:
    @staticmethod
    def sp_phonemes() -> List[str]:
        return ["|"]

    @classmethod
    def process(cls, txt: str, pre_align_args: dict) -> Tuple[List[str], str]:
        raise NotImplementedError


@register_processor("en")
class EnProcessor(BaseTxtProcessor):
    """English: normalised text, g2p_en ARPAbet phonemes, '|' between words."""

    @staticmethod
    def preprocess_text(text: str) -> str:
        text = text.lower()
        text = re.sub("[\'\"()]+", "", text)
        text = re.sub("[-]+", " ", text)
        text = re.sub(f"[^ a-z{PUNCS}]", "", text)
        text = re.sub(f"([{PUNCS}])+", r"\1", text)
        text = re.sub(f"([{PUNCS}])", r" \1 ", text)
        text = re.sub(r"\s+", " ", text).strip()
        return text

    @classmethod
    def process(cls, txt, pre_align_args):
        txt = cls.preprocess_text(txt)
        try:
            from g2p_en import G2p

            g2p = G2p()
            phs = g2p(txt)
            phs = [p.strip() for p in phs]
            out = ["|"]
            for p in phs:
                if p == " ":
                    if out[-1] != "|":
                        out.append("|")
                elif p:
                    out.append(p)
            if out[-1] != "|":
                out.append("|")
            return out, txt
        except ImportError:
            # grapheme fallback: one pseudo-phone per letter, '|' between words
            out = ["|"]
            for word in txt.split(" "):
                if not word:
                    continue
                if word in PUNCS:
                    out.append(word)
                else:
                    out.extend(list(word))
                out.append("|")
            return out, txt


@register_processor("zh")
class ZhProcessor(BaseTxtProcessor):
    """Chinese: shengmu, then yunmu with its tone (5: neutral)."""

    _TABLE = {ord(f): ord(t) for f, t in zip(
        "：，。！？【】（）％＃＠＆１２３４５６７８９０",
        ":,.!?[]()%#@&1234567890")}

    @classmethod
    def preprocess_text(cls, text: str) -> str:
        from diffsinger_tpu_torch.data.text.text_norm import NSWNormalizer

        text = text.translate(cls._TABLE)
        text = NSWNormalizer(text).normalize(remove_punc=False)
        text = re.sub("[\'\"()]+", "", text)
        text = re.sub("[-]+", " ", text)
        text = re.sub(f"[^ A-Za-z一-鿿{PUNCS}]", "", text)
        text = re.sub(f"([{PUNCS}])+", r"\1", text)
        text = re.sub(f"([{PUNCS}])", r" \1 ", text)
        text = re.sub(r"\s+", "", text)
        return text

    @classmethod
    def process(cls, txt, pre_align_args):
        txt = cls.preprocess_text(txt)
        try:
            from pypinyin import Style, pinyin
        except ImportError as e:
            raise ImportError(
                "zh text processing needs pypinyin; "
                "provide phoneme input directly or install pypinyin") from e
        shengmu = pinyin(txt, style=Style.INITIALS)
        yunmu_finals = pinyin(txt, style=Style.FINALS)
        yunmu_tone3 = pinyin(txt, style=Style.FINALS_TONE3)
        use_tone = pre_align_args.get("use_tone", True)
        yunmu = ([[t[0] + "5"] if t[0] == f[0] else t
                  for f, t in zip(yunmu_finals, yunmu_tone3)]
                 if use_tone else yunmu_finals)
        phs = ["|"]
        for a, b, c in zip(shengmu, yunmu, yunmu_finals):
            if a[0] == c[0]:
                phs += [a[0], "|"]
            else:
                phs += [a[0], b[0], "|"]
        return phs, txt


@register_processor("zh_g2pM")
class ZhG2pMProcessor(BaseTxtProcessor):
    """Chinese with g2pM's polyphone choice and jieba's word bounds ('#')."""

    @staticmethod
    def sp_phonemes():
        return ["|", "#"]

    @classmethod
    def process(cls, txt, pre_align_args):
        try:
            import jieba
            from g2pM import G2pM
            from pypinyin import Style, pinyin
        except ImportError as e:
            raise ImportError("zh_g2pM needs g2pM+jieba+pypinyin") from e
        model = G2pM()
        ph_list = model(txt, tone=pre_align_args.get("use_tone", True),
                        char_split=True)
        seg_list = "#".join(jieba.cut(txt))
        ph_list_ = []
        seg_idx = 0
        for p in ph_list:
            p = p.replace("u:", "v")
            if seg_list[seg_idx] == "#":
                ph_list_.append("#")
                seg_idx += 1
            else:
                ph_list_.append("|")
            seg_idx += 1
            if re.findall("[一-鿿]", p):
                style = Style.TONE3 if pre_align_args.get("use_tone", True) \
                    else Style.NORMAL
                p = pinyin(p, style=style, strict=True)[0][0]
                if style == Style.TONE3 and p[-1] not in "12345":
                    p = p + "5"
            parts = split_pinyin(re.sub(r"\d", "", p))
            tone = re.findall(r"\d", p)
            if len(parts) == 2:
                ph_list_ += [parts[0], parts[1] + (tone[0] if tone else "")]
            else:
                ph_list_.append(p)
        # strip word-bound markers adjacent to silences
        sils = list(PUNCS) + cls.sp_phonemes()
        out = []
        for i, p in enumerate(ph_list_):
            if p != "#" or (ph_list_[i - 1] not in sils
                            and i + 1 < len(ph_list_)
                            and ph_list_[i + 1] not in sils):
                out.append(p)
        return out, txt
