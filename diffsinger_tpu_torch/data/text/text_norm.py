"""Chinese non-standard-word (NSW) normalisation: digits, dates, money ->
hanzi (counterpart of diffsinger_tpu/data/text/text_norm.py).

``NSWNormalizer`` reads cardinal numbers, decimals, percentages, fractions,
dates and times, money amounts and long digit strings (phone numbers) out
in hanzi, and optionally drops punctuation.
"""

from __future__ import annotations

import re

DIGITS = "零一二三四五六七八九"
UNITS = ["", "十", "百", "千"]
BIG_UNITS = ["", "万", "亿", "万亿"]


def digits_to_hanzi(s: str) -> str:
    """Digit-by-digit reading (phone numbers, IDs): 1 -> 幺 convention kept off,
    plain 零一二... used like modern TTS frontends."""
    return "".join(DIGITS[int(c)] if c.isdigit() else c for c in s)


def _four_digits(n: int) -> str:
    """0 <= n <= 9999 -> hanzi without leading-zero artifacts."""
    if n == 0:
        return ""
    out = []
    zero_pending = False
    for i, unit in enumerate(reversed(UNITS)):
        d = (n // (10 ** (3 - i))) % 10
        if d == 0:
            if out:
                zero_pending = True
            continue
        if zero_pending:
            out.append("零")
            zero_pending = False
        out.append(DIGITS[d] + UNITS[3 - i])
    return "".join(out)


def number_to_hanzi(n: int) -> str:
    """Cardinal reading of a non-negative integer."""
    if n == 0:
        return "零"
    chunks = []  # low to high, groups of 10^4
    while n > 0:
        chunks.append(n % 10000)
        n //= 10000
    s = ""
    for idx in range(len(chunks) - 1, -1, -1):
        chunk = chunks[idx]
        if chunk == 0:
            continue
        if s and chunk < 1000:
            s += "零"
        s += _four_digits(chunk) + BIG_UNITS[idx]
    # 一十X -> 十X at the very front (10..19)
    if s.startswith("一十"):
        s = s[1:]
    return s


def decimal_to_hanzi(s: str) -> str:
    int_part, frac = s.split(".")
    return number_to_hanzi(int(int_part)) + "点" + digits_to_hanzi(frac)


class NSWNormalizer:
    def __init__(self, raw_text: str):
        self.raw_text = raw_text

    def normalize(self, remove_punc: bool = True) -> str:
        t = self.raw_text
        # dates: 2021年/3月/15日 stay; 2021-03-15 or 2021/3/15 -> 年/月/日
        t = re.sub(r"(\d{4})[-/](\d{1,2})[-/](\d{1,2})",
                   lambda m: (digits_to_hanzi(m.group(1)) + "年"
                              + number_to_hanzi(int(m.group(2))) + "月"
                              + number_to_hanzi(int(m.group(3))) + "日"), t)
        t = re.sub(r"(\d{4})年",
                   lambda m: digits_to_hanzi(m.group(1)) + "年", t)
        # time 12:30 -> 十二点三十分
        t = re.sub(r"(\d{1,2}):(\d{2})",
                   lambda m: (number_to_hanzi(int(m.group(1))) + "点"
                              + number_to_hanzi(int(m.group(2))) + "分"), t)
        # percent 12.5% / 30%
        t = re.sub(r"(\d+\.\d+)%",
                   lambda m: "百分之" + decimal_to_hanzi(m.group(1)), t)
        t = re.sub(r"(\d+)%",
                   lambda m: "百分之" + number_to_hanzi(int(m.group(1))), t)
        # fraction 3/4 -> 四分之三
        t = re.sub(r"(\d+)/(\d+)",
                   lambda m: (number_to_hanzi(int(m.group(2))) + "分之"
                              + number_to_hanzi(int(m.group(1)))), t)
        # money ¥12 / 12元
        t = re.sub(r"[¥￥](\d+\.\d+)", lambda m: decimal_to_hanzi(m.group(1)) + "元", t)
        t = re.sub(r"[¥￥](\d+)", lambda m: number_to_hanzi(int(m.group(1))) + "元", t)
        # long digit strings (>= 8 digits: phone-like) read digit by digit
        t = re.sub(r"\d{8,}", lambda m: digits_to_hanzi(m.group(0)), t)
        # decimals then plain cardinals
        t = re.sub(r"\d+\.\d+", lambda m: decimal_to_hanzi(m.group(0)), t)
        t = re.sub(r"\d+", lambda m: number_to_hanzi(int(m.group(0))), t)
        if remove_punc:
            t = re.sub(r"[^\w一-鿿]+", "", t)
        return t
