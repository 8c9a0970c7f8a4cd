"""The port's text processors and Chinese number normaliser against the JAX
package's (diffsinger_tpu/data/text/processors.py, text_norm.py): equal
outputs on a set of English sentences and Chinese non-standard words; ``zh``
and ``zh_g2pM`` raise ``ImportError`` where their packages do not import."""

import sys

import pytest

from diffsinger_tpu.data.text import processors as jproc
from diffsinger_tpu.data.text import text_norm as jnorm
from diffsinger_tpu_torch.data.text import processors as tproc
from diffsinger_tpu_torch.data.text import text_norm as tnorm

EN = [
    "Printing, in the only sense with which we are at present concerned, differs from most "
    "if not from all the arts and crafts represented in the Exhibition.",
    "\"Don't\" -- she said -- (quietly); it's 3 o'clock!!",
    "  Hello   world?? ... yes:no; maybe!  ",
    "ABC-def ghi's \"quoted\" [bracketed] {curly} 42",
    "",
]
ZH = ["2021-03-15的12:30，价格¥12.5元，增长了12.5%和30%，3/4的人打了13812345678。",
      "1000000003个，第10名，0.05和1001，2021年",
      "零点一二三：一！二？【三】（四）％５"]


@pytest.mark.parametrize("text", EN)
def test_en_processor_matches_jax(text):
    assert tproc.EnProcessor.preprocess_text(text) == jproc.EnProcessor.preprocess_text(text)
    got = tproc.get_txt_processor("en").process(text, {})
    assert got == jproc.get_txt_processor("en").process(text, {})
    phs, txt = got
    assert phs[0] == phs[-1] == "|"
    assert tproc.EnProcessor.sp_phonemes() == ["|"]


@pytest.mark.parametrize("text", ZH)
@pytest.mark.parametrize("remove_punc", [False, True])
def test_nsw_normalizer_matches_jax(text, remove_punc):
    got = tnorm.NSWNormalizer(text).normalize(remove_punc=remove_punc)
    assert got == jnorm.NSWNormalizer(text).normalize(remove_punc=remove_punc)
    assert not any(c.isdigit() for c in got if c.isascii())


@pytest.mark.parametrize("n", [0, 7, 10, 15, 20, 101, 1010, 10000, 100010, 123456789,
                               10 ** 12 + 5])
def test_number_readings_match_jax(n):
    assert tnorm.number_to_hanzi(n) == jnorm.number_to_hanzi(n)


def test_zh_preprocess_matches_jax_and_needs_pypinyin(monkeypatch):
    for text in ZH:
        assert tproc.ZhProcessor.preprocess_text(text) == jproc.ZhProcessor.preprocess_text(text)
    monkeypatch.setitem(sys.modules, "pypinyin", None)
    with pytest.raises(ImportError, match="pypinyin"):
        tproc.get_txt_processor("zh").process("你好", {})
    with pytest.raises(ImportError, match="g2pM"):
        tproc.get_txt_processor("zh_g2pM").process("你好", {})
    assert tproc.get_txt_processor("zh_g2pM").sp_phonemes() == ["|", "#"]
    with pytest.raises(KeyError):
        tproc.get_txt_processor("fr")
    assert set(tproc.REGISTERED_PROCESSORS) == set(jproc.REGISTERED_PROCESSORS)
