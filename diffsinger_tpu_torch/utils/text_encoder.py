"""Phoneme vocabulary encoder (the port's own copy of
diffsinger_tpu/utils/text_encoder.py).

Reserved ids ``<pad>=0, <EOS>=1, <UNK>=2`` come first; a space-separated
phoneme string encodes to int ids, unknown phonemes to ``replace_oov``'s id;
``sil_phonemes()`` are the tokens whose first character is not alphabetic.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional

RESERVED_TOKENS = ["<pad>", "<EOS>", "<UNK>"]


class TokenTextEncoder:
    """Maps phoneme tokens to integer ids after the fairseq-style reserved ones."""

    def __init__(self, vocab_list: Iterable[str], replace_oov: Optional[str] = None):
        tokens = [t for t in vocab_list if t not in RESERVED_TOKENS]
        self._token_to_id = {t: i for i, t in enumerate(RESERVED_TOKENS + tokens)}
        self._replace_oov = replace_oov

    @classmethod
    def from_file(cls, path: str, replace_oov: Optional[str] = None) -> "TokenTextEncoder":
        """A JSON list (``phone_set.json``) or a newline-separated vocab file."""
        with open(path) as f:
            if path.endswith(".json"):
                vocab = json.load(f)
            else:
                vocab = [line.strip() for line in f if line.strip()]
        return cls(vocab, replace_oov=replace_oov)

    def encode(self, s: str) -> List[int]:
        toks = s.strip().split()
        if self._replace_oov is not None:
            toks = [t if t in self._token_to_id else self._replace_oov for t in toks]
        return [self._token_to_id[t] for t in toks]

    def sil_phonemes(self) -> List[str]:
        return [t for t in self._token_to_id if t and not t[0].isalpha()]

    def __len__(self) -> int:
        return len(self._token_to_id)


def build_phone_encoder(data_dir: str) -> TokenTextEncoder:
    """``<data_dir>/phone_set.json``, unknown phonemes mapped to ``,``."""
    return TokenTextEncoder.from_file(os.path.join(data_dir, "phone_set.json"),
                                      replace_oov=",")
