"""FFT (feed-forward transformer) encoder/decoder stacks (counterpart of
diffsinger_tpu/models/fft_blocks.py).

Padding positions are hard-zeroed after every layer and after the final norm;
the encoder embedding is sqrt(d) * token_embed (plus the MIDI extras), then
(unless ``use_pos_embed`` is off) sinusoidal positions added or, with
``rel_pos``, ESPnet's relative encoding. The decoder always adds its
positions. ``ffn_padding`` (SAME or LEFT) and ``dtype`` (bfloat16 for
``fs2_compute_dtype``) reach every layer's attention and conv FFN;
``norm='bn'`` puts ``BatchNorm1dTBC`` in place of every layer norm and the
last one (in training mode when ``drop_gen`` is given).
Dropout (training mode, masks from ``drop_gen``) follows the JAX places: the
encoder's embedding, the decoder's positional embedding, and inside every
layer.
Upstream key layout: ``encoder.embed_tokens``, ``encoder.layers.<i>.op.*``,
``encoder.layer_norm``, ``decoder.layers.<i>.op.*``, ``decoder.layer_norm``,
``decoder.pos_embed_alpha``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.common import (Embedding, RelPositionalEncoding,
                                                SinusoidalPositionalEmbedding,
                                                TransformerEncoderLayer, make_norm,
                                                apply_norm, dropout)


class FFTBlocks(nn.Module):
    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, use_pos_embed: bool = True,
                 ffn_act: str = "gelu", dropout: float = 0.0, ffn_padding: str = "SAME",
                 dtype: Optional[torch.dtype] = None, norm: str = "ln"):
        super().__init__()
        self.use_pos_embed = use_pos_embed
        self.dropout = dropout
        if use_pos_embed:
            self.pos_embed_alpha = nn.Parameter(torch.ones(1))
            self.embed_positions = SinusoidalPositionalEmbedding(hidden_size)
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(hidden_size, num_heads, ffn_kernel_size, ffn_act,
                                    dropout, ffn_padding, dtype, norm)
            for _ in range(num_layers)])
        self.layer_norm = make_norm(norm, hidden_size)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C]; padding_mask [B, T] True where PAD (all-zero feature
        rows when omitted)."""
        if padding_mask is None:
            padding_mask = x.abs().sum(-1) == 0
        nonpad = (~padding_mask).to(x.dtype)[:, :, None]
        if self.use_pos_embed:
            x = x + self.pos_embed_alpha * self.embed_positions(
                (~padding_mask).to(torch.long))
            x = dropout(x, self.dropout, drop_gen)
        x = x * nonpad
        for layer in self.layers:
            x = layer(x, padding_mask, drop_gen) * nonpad
        return apply_norm(self.layer_norm, x, drop_gen is not None) * nonpad


class FastSpeechEncoder(FFTBlocks):
    """Phoneme encoder: scaled token embedding (+ ``extra_embed``) +
    positions -> FFT blocks."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int,
                 ffn_kernel_size: int = 9, num_heads: int = 2,
                 ffn_act: str = "gelu", dropout: float = 0.0, rel_pos: bool = False,
                 use_pos_embed: bool = True, ffn_padding: str = "SAME",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(hidden_size, num_layers, ffn_kernel_size, num_heads,
                         use_pos_embed=False, ffn_act=ffn_act, dropout=dropout,
                         ffn_padding=ffn_padding, dtype=dtype)
        self.hidden_size = hidden_size
        self.rel_pos = rel_pos
        self.embed_pos = use_pos_embed  # the blocks' own use_pos_embed stays off
        self.embed_tokens = Embedding(vocab_size, hidden_size, padding_idx=0)
        self.embed_positions = (RelPositionalEncoding(hidden_size) if rel_pos
                                else SinusoidalPositionalEmbedding(hidden_size))

    def forward(self, txt_tokens: torch.Tensor, extra_embed: Optional[torch.Tensor] = None,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """txt_tokens [B, T]; extra_embed [B, T, C] (the MIDI embeddings) is
        added to the scaled token embedding before the positions."""
        padding_mask = txt_tokens == 0
        x = (self.hidden_size ** 0.5) * self.embed_tokens(txt_tokens)
        if extra_embed is not None:
            x = x + extra_embed
        if self.embed_pos and self.rel_pos:  # scales x by sqrt(d) a second time,
            x = self.embed_positions(x)        # as upstream does
        elif self.embed_pos:
            x = x + self.embed_positions(txt_tokens)
        x = dropout(x, self.dropout, drop_gen)
        return super().forward(x, padding_mask, drop_gen)


class FastSpeechDecoder(FFTBlocks):
    """Mel-frame FFT decoder."""

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, ffn_act: str = "gelu", dropout: float = 0.0,
                 ffn_padding: str = "SAME", dtype: Optional[torch.dtype] = None):
        super().__init__(hidden_size, num_layers, ffn_kernel_size, num_heads,
                         use_pos_embed=True, ffn_act=ffn_act, dropout=dropout,
                         ffn_padding=ffn_padding, dtype=dtype)
