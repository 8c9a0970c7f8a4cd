"""Variance predictors and length regulation (counterpart of
diffsinger_tpu/models/predictors.py: the duration and pitch heads,
``length_regulator``, ``mel2ph_to_dur`` and ``expand_by_mel2ph``).

Predictor layers keep the upstream ``conv.<i>.1`` (conv) / ``conv.<i>.3``
(LayerNorm) key layout of a torch ``Sequential(pad, conv, relu, norm,
dropout)``; the dropout draws its masks from ``drop_gen`` (None: eval). The
length regulator takes a static output length ``t_mel``. The ``crf``
duration head holds a linear-chain CRF (``dur_predictor.crf.*``, torchcrf's
names) and decodes its 32 emissions a phone by Viterbi.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.common import (SinusoidalPositionalEmbedding,
                                                conv1d_btc, dropout)
from diffsinger_tpu_torch.ops.crf import LinearChainCRF


class _ConvReluLN(nn.Sequential):
    """Conv1d -> ReLU -> LayerNorm(eps=1e-12) -> dropout, indexed like upstream."""

    def __init__(self, in_ch: int, channels: int, kernel_size: int, dropout: float = 0.0,
                 padding: str = "SAME"):
        super().__init__(nn.Identity(), nn.Conv1d(in_ch, channels, kernel_size),
                         nn.ReLU(), nn.LayerNorm(channels, eps=1e-12),
                         nn.Identity())
        if padding not in ("SAME", "LEFT"):
            raise ValueError(f"padding={padding}")
        k = kernel_size
        self.pad = ((k - 1) // 2, (k - 1) // 2) if padding == "SAME" else (k - 1, 0)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = conv1d_btc(x, self[1].weight, self[1].bias, *self.pad)
        return dropout(self[3](torch.relu(x)), self.dropout, drop_gen)


class DurationPredictor(nn.Module):
    """Duration head. ``dur_loss`` picks the output: ``mse`` and ``huber``
    regress log-durations (odim 1), ``mog`` has 15 outputs and no duration
    decoding (as in the JAX package and upstream), ``crf`` has 32 emissions
    (durations 0-31 frames) and a CRF whose Viterbi path is the duration."""

    ODIM = {"mse": 1, "huber": 1, "mog": 15, "crf": 32}

    def __init__(self, in_dims: int, channels: int, num_layers: int = 2,
                 kernel_size: int = 3, offset: float = 1.0, dropout: float = 0.0,
                 padding: str = "SAME", dur_loss: str = "mse"):
        super().__init__()
        if dur_loss not in self.ODIM:
            raise ValueError(f"dur_loss={dur_loss} is not one of {sorted(self.ODIM)}")
        self.offset = offset
        self.dur_loss = dur_loss
        self.conv = nn.ModuleList([
            _ConvReluLN(in_dims if i == 0 else channels, channels, kernel_size, dropout,
                        padding)
            for i in range(num_layers)])
        self.linear = nn.Linear(channels, self.ODIM[dur_loss])
        if dur_loss == "crf":
            self.crf = LinearChainCRF(self.ODIM[dur_loss])

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C] -> log-duration [B, T] (``mog``: [B, T, 15]; ``crf``:
        emissions [B, T, 32])."""
        nonpad = (None if padding_mask is None
                  else (~padding_mask).to(x.dtype)[:, :, None])
        for layer in self.conv:
            x = layer(x, drop_gen)
            if nonpad is not None:
                x = x * nonpad
        x = self.linear(x)
        if nonpad is not None:
            x = x * nonpad
        return x[..., 0] if self.dur_loss in ("mse", "huber") else x

    def decode(self, out: torch.Tensor,
               padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The head's output -> phone durations [B, T] (long). ``crf``: the
        Viterbi path over the valid phones (the first phone of every row
        counts as valid, so padded batch rows decode too), zero on padding."""
        if self.dur_loss != "crf":
            return self.out2dur(out)
        valid = (torch.ones(out.shape[:2], dtype=torch.bool, device=out.device)
                 if padding_mask is None else ~padding_mask)
        valid[:, 0] = True
        return self.crf.decode(out, valid) * valid.to(torch.long)

    def out2dur(self, log_dur: torch.Tensor) -> torch.Tensor:
        """round(exp(x) - offset), clamped >= 0."""
        if self.dur_loss not in ("mse", "huber"):
            raise NotImplementedError(f"dur_loss={self.dur_loss} has no log-duration "
                                      "decoding")
        return torch.clamp(torch.round(torch.exp(log_dur) - self.offset),
                           min=0).to(torch.long)


class PitchPredictor(nn.Module):
    """Conv-stack pitch (or energy, or CWT) predictor with sinusoidal input
    positions."""

    def __init__(self, in_dims: int, channels: int, num_layers: int = 5,
                 odim: int = 2, kernel_size: int = 5, dropout: float = 0.0,
                 padding: str = "SAME"):
        super().__init__()
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.embed_positions = SinusoidalPositionalEmbedding(in_dims)
        self.conv = nn.ModuleList([
            _ConvReluLN(in_dims if i == 0 else channels, channels, kernel_size, dropout,
                        padding)
            for i in range(num_layers)])
        self.linear = nn.Linear(channels, odim)

    def forward(self, x: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C] -> [B, T, odim]."""
        pos_tokens = (x[..., 0].abs() > 0).to(torch.long)
        x = x + self.pos_embed_alpha * self.embed_positions(pos_tokens)
        for layer in self.conv:
            x = layer(x, drop_gen)
        return self.linear(x)


def length_regulator(dur: torch.Tensor, t_mel: int,
                     dur_padding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phone durations [B, T_txt] -> frame-to-phone map ``mel2ph`` [B, t_mel]
    (1-based phone ids, 0 = padding), cut at the static length ``t_mel``."""
    dur = dur.to(torch.long)
    if dur_padding is not None:
        dur = dur * (~dur_padding).to(torch.long)
    token_idx = torch.arange(1, dur.shape[1] + 1, device=dur.device)[None, :, None]
    cum = torch.cumsum(dur, dim=1)
    cum_prev = cum - dur
    pos = torch.arange(t_mel, device=dur.device)[None, None, :]
    mask = (pos >= cum_prev[:, :, None]) & (pos < cum[:, :, None])
    return (token_idx * mask.to(torch.long)).sum(1)


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int,
                  max_dur: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`length_regulator`: mel2ph [B, T_mel] -> dur
    [B, t_txt], the number of frames mapped to each phone."""
    phones = torch.arange(1, t_txt + 1, dtype=mel2ph.dtype, device=mel2ph.device)
    dur = (mel2ph[:, :, None] == phones[None, None, :]).sum(1)
    if max_dur is not None:
        dur = torch.clamp(dur, max=max_dur)
    return dur


def expand_by_mel2ph(encoder_out: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """Gather phone features to frames: [B, Tt, C], [B, Tm] -> [B, Tm, C];
    index 0 reads a zero row."""
    padded = torch.nn.functional.pad(encoder_out, (0, 0, 1, 0))
    idx = mel2ph[..., None].expand(-1, -1, encoder_out.shape[-1])
    return torch.gather(padded, 1, idx)
