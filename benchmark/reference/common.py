"""Frozen copy of diffsinger_tpu_torch/models/common.py, the plain PyTorch math the
benchmark's reference runs; it imports nothing of the program.

Shared building blocks on the [B, T, C] layout (counterpart of
diffsinger_tpu/models/common.py).

Parameter names follow the upstream torch DiffSinger ``state_dict`` keys
(``self_attn.in_proj_weight``, ``ffn.ffn_1.weight`` ...), so later slices can
load released checkpoints; ``convert/from_jax.py`` maps the JAX trees onto
them. Layer norms use the JAX package's epsilon (flax default 1e-6).

Training mode: every module with dropout takes ``drop_gen``, a
``torch.Generator`` that draws the masks (JAX passes its ``drop_rng`` the same
way). ``drop_gen=None`` is the deterministic (eval) forward; the global RNG is
never used.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# big-negative mask value (the reference's -1e9 masked_fill)
NEG_INF = -1e9
LN_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    1 - rate and scale by 1 / (1 - rate). Identity when ``generator`` is None
    (eval) or ``rate`` is 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(tuple(x.shape), generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def conv1d_btc(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               pad_left: int, pad_right: int, dilation: int = 1,
               stride: int = 1) -> torch.Tensor:
    """1-D convolution on [B, T, C] with torch weights [C_out, C_in, k] and
    explicit (possibly asymmetric) zero padding."""
    y = x.transpose(1, 2)
    if pad_left or pad_right:
        y = F.pad(y, (pad_left, pad_right))
    y = F.conv1d(y, weight, bias, stride=stride, dilation=dilation)
    return y.transpose(1, 2)


def fairseq_sinusoidal_table(num_embeddings: int, dim: int,
                             padding_idx: int = 0) -> np.ndarray:
    """Sin|cos positional table with a zero row at ``padding_idx``."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float64) * -emb)
    pos = np.arange(num_embeddings, dtype=np.float64)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_embeddings, 1))], axis=1)
    table[padding_idx] = 0
    return table.astype(np.float32)


def espnet_positional_table(length: int, dim: int, reverse: bool = False) -> np.ndarray:
    """Interleaved sin/cos table (ESPnet layout: even columns sin, odd cos)."""
    if reverse:
        position = np.arange(length - 1, -1, -1.0, dtype=np.float64)[:, None]
    else:
        position = np.arange(0, length, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    table = np.zeros((length, dim))
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term)
    return table.astype(np.float32)


def make_positions(tokens: torch.Tensor, padding_idx: int = 0) -> torch.Tensor:
    """Position ids counting only non-pad tokens, offset by padding_idx+1."""
    mask = (tokens != padding_idx).to(torch.long)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class SinusoidalPositionalEmbedding(nn.Module):
    """Pad-aware sinusoidal positions for token/frame sequences (no params)."""

    def __init__(self, dim: int, padding_idx: int = 0, init_size: int = 4096):
        super().__init__()
        self.dim = dim
        self.padding_idx = padding_idx
        self.init_size = init_size
        self.register_buffer("table", torch.from_numpy(
            fairseq_sinusoidal_table(init_size, dim, padding_idx)),
            persistent=False)

    def forward(self, tokens_or_mask: torch.Tensor) -> torch.Tensor:
        """tokens_or_mask [B, T]: nonzero entries mark real positions."""
        need = tokens_or_mask.shape[1] + self.padding_idx + 1
        table = self.table
        if need > table.shape[0]:
            table = torch.from_numpy(fairseq_sinusoidal_table(
                need, self.dim, self.padding_idx)).to(table.device)
        return table[make_positions(tokens_or_mask, self.padding_idx)]


class RelPositionalEncoding(nn.Module):
    """ESPnet's legacy relative encoding: ``x * sqrt(d)`` plus a reversed
    position table (no params).

    The table is built once at ``max_len`` rows and its *first* t rows are
    added, so the positions are ``max_len - 1 .. max_len - t`` whatever t is,
    not ``t - 1 .. 0``: the upstream module behaves so and released weights
    were trained with it. A sequence longer than ``max_len`` gets a table of
    its own length."""

    def __init__(self, dim: int, max_len: int = 5000):
        super().__init__()
        self.dim = dim
        self.max_len = max_len
        self.register_buffer("table", torch.from_numpy(
            espnet_positional_table(max_len, dim, reverse=True)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, C] -> x * sqrt(C) + table[:T]."""
        t = x.shape[1]
        table = self.table
        if t > table.shape[0]:
            table = torch.from_numpy(espnet_positional_table(t, self.dim, reverse=True)
                                     ).to(table.device)
        return x * math.sqrt(self.dim) + table[None, :t]


class MultiHeadSelfAttention(nn.Module):
    """Fairseq-style self-attention without biases, on [B, T, C]."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.xavier_uniform_(self.out_proj.weight)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, c = x.shape
        h = self.num_heads
        hd = c // h
        q, k, v = (x @ self.in_proj_weight.t()).split(c, dim=-1)
        q = q.reshape(b, t, h, hd).transpose(1, 2) * (hd ** -0.5)
        k = k.reshape(b, t, h, hd).transpose(1, 2)
        v = v.reshape(b, t, h, hd).transpose(1, 2)
        scores = q @ k.transpose(-1, -2)
        if key_padding_mask is not None:  # [B, T] True where PAD
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG_INF)
        out = torch.softmax(scores, dim=-1) @ v
        return F.linear(out.transpose(1, 2).reshape(b, t, c), self.out_proj.weight)


class ConvFFN(nn.Module):
    """Conv1d(k) -> * k^-0.5 -> act -> Linear. ``padding`` SAME centres the
    kernel, LEFT makes it causal."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "LEFT"):
            raise ValueError(f"ffn_padding={padding}")
        self.kernel_size = kernel_size
        self.act = act
        self.dropout = dropout
        self.padding = padding
        self.ffn_1 = nn.Conv1d(hidden_size, filter_size, kernel_size)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)
        nn.init.xavier_uniform_(self.ffn_2.weight)

    def forward(self, x: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        k = self.kernel_size
        pad = (k // 2, (k - 1) // 2) if self.padding == "SAME" else (k - 1, 0)
        x = conv1d_btc(x, self.ffn_1.weight, self.ffn_1.bias, *pad)
        x = x * k ** -0.5
        if self.act == "gelu":
            x = F.gelu(x)
        elif self.act == "relu":
            x = F.relu(x)
        elif self.act == "swish":
            x = F.silu(x)
        else:
            raise ValueError(f"ffn_act={self.act}")
        x = dropout(x, self.dropout, drop_gen)
        return F.linear(x, self.ffn_2.weight, self.ffn_2.bias)


class EncSALayer(nn.Module):
    """Pre-LN transformer encoder layer with conv-FFN and hard padding zeroing."""

    def __init__(self, hidden_size: int, num_heads: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0, padding: str = "SAME"):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        if num_heads > 0:
            self.layer_norm1 = nn.LayerNorm(hidden_size, eps=LN_EPS)
            # no dropout on the attention probabilities: the JAX layer builds
            # its attention with rate 0
            self.self_attn = MultiHeadSelfAttention(hidden_size, num_heads)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.ffn = ConvFFN(hidden_size, 4 * hidden_size, kernel_size, act, dropout,
                           padding)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, T, C]; padding_mask [B, T] True where PAD."""
        nonpad = (~padding_mask).to(x.dtype)[:, :, None]
        if self.num_heads > 0:
            residual = x
            x = self.self_attn(self.layer_norm1(x), key_padding_mask=padding_mask)
            x = (residual + dropout(x, self.dropout, drop_gen)) * nonpad
        residual = x
        x = self.ffn(self.layer_norm2(x), drop_gen)
        return (residual + dropout(x, self.dropout, drop_gen)) * nonpad


class TransformerEncoderLayer(nn.Module):
    """Holder that gives the upstream key prefix ``layers.<i>.op``."""

    def __init__(self, hidden_size: int, num_heads: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0, padding: str = "SAME"):
        super().__init__()
        self.op = EncSALayer(hidden_size, num_heads, kernel_size, act, dropout, padding)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor,
                drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.op(x, padding_mask, drop_gen)


class Embedding(nn.Module):
    """Embedding whose padding row reads as zero whatever the stored table."""

    def __init__(self, num_embeddings: int, dim: int,
                 padding_idx: Optional[int] = None):
        super().__init__()
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.randn(num_embeddings, dim) * dim ** -0.5)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = out * (ids != self.padding_idx)[..., None].to(out.dtype)
        return out


def xavier_linear(in_features: int, out_features: int,
                  bias: bool = True) -> nn.Linear:
    """Linear with xavier-uniform weight and zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias)
    nn.init.xavier_uniform_(lin.weight)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin
