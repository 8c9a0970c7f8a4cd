"""Parallel WaveGAN generator (counterpart of diffsinger_tpu/models/pwg.py),
the inference path of official and upstream PWG checkpoints.

Parameters carry the upstream keys (``first_conv``, ``conv_layers.<i>.conv``
/ ``conv1x1_aux`` / ``conv1x1_skip`` / ``conv1x1_out``,
``last_conv_layers.1`` / ``.3``, ``upsample_net.conv_in``,
``upsample_net.upsample.up_layers.<2i+1>``, and with a pitch embedding
``pitch_embed`` and ``c_proj``), weight norm already folded. A residual
block is a dilated conv whose output halves, each plus its half of a 1x1
conv of the upsampled mel, are gated tanh(a) * sigmoid(b); 1x1 convs give
the skip and the residual ((out + x) * sqrt(1/2)). The mel is upsampled by
a context conv and, per scale, a nearest stretch in time and a 2D smoothing
conv over (frequency, time). Layout: channels-first inside, z and the
waveform [B, T_wav].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.common import Embedding


class PWGResidualBlock(nn.Module):
    def __init__(self, kernel_size: int = 3, residual_channels: int = 64,
                 gate_channels: int = 128, skip_channels: int = 64,
                 aux_channels: int = 80, dilation: int = 1):
        super().__init__()
        pad = (kernel_size - 1) // 2 * dilation
        self.conv = nn.Conv1d(residual_channels, gate_channels, kernel_size,
                              padding=pad, dilation=dilation)
        self.conv1x1_aux = nn.Conv1d(aux_channels, gate_channels, 1, bias=False)
        self.conv1x1_out = nn.Conv1d(gate_channels // 2, residual_channels, 1)
        self.conv1x1_skip = nn.Conv1d(gate_channels // 2, skip_channels, 1)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor]):
        """x [B, Cr, T], c [B, Ca, T] -> (residual output, skip)."""
        xa, xb = self.conv(x).chunk(2, dim=1)
        if c is not None:
            ca, cb = self.conv1x1_aux(c).chunk(2, dim=1)
            xa, xb = xa + ca, xb + cb
        h = torch.tanh(xa) * torch.sigmoid(xb)
        return (self.conv1x1_out(h) + x) * math.sqrt(0.5), self.conv1x1_skip(h)


class _UpsampleNetwork(nn.Module):
    """Per scale a nearest stretch (no parameters; an ``Identity`` keeps the
    upstream indices) and a Conv2d over (frequency, time) one frequency bin
    high (upstream's default, which the PWG configs keep)."""

    def __init__(self, upsample_scales: Tuple[int, ...]):
        super().__init__()
        self.scales = tuple(upsample_scales)
        self.up_layers = nn.ModuleList()
        for s in self.scales:
            conv = nn.Conv2d(1, 1, (1, 2 * s + 1), padding=(0, s), bias=False)
            nn.init.constant_(conv.weight, 1.0 / (2 * s + 1))
            self.up_layers.extend([nn.Identity(), conv])

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c [B, Ca, T] -> [B, Ca, T * prod(scales)]."""
        x = c[:, None]
        for i, s in enumerate(self.scales):
            x = torch.repeat_interleave(x, s, dim=3)
            x = self.up_layers[2 * i + 1](x)
        return x[:, 0]


class ConvInUpsampleNetwork(nn.Module):
    def __init__(self, upsample_scales: Tuple[int, ...] = (4, 4, 4, 4),
                 aux_channels: int = 80, aux_context_window: int = 2):
        super().__init__()
        self.conv_in = nn.Conv1d(aux_channels, aux_channels, 2 * aux_context_window + 1,
                                 bias=False)
        self.upsample = _UpsampleNetwork(upsample_scales)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c [B, Ca, T + 2 * window] (context-padded) -> [B, Ca, T * prod(scales)]."""
        return self.upsample(self.conv_in(c))


@dataclasses.dataclass(frozen=True)
class PWGConfig:
    in_channels: int = 1
    out_channels: int = 1
    kernel_size: int = 3
    layers: int = 30
    stacks: int = 3
    residual_channels: int = 64
    gate_channels: int = 128
    skip_channels: int = 64
    aux_channels: int = 80
    aux_context_window: int = 2
    upsample_scales: Tuple[int, ...] = (4, 4, 4, 4)
    use_pitch_embed: bool = False

    @classmethod
    def from_config_dict(cls, d: Dict[str, Any]) -> "PWGConfig":
        """A PWG ``config.yaml`` (its ``generator_params``, or the dict
        itself)."""
        g = d.get("generator_params", d)
        up = g.get("upsample_params", {}).get("upsample_scales", [4, 4, 4, 4])
        return cls(layers=g.get("layers", 30), stacks=g.get("stacks", 3),
                   residual_channels=g.get("residual_channels", 64),
                   gate_channels=g.get("gate_channels", 128),
                   skip_channels=g.get("skip_channels", 64),
                   aux_channels=g.get("aux_channels", 80),
                   aux_context_window=g.get("aux_context_window", 2),
                   upsample_scales=tuple(up),
                   use_pitch_embed=g.get("use_pitch_embed", False))


class ParallelWaveGANGenerator(nn.Module):
    def __init__(self, cfg: PWGConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.use_pitch_embed:
            self.pitch_embed = Embedding(300, c.aux_channels, padding_idx=0)
            self.c_proj = nn.Linear(2 * c.aux_channels, c.aux_channels)
        self.upsample_net = ConvInUpsampleNetwork(c.upsample_scales, c.aux_channels,
                                                  c.aux_context_window)
        self.first_conv = nn.Conv1d(c.in_channels, c.residual_channels, 1)
        per_stack = c.layers // c.stacks
        self.conv_layers = nn.ModuleList([
            PWGResidualBlock(c.kernel_size, c.residual_channels, c.gate_channels,
                             c.skip_channels, c.aux_channels, dilation=2 ** (i % per_stack))
            for i in range(c.layers)])
        self.last_conv_layers = nn.ModuleList([
            nn.ReLU(), nn.Conv1d(c.skip_channels, c.skip_channels, 1),
            nn.ReLU(), nn.Conv1d(c.skip_channels, c.out_channels, 1)])

    def forward(self, z: torch.Tensor, c: torch.Tensor,
                pitch: Optional[torch.Tensor] = None) -> torch.Tensor:
        """z [B, T_wav] noise, c [B, T_mel + 2 * window, Ca] the edge-padded
        mel, pitch [B, T_mel + 2 * window] coarse pitch ids -> wav [B, T_wav]."""
        cfg = self.cfg
        if cfg.use_pitch_embed and pitch is not None:
            c = self.c_proj(torch.cat([c, self.pitch_embed(pitch)], dim=-1))
        c = self.upsample_net(c.transpose(1, 2))
        if c.shape[-1] != z.shape[-1]:
            raise ValueError(f"the upsampled mel has {c.shape[-1]} samples, z {z.shape[-1]}")
        x = self.first_conv(z[:, None])
        skips = 0
        for layer in self.conv_layers:
            x, s = layer(x, c)
            skips = skips + s
        x = skips * math.sqrt(1.0 / cfg.layers)
        for layer in self.last_conv_layers:
            x = layer(x)
        return x[:, 0]
