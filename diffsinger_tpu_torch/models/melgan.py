"""MelGAN generator and multi-scale discriminator (counterpart of
diffsinger_tpu/models/melgan.py): the non-causal path with reflection
padding, leaky ReLU 0.2 and a tanh output.

Parameter names follow the JAX modules: ``conv_in``, ``ups.<i>`` (a
``ConvTranspose1d``, JAX's ``up_<i>_kernel`` / ``up_<i>_bias``),
``stacks.<i>.<j>.{conv_dilated,conv_1x1,skip_1x1}``, ``conv_out``; a
discriminator's ``conv_in``, ``down.<i>``, ``conv_mid``, ``conv_out``, under
``discriminators.<i>`` in the multi-scale one. Mels are [B, T, M], waveforms
[B, T]; the discriminators' outputs are channels-first [B, C, T].
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.models.hifigan_disc import avg_pool

LRELU = 0.2


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (pad, pad), mode="reflect")


class ResidualStack(nn.Module):
    """leaky ReLU -> reflect-padded dilated conv -> leaky ReLU -> 1x1, plus a
    1x1 skip of the input."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        self.pad = (kernel_size - 1) // 2 * dilation
        self.conv_dilated = nn.Conv1d(channels, channels, kernel_size, dilation=dilation)
        self.conv_1x1 = nn.Conv1d(channels, channels, 1)
        self.skip_1x1 = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T]."""
        h = _reflect_pad(F.leaky_relu(x, LRELU), self.pad)
        h = self.conv_1x1(F.leaky_relu(self.conv_dilated(h), LRELU))
        return h + self.skip_1x1(x)


class MelGANGenerator(nn.Module):
    def __init__(self, in_channels: int = 80, out_channels: int = 1, kernel_size: int = 7,
                 channels: int = 512, upsample_scales: Tuple[int, ...] = (8, 8, 2, 2),
                 stack_kernel_size: int = 3, stacks: int = 3,
                 use_final_nonlinear_activation: bool = True):
        super().__init__()
        self.kernel_size = kernel_size
        self.upsample_scales = tuple(upsample_scales)
        self.use_final_nonlinear_activation = use_final_nonlinear_activation
        self.conv_in = nn.Conv1d(in_channels, channels, kernel_size)
        self.ups = nn.ModuleList()
        self.stacks = nn.ModuleList()
        cin = channels
        for i, s in enumerate(self.upsample_scales):
            ch = channels // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(cin, ch, 2 * s, stride=s,
                                               padding=s // 2 + s % 2))
            self.stacks.append(nn.ModuleList([
                ResidualStack(ch, stack_kernel_size, stack_kernel_size ** j)
                for j in range(stacks)]))
            cin = ch
        self.conv_out = nn.Conv1d(cin, out_channels, kernel_size)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] -> wav [B, T * prod(scales)]."""
        pad = (self.kernel_size - 1) // 2
        x = self.conv_in(_reflect_pad(c.transpose(1, 2), pad))
        for s, up, stack in zip(self.upsample_scales, self.ups, self.stacks):
            x = up(F.leaky_relu(x, LRELU))
            if s % 2:  # torch's output_padding: one more frame, zero as JAX pads it
                x = F.pad(x, (0, 1))
            for block in stack:
                x = block(x)
        x = self.conv_out(_reflect_pad(F.leaky_relu(x, LRELU), pad))
        if self.use_final_nonlinear_activation:
            x = torch.tanh(x)
        return x[:, 0]


class MelGANDiscriminator(nn.Module):
    """One scale: a reflect-padded input conv, grouped strided ``down``
    convs, ``conv_mid`` and a one-channel ``conv_out``."""

    def __init__(self, kernel_sizes: Tuple[int, ...] = (5, 3), channels: int = 16,
                 max_downsample_channels: int = 1024,
                 downsample_scales: Tuple[int, ...] = (4, 4, 4, 4)):
        super().__init__()
        k0 = int(np.prod(kernel_sizes))
        self.pad = (k0 - 1) // 2
        self.conv_in = nn.Conv1d(1, channels, k0)
        self.down = nn.ModuleList()
        ch = channels
        for ds in downsample_scales:
            out_ch = min(ch * ds, max_downsample_channels)
            self.down.append(nn.Conv1d(ch, out_ch, ds * 10 + 1, stride=ds, padding=ds * 5,
                                       groups=ch // 4 if ch >= 4 else 1))
            ch = out_ch
        mid = min(ch * 2, max_downsample_channels)
        self.conv_mid = nn.Conv1d(ch, mid, kernel_sizes[0], padding=2)
        self.conv_out = nn.Conv1d(mid, 1, kernel_sizes[1], padding=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, T] -> every layer's output, the logits [B, 1, T'] last."""
        h = F.leaky_relu(self.conv_in(_reflect_pad(x[:, None], self.pad)), LRELU)
        outs = [h]
        for conv in [*self.down, self.conv_mid]:
            h = F.leaky_relu(conv(h), LRELU)
            outs.append(h)
        outs.append(self.conv_out(h))
        return outs


class MelGANMultiScaleDiscriminator(nn.Module):
    def __init__(self, scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList([MelGANDiscriminator() for _ in range(scales)])

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        outs = []
        for i, d in enumerate(self.discriminators):
            if i:
                x = avg_pool(x)
            outs.append(d(x))
        return outs
