"""DiffNet denoiser, a non-causal WaveNet over mel frames (counterpart of
diffsinger_tpu/models/diffnet.py).

Layout is [B, T, C] at the module boundary, as in the JAX package. Parameter
names follow upstream ``denoise_fn.*`` keys (``residual_layers.<i>.
dilated_conv`` ...). ``DiffNet`` holds the weights; its ``forward`` is the
per-layer float32 module, differentiable, held against the JAX
``DiffNet.apply`` (values and gradients) by the tests. Sampling always goes
through ``ops/diffnet_stack.py:diffnet_forward`` and training through
``ops/diffnet_train.py:diffnet_train_forward``, whose stacks run in the
hand-written kernels on the card and carry the bf16 mode.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sin|cos diffusion-step embedding: t [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class _Mish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


def _kaiming_conv(conv: nn.Conv1d) -> nn.Conv1d:
    nn.init.kaiming_normal_(conv.weight)
    return conv


class ResidualBlock(nn.Module):
    """Gated dilated-conv residual block (upstream key names)."""

    def __init__(self, encoder_hidden: int, channels: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.dilated_conv = _kaiming_conv(nn.Conv1d(channels, 2 * channels, 3,
                                                    dilation=dilation))
        self.diffusion_projection = nn.Linear(channels, channels)
        self.conditioner_projection = _kaiming_conv(
            nn.Conv1d(encoder_hidden, 2 * channels, 1))
        self.output_projection = _kaiming_conv(nn.Conv1d(channels, 2 * channels, 1))


def pointwise(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """k=1 conv on [B, T, C] as a matmul (weights [out, in, 1])."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


class DiffNet(nn.Module):
    """spec [B, T, M], t [B], cond [B, T, H] -> eps_hat [B, T, M]."""

    def __init__(self, in_dims: int = 80, encoder_hidden: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 dilation_cycle_length: int = 1):
        super().__init__()
        c = self.residual_channels = residual_channels
        self.num_layers = residual_layers
        self.dilations = tuple(2 ** (i % dilation_cycle_length)
                               for i in range(residual_layers))
        self.input_projection = _kaiming_conv(nn.Conv1d(in_dims, c, 1))
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), _Mish(), nn.Linear(4 * c, c))
        self.residual_layers = nn.ModuleList([
            ResidualBlock(encoder_hidden, c, d) for d in self.dilations])
        self.skip_projection = _kaiming_conv(nn.Conv1d(c, c, 1))
        self.output_projection = nn.Conv1d(c, in_dims, 1)
        nn.init.zeros_(self.output_projection.weight)

    def forward(self, spec: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        x = torch.relu(pointwise(spec, self.input_projection))
        step = self.mlp(timestep_embedding(t, self.residual_channels))
        skips = None
        for layer in self.residual_layers:
            cp = pointwise(cond, layer.conditioner_projection)
            y = x + layer.diffusion_projection(step)[:, None, :]
            d = layer.dilation
            y = F.conv1d(F.pad(y.transpose(1, 2), (d, d)), layer.dilated_conv.weight,
                         layer.dilated_conv.bias, dilation=d).transpose(1, 2)
            y = y + cp
            gate, filt = y.chunk(2, dim=-1)
            y = torch.sigmoid(gate) * torch.tanh(filt)
            y = pointwise(y, layer.output_projection)
            residual, skip = y.chunk(2, dim=-1)
            x = (x + residual) * (2 ** -0.5)
            skips = skip if skips is None else skips + skip
        x = skips * (self.num_layers ** -0.5)
        x = torch.relu(pointwise(x, self.skip_projection))
        return pointwise(x, self.output_projection)
