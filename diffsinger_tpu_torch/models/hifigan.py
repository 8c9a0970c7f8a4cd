"""HiFi-GAN v1 generator without NSF (counterpart of
diffsinger_tpu/models/hifigan.py).

Layout [B, T, C] at the boundary; parameters carry the upstream keys
(``conv_pre``, ``ups.<i>``, ``resblocks.<j>.convs1.<i>``, ``conv_post``) with
weight norm already folded. Upsampling follows torch ``ConvTranspose1d``
semantics with padding (k - u) // 2. ``forward`` is the plain module path;
``ops/hifigan_mrf.py:hifigan_mrf_apply`` is the serving path that runs the
MRF scales in the hand-written kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5),
                                                            (1, 3, 5))
    audio_sample_rate: int = 22050
    num_mels: int = 80

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "HifiGanConfig":
        if hp.get("use_nsf"):
            raise NotImplementedError("the torch port does not cover NSF yet")
        if str(hp.get("vocoder_compute_dtype", "float32")) != "float32":
            raise NotImplementedError("the torch port's vocoder runs in float32")
        if "upsample_rates" not in hp:
            return cls(audio_sample_rate=int(hp.get("audio_sample_rate", 22050)),
                       num_mels=int(hp.get("audio_num_mel_bins", 80)))
        return cls(
            resblock=str(hp.get("resblock", "1")),
            upsample_rates=tuple(hp["upsample_rates"]),
            upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]),
            upsample_initial_channel=int(hp["upsample_initial_channel"]),
            resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(d) for d in hp["resblock_dilation_sizes"]),
            audio_sample_rate=int(hp.get("audio_sample_rate", 22050)),
            num_mels=int(hp.get("audio_num_mel_bins", 80)),
        )

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates))


def _normal_conv(conv: nn.Module, std: float = 0.01) -> nn.Module:
    nn.init.normal_(conv.weight, 0.0, std)
    nn.init.zeros_(conv.bias)
    return conv


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, a dilated conv and a d=1 conv."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs1 = nn.ModuleList([
            _normal_conv(nn.Conv1d(channels, channels, kernel_size, dilation=d))
            for d in dilations])
        self.convs2 = nn.ModuleList([
            _normal_conv(nn.Conv1d(channels, channels, kernel_size))
            for _ in dilations])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, T] (channels-first inside the generator)."""
        k = self.kernel_size
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), c1.weight, c1.bias,
                          padding=(k * d - d) // 2, dilation=d)
            xt = F.conv1d(F.leaky_relu(xt, LRELU_SLOPE), c2.weight, c2.bias,
                          padding=(k - 1) // 2)
            x = x + xt
        return x


class HifiGanGenerator(nn.Module):
    """mel [B, T, M] -> waveform [B, T * prod(upsample_rates)]."""

    def __init__(self, cfg: HifiGanConfig):
        super().__init__()
        if cfg.resblock != "1":
            raise NotImplementedError("the torch port covers resblock '1' (HiFiGAN v1)")
        self.cfg = cfg
        c0 = cfg.upsample_initial_channel
        self.conv_pre = _normal_conv(nn.Conv1d(cfg.num_mels, c0, 7, padding=3))
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = c0 // (2 ** (i + 1))
            self.ups.append(_normal_conv(nn.ConvTranspose1d(
                c0 // (2 ** i), ch, k, stride=u, padding=(k - u) // 2)))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = _normal_conv(nn.Conv1d(c0 // (2 ** len(cfg.upsample_rates)),
                                                1, 7, padding=3))

    # The forward in pieces, shared with ops/hifigan_mrf.py (all [B, T, C]).
    def pre(self, mel: torch.Tensor) -> torch.Tensor:
        x = F.conv1d(mel.transpose(1, 2), self.conv_pre.weight, self.conv_pre.bias,
                     padding=3)
        return x.transpose(1, 2)

    def upsample(self, x: torch.Tensor, i: int) -> torch.Tensor:
        up = self.ups[i]
        u, k = self.cfg.upsample_rates[i], self.cfg.upsample_kernel_sizes[i]
        x = F.leaky_relu(x, LRELU_SLOPE).transpose(1, 2)
        x = F.conv_transpose1d(x, up.weight, up.bias, stride=u, padding=(k - u) // 2)
        return x.transpose(1, 2)

    def mrf(self, x: torch.Tensor, i: int) -> torch.Tensor:
        nb = len(self.cfg.resblock_kernel_sizes)
        xt = x.transpose(1, 2)
        xs = None
        for j in range(nb):
            y = self.resblocks[i * nb + j](xt)
            xs = y if xs is None else xs + y
        return (xs / nb).transpose(1, 2)

    def post(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(x).transpose(1, 2)
        x = F.conv1d(x, self.conv_post.weight, self.conv_post.bias, padding=3)
        return torch.tanh(x)[:, 0]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.pre(mel)
        for i in range(len(self.cfg.upsample_rates)):
            x = self.mrf(self.upsample(x, i), i)
        return self.post(x)
