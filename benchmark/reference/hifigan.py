"""Frozen copy of diffsinger_tpu_torch/models/hifigan.py, the plain PyTorch math the
benchmark's reference runs; it imports nothing of the program.

HiFi-GAN generator with optional NSF harmonic excitation (counterpart
of diffsinger_tpu/models/hifigan.py), cut to what the benchmark's
configurations run: ``resblock: '1'`` (HiFiGAN v1), float32 convolutions and
the exact NSF source. A configuration that asks for more is refused.

Layout [B, T, C] at the boundary; parameters carry the upstream keys
(``conv_pre``, ``ups.<i>``, ``resblocks.<j>.convs1.<i>``, ``conv_post``, and
for NSF ``m_source.l_linear``, ``noise_convs.<i>``) with weight norm already
folded. Upsampling follows torch ``ConvTranspose1d`` semantics with padding
(k - u) // 2.

NSF (``use_pitch_embed``): the frame F0 is repeated to the sample rate, a
bank of 9 harmonic sines is built from it (``sine_source``; its phase cumsum
stays exact in float32 through the mod-1 carry), mixed to one channel by
``tanh(l_linear(.))``, and added after every upsample through a strided
``noise_convs`` conv. The random phase offsets ``rand_ini`` [B, 1, 9] and the
noise [B, T_wav, 9] are explicit arguments, so a caller can fix them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1
# the NSF source: the fundamental and 8 overtones, sines of amplitude 0.1,
# noise of std 0.003 on voiced samples (F0 > 0 Hz)
N_SINES = 9
SINE_AMP = 0.1
NOISE_STD = 0.003


def _excite(sines: torch.Tensor, uv: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Voiced samples: sines + small noise; unvoiced: noise of amplitude
    SINE_AMP / 3."""
    noise_amp = uv * NOISE_STD + (1 - uv) * SINE_AMP / 3
    return sines * uv + noise_amp * noise


def sine_source(f0_up: torch.Tensor, sample_rate: int, rand_ini: torch.Tensor,
                noise: torch.Tensor):
    """Harmonic sine bank with uv gating and noise. f0_up [B, T_wav] audio-rate
    F0 -> (sines [B, T_wav, 9], uv [B, T_wav, 1]).

    The phase is a cumsum over the whole waveform; a second cumsum of the
    per-sample increments, shifted by -1 wherever the first one wrapped past
    an integer, keeps it within a cycle, so float32 holds it exactly. Both
    cumsums run along the last axis of a [B, H+1, T_wav] layout: a scan along
    the middle axis of [B, T_wav, H+1] has only B * 9 independent columns to
    spread over the card and took 68 ms at 8 x 131,072 samples on the H100."""
    harmonics = torch.arange(1, N_SINES + 1, dtype=torch.float32, device=f0_up.device)
    rad = torch.remainder(f0_up[:, None, :] * harmonics[:, None] / sample_rate, 1.0)
    rad = torch.cat([rad[:, :, :1] + rand_ini.transpose(1, 2), rad[:, :, 1:]], dim=2)
    tmp_over_one = torch.remainder(torch.cumsum(rad, dim=2), 1.0)
    over_one = (tmp_over_one[:, :, 1:] - tmp_over_one[:, :, :-1]) < 0
    cumsum_shift = F.pad(-1.0 * over_one.to(torch.float32), (1, 0))
    phase = torch.cumsum(rad + cumsum_shift, dim=2) * 2 * np.pi
    sines = (torch.sin(phase) * SINE_AMP).transpose(1, 2)
    uv = (f0_up > 0).to(torch.float32)[:, :, None]
    return _excite(sines, uv, noise), uv


class SourceModuleHnNSF(nn.Module):
    """tanh(Linear(sine bank)): the harmonic source merged to one channel."""

    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate
        self.l_linear = nn.Linear(N_SINES, 1)

    def forward(self, f0: torch.Tensor, upsample: int, rand_ini: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        """f0 [B, F] frame-rate -> source [B, F * upsample, 1]."""
        f0_up = torch.repeat_interleave(f0, upsample, dim=1)
        sines, _ = sine_source(f0_up, self.sample_rate, rand_ini, noise)
        return torch.tanh(self.l_linear(sines))


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5),
                                                            (1, 3, 5))
    audio_sample_rate: int = 22050
    num_mels: int = 80
    use_pitch_embed: bool = False  # NSF excitation

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "HifiGanConfig":
        """From vocoder hparams, as the JAX ``HifiGAN`` wrapper reads them: NSF
        is on with ``use_nsf``, or, when the hparams give the geometry
        (``upsample_rates``), also with ``use_pitch_embed``. Without
        ``upsample_rates`` the 22.05 kHz HiFiGAN v1 geometry (hop 256) is
        assumed; hparams that name a ``hop_size`` must then agree with the
        product of the rates, else this raises (a hop-256 vocoder under a
        hop-128 mel would make every waveform twice as long)."""
        asked = {"resblock": str(hp.get("resblock", "1")) != "1",
                 "vocoder_compute_dtype": hp.get("vocoder_compute_dtype",
                                                 "float32") != "float32",
                 "nsf_source_mode": hp.get("nsf_source_mode", "exact") != "exact"}
        if any(asked.values()):
            raise NotImplementedError(
                f"the reference leaves out {[k for k, v in asked.items() if v]}")
        common = dict(audio_sample_rate=int(hp.get("audio_sample_rate", 22050)),
                      num_mels=int(hp.get("audio_num_mel_bins", 80)))
        if "upsample_rates" not in hp:
            cfg = cls(use_pitch_embed=bool(hp.get("use_nsf", False)), **common)
        else:
            cfg = cls(
                upsample_rates=tuple(hp["upsample_rates"]),
                upsample_kernel_sizes=tuple(hp["upsample_kernel_sizes"]),
                upsample_initial_channel=int(hp["upsample_initial_channel"]),
                resblock_kernel_sizes=tuple(hp["resblock_kernel_sizes"]),
                resblock_dilation_sizes=tuple(tuple(d) for d in
                                              hp["resblock_dilation_sizes"]),
                use_pitch_embed=bool(hp.get("use_nsf", False)
                                     or hp.get("use_pitch_embed", False)),
                **common)
        if hp.get("hop_size") is not None and cfg.total_upsample != int(hp["hop_size"]):
            raise ValueError(
                f"vocoder upsample_rates {cfg.upsample_rates} give a hop of "
                f"{cfg.total_upsample} samples, the hparams' hop_size is {hp['hop_size']}: "
                "give the vocoder's geometry (upsample_rates, upsample_kernel_sizes, ...)")
        return cfg

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
        if cfg.use_pitch_embed:
            self.m_source = SourceModuleHnNSF(cfg.audio_sample_rate)
            self.noise_convs = nn.ModuleList()
            rates = cfg.upsample_rates
            for i in range(len(rates)):
                ch = c0 // (2 ** (i + 1))
                if i + 1 < len(rates):
                    s = int(np.prod(rates[i + 1:]))
                    self.noise_convs.append(nn.Conv1d(1, ch, 2 * s, stride=s,
                                                      padding=s // 2))
                else:
                    self.noise_convs.append(nn.Conv1d(1, ch, 1))

    def forward(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None,
                rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T, M] (+ f0 [B, T] and the source draws, for NSF)."""
        cfg = self.cfg
        har_source = None
        if cfg.use_pitch_embed and f0 is not None:
            if rand_ini is None or noise is None:
                raise ValueError("the NSF source needs its draws rand_ini and noise")
            har_source = self.m_source(f0, cfg.total_upsample, rand_ini,
                                       noise).transpose(1, 2)
        x = F.conv1d(mel.transpose(1, 2), self.conv_pre.weight, self.conv_pre.bias,
                     padding=3)
        nb = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            up = self.ups[i]
            x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), up.weight, up.bias,
                                   stride=u, padding=(k - u) // 2)
            if har_source is not None:
                conv = self.noise_convs[i]
                x = x + F.conv1d(har_source, conv.weight, conv.bias, stride=conv.stride,
                                 padding=conv.padding)
            xs = None
            for j in range(nb):
                y = self.resblocks[i * nb + j](x)
                xs = y if xs is None else xs + y
            x = xs / nb
        x = F.conv1d(F.leaky_relu(x, 0.01), self.conv_post.weight, self.conv_post.bias,
                     padding=3)
        return torch.tanh(x)[:, 0]
