"""HiFi-GAN generator with optional NSF harmonic excitation (counterpart
of diffsinger_tpu/models/hifigan.py).

Layout [B, T, C] at the boundary; parameters carry the upstream keys
(``conv_pre``, ``ups.<i>``, ``resblocks.<j>.convs1.<i>`` (``resblock: '1'``,
HiFiGAN v1/v2) or ``resblocks.<j>.convs.<i>`` (``resblock: '2'``, v3),
``conv_post``, and for NSF ``m_source.l_linear``, ``noise_convs.<i>``) with
weight norm already folded. Upsampling follows torch ``ConvTranspose1d``
semantics with padding (k - u) // 2. ``forward`` is the plain module path;
``ops/hifigan_mrf.py:hifigan_mrf_apply`` is the serving path that runs the
MRF scales in the hand-written kernel.

``vocoder_compute_dtype: bfloat16`` runs the convolutions in bf16 from
float32 parameters, as the JAX generator does: each conv's input, weight and
bias are cast to bf16 (the conv's output and the bias sum are bf16), the
activations between them stay bf16, and ``conv_post`` runs in float32.

NSF (``use_pitch_embed``): the frame F0 is repeated to the sample rate, a
bank of 9 harmonic sines is built from it (``sine_source``; its phase cumsum
stays exact in float32 through the mod-1 carry, or ``sine_source_framewise``
takes a frame-rate prefix sum plus an in-frame ramp), mixed to one channel
by ``tanh(l_linear(.))``, and added after every upsample through a strided
``noise_convs`` conv. The random phase offsets ``rand_ini`` [B, 1, 9] and the
noise [B, T_wav, 9] are explicit arguments (:func:`draw_source` makes them
from a ``torch.Generator``), so a caller can fix them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.parallel.mesh import draw

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


def sine_source_framewise(f0_frame: torch.Tensor, upsample: int, sample_rate: int,
                          rand_ini: torch.Tensor, noise: torch.Tensor):
    """``sine_source(repeat(f0_frame, upsample))`` without sample-rate
    cumsums: within a frame the phase increment is constant, so the phase mod
    1 is an exclusive frame-rate prefix sum plus an in-frame ramp, each
    reduced mod 1 as it is built. f0_frame [B, F] -> (sines [B, F*U, 9],
    uv [B, F*U, 1])."""
    b, f = f0_frame.shape
    dev = f0_frame.device
    harmonics = torch.arange(1, N_SINES + 1, dtype=torch.float32, device=dev)
    r = torch.remainder(f0_frame[:, :, None] * harmonics / sample_rate, 1.0)
    step = torch.remainder(r * float(upsample), 1.0)
    base = torch.remainder(torch.cumsum(step, dim=1) - step + rand_ini, 1.0)
    j = torch.arange(1, upsample + 1, dtype=torch.float32, device=dev)
    ramp = torch.remainder(r[:, :, None, :] * j[None, None, :, None], 1.0)
    phase = torch.remainder(base[:, :, None, :] + ramp, 1.0)
    sines = (torch.sin(phase * (2 * np.pi)) * SINE_AMP).reshape(b, f * upsample, N_SINES)
    uv = torch.repeat_interleave((f0_frame > 0).to(torch.float32), upsample, dim=1)
    uv = uv[:, :, None]
    return _excite(sines, uv, noise), uv


def draw_source(b: int, t_wav: int, device, generator: torch.Generator):
    """The source's random draws: ``rand_ini`` [B, 1, 9] uniform phases (the
    fundamental's set to 0) and ``noise`` [B, T_wav, 9] normal; under a data
    mesh drawn for the global batch and this rank's rows kept."""
    rand_ini = draw(torch.rand, (b, 1, N_SINES), generator=generator, device=device)
    rand_ini[:, :, 0] = 0.0
    noise = draw(torch.randn, (b, t_wav, N_SINES), generator=generator, device=device)
    return rand_ini, noise


class SourceModuleHnNSF(nn.Module):
    """tanh(Linear(sine bank)): the harmonic source merged to one channel."""

    def __init__(self, sample_rate: int):
        super().__init__()
        self.sample_rate = sample_rate
        self.l_linear = nn.Linear(N_SINES, 1)

    def forward(self, f0: torch.Tensor, upsample: int, rand_ini: torch.Tensor,
                noise: torch.Tensor, framewise: bool = False) -> torch.Tensor:
        """f0 [B, F] frame-rate -> source [B, F * upsample, 1]."""
        if framewise:
            sines, _ = sine_source_framewise(f0, upsample, self.sample_rate, rand_ini,
                                             noise)
        else:
            f0_up = torch.repeat_interleave(f0, upsample, dim=1)
            sines, _ = sine_source(f0_up, self.sample_rate, rand_ini, noise)
        return torch.tanh(self.l_linear(sines))


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    """Leaky ReLU whose slope is rounded to x's dtype first, as a JAX scalar
    is (bf16: 0.1 -> 0.10009765625)."""
    if x.dtype == torch.float32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * torch.tensor(slope, dtype=x.dtype, device=x.device))


def conv1d(x: torch.Tensor, conv: nn.Module, dtype: Optional[torch.dtype] = None,
           **kw) -> torch.Tensor:
    """``conv`` on x [B, C, T]; with ``dtype`` the input, weight and bias are
    cast to it and the bias is added to the conv's rounded output, as the JAX
    package's bf16 convs do."""
    if dtype is None:
        return F.conv1d(x, conv.weight, conv.bias, **kw)
    return F.conv1d(x.to(dtype), conv.weight.to(dtype), **kw) + conv.bias.to(dtype)[:, None]


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
    use_pitch_embed: bool = False  # NSF excitation
    source_mode: str = "exact"     # NSF phase: "exact" or "framewise"
    compute_dtype: str = "float32"  # the convolutions' (vocoder_compute_dtype)

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "HifiGanConfig":
        """From vocoder hparams, as the JAX ``HifiGAN`` wrapper reads them: NSF
        is on with ``use_nsf``, or, when the hparams give the geometry
        (``upsample_rates``), also with ``use_pitch_embed``. Without
        ``upsample_rates`` the 22.05 kHz HiFiGAN v1 geometry (hop 256) is
        assumed; hparams that name a ``hop_size`` must then agree with the
        product of the rates, else this raises (a hop-256 vocoder under a
        hop-128 mel would make every waveform twice as long)."""
        compute_dtype = str(hp.get("vocoder_compute_dtype", "float32"))
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"vocoder_compute_dtype={compute_dtype}")
        source_mode = str(hp.get("nsf_source_mode", "exact"))
        if source_mode not in ("exact", "framewise"):
            raise ValueError(f"nsf_source_mode={source_mode}")
        common = dict(audio_sample_rate=int(hp.get("audio_sample_rate", 22050)),
                      num_mels=int(hp.get("audio_num_mel_bins", 80)),
                      source_mode=source_mode, compute_dtype=compute_dtype)
        if "upsample_rates" not in hp:
            cfg = cls(use_pitch_embed=bool(hp.get("use_nsf", False)), **common)
        else:
            cfg = cls(
                resblock=str(hp.get("resblock", "1")),
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

    @property
    def dtype(self) -> Optional[torch.dtype]:
        """The convolutions' dtype; None: float32."""
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


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

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x [B, C, T] (channels-first inside the generator)."""
        k = self.kernel_size
        for c1, c2, d in zip(self.convs1, self.convs2, self.dilations):
            xt = conv1d(leaky_relu(x), c1, dtype, padding=(k * d - d) // 2, dilation=d)
            xt = conv1d(leaky_relu(xt), c2, dtype, padding=(k - 1) // 2)
            x = x + xt
        return x


class ResBlock2(nn.Module):
    """The lighter MRF block of HiFiGAN v3: per dilation one dilated conv."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.convs = nn.ModuleList([
            _normal_conv(nn.Conv1d(channels, channels, kernel_size, dilation=d))
            for d in dilations])

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x [B, C, T]."""
        k = self.kernel_size
        for conv, d in zip(self.convs, self.dilations):
            x = x + conv1d(leaky_relu(x), conv, dtype, padding=(k * d - d) // 2,
                           dilation=d)
        return x


RESBLOCKS = {"1": ResBlock1, "2": ResBlock2}


class HifiGanGenerator(nn.Module):
    """mel [B, T, M] -> waveform [B, T * prod(upsample_rates)]."""

    def __init__(self, cfg: HifiGanConfig):
        super().__init__()
        if cfg.resblock not in RESBLOCKS:
            raise ValueError(f"resblock={cfg.resblock!r}: '1' or '2'")
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
                self.resblocks.append(RESBLOCKS[cfg.resblock](ch, rk, tuple(rd)))
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

    # The forward in pieces, shared with ops/hifigan_mrf.py (all [B, T, C];
    # in the compute dtype between the convolutions).
    def pre(self, mel: torch.Tensor) -> torch.Tensor:
        return conv1d(mel.transpose(1, 2), self.conv_pre, self.cfg.dtype,
                      padding=3).transpose(1, 2)

    def source(self, f0: torch.Tensor, rand_ini: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """NSF harmonic source [B, T_wav, 1] of the frame F0 [B, F]."""
        if rand_ini is None or noise is None:
            raise ValueError("the NSF source needs its draws rand_ini and noise")
        return self.m_source(f0, self.cfg.total_upsample, rand_ini, noise,
                             framewise=self.cfg.source_mode == "framewise")

    def add_source(self, x: torch.Tensor, har_source: torch.Tensor,
                   i: int) -> torch.Tensor:
        """x [B, T_i, C_i] after upsample i, plus the source brought to its
        rate by ``noise_convs[i]``."""
        conv = self.noise_convs[i]
        y = conv1d(har_source.transpose(1, 2), conv, self.cfg.dtype,
                   stride=conv.stride, padding=conv.padding)
        return x + y.transpose(1, 2)

    def upsample(self, x: torch.Tensor, i: int) -> torch.Tensor:
        up, dt = self.ups[i], self.cfg.dtype
        u, k = self.cfg.upsample_rates[i], self.cfg.upsample_kernel_sizes[i]
        x = leaky_relu(x).transpose(1, 2)
        if dt is None:
            x = F.conv_transpose1d(x, up.weight, up.bias, stride=u, padding=(k - u) // 2)
        else:
            x = (F.conv_transpose1d(x.to(dt), up.weight.to(dt), stride=u,
                                    padding=(k - u) // 2) + up.bias.to(dt)[:, None])
        return x.transpose(1, 2)

    def mrf(self, x: torch.Tensor, i: int) -> torch.Tensor:
        nb = len(self.cfg.resblock_kernel_sizes)
        xt = x.transpose(1, 2)
        xs = None
        for j in range(nb):
            y = self.resblocks[i * nb + j](xt, self.cfg.dtype)
            xs = y if xs is None else xs + y
        return (xs / nb).transpose(1, 2)

    def post(self, x: torch.Tensor) -> torch.Tensor:
        # the waveform conv in the parameters' type (float32 after bf16 convs)
        x = leaky_relu(x, 0.01).to(self.conv_post.weight.dtype).transpose(1, 2)
        x = F.conv1d(x, self.conv_post.weight, self.conv_post.bias, padding=3)
        return torch.tanh(x)[:, 0]

    def forward(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None,
                rand_ini: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T, M] (+ f0 [B, T] and the source draws, for NSF)."""
        har_source = None
        if self.cfg.use_pitch_embed and f0 is not None:
            har_source = self.source(f0, rand_ini, noise)
        x = self.pre(mel)
        for i in range(len(self.cfg.upsample_rates)):
            x = self.upsample(x, i)
            if har_source is not None:
                x = self.add_source(x, har_source, i)
            x = self.mrf(x, i)
        return self.post(x)
