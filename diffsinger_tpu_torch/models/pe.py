"""PitchExtractor: mel -> F0, used to re-extract F0 from generated mels
(counterpart of diffsinger_tpu/models/pe.py).

A 3-conv prenet (k = 5, ReLU, BatchNorm with its running statistics) with
padding-mask zeroing, a residual GroupNorm conv stack, the 5-layer
``PitchPredictor(odim=2)`` and the denormalized F0 with uv gating, zero at
padded (all-zero mel) frames. Parameter names follow the upstream torch
keys (``mel_prenet.layers.<i>.0`` conv, ``.2`` BatchNorm,
``mel_encoder.conv.<i>.conv.conv`` / ``.norm``, ``pitch_predictor.*``).

Inference reads the BatchNorm running statistics. Training mode (``train=
True``) is flax's ``BatchNorm(use_running_average=False)``, which
``torch.nn.BatchNorm1d`` is not: the statistics are computed explicitly over
every frame of the batch, padding included (the mask comes after the norm),
the variance is the biased E[x^2] - E[x]^2, and the new running statistics
(momentum 0.99: 0.99 * old + 0.01 * batch) are returned, not written; the
pitch predictor's dropout (0.1) draws from ``drop_gen``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.models.common import conv1d_btc, xavier_linear
from diffsinger_tpu_torch.models.predictors import PitchPredictor
from diffsinger_tpu_torch.parallel.mesh import batch_means
from diffsinger_tpu_torch.utils.pitch import denorm_f0


class Prenet(nn.Module):
    """(Conv(k) -> ReLU -> BatchNorm -> mask) x n_layers -> Linear -> mask."""

    def __init__(self, in_dim: int = 80, out_dim: int = 256, kernel: int = 5,
                 n_layers: int = 3):
        super().__init__()
        self.kernel = kernel
        self.layers = nn.ModuleList([
            nn.Sequential(nn.Conv1d(in_dim if i == 0 else out_dim, out_dim, kernel),
                          nn.ReLU(), nn.BatchNorm1d(out_dim))
            for i in range(n_layers)])
        self.out_proj = nn.Linear(out_dim, out_dim)

    def forward(self, mel: torch.Tensor,
                new_stats: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """With ``new_stats`` (a dict to fill): training mode, batch
        statistics, the updated running statistics put in ``new_stats`` under
        their buffer names relative to this module."""
        nonpad = (mel.abs().sum(-1) != 0).to(mel.dtype)[:, :, None]
        x = mel
        pad = self.kernel // 2
        for i, layer in enumerate(self.layers):
            conv, bn = layer[0], layer[2]
            x = torch.relu(conv1d_btc(x, conv.weight, conv.bias, pad, pad))
            if new_stats is None:
                x = F.batch_norm(x.transpose(1, 2), bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, training=False,
                                 eps=bn.eps).transpose(1, 2)
            else:
                x = self._batch_norm_train(x, bn, new_stats, f"layers.{i}.2.")
            x = x * nonpad
        return self.out_proj(x) * nonpad

    @staticmethod
    def _batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d,
                          new_stats: Dict[str, torch.Tensor], key: str) -> torch.Tensor:
        """flax ``BatchNorm`` in training mode on [B, T, C]: statistics over B
        and T, biased fast variance clipped at 0, momentum 0.99. Under a data
        mesh the sum, the sum of squares and the count are those of the
        global batch (one all-reduce), so every rank normalises alike and
        holds the same running statistics."""
        mean, sq = batch_means([x, x * x], (0, 1))
        var = torch.clamp(sq - mean * mean, min=0.0)
        momentum = 0.99
        with torch.no_grad():
            new_stats[key + "running_mean"] = (momentum * bn.running_mean
                                               + (1 - momentum) * mean.detach())
            new_stats[key + "running_var"] = (momentum * bn.running_var
                                              + (1 - momentum) * var.detach())
        return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class _ConvNorm(nn.Module):
    """Holder that gives the upstream key prefix ``conv.<i>.conv.conv``."""

    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel)
        nn.init.xavier_uniform_(self.conv.weight)


class _ConvBlock(nn.Module):
    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.conv = _ConvNorm(channels, kernel)
        self.norm = nn.GroupNorm(channels // 16, channels, eps=1e-5)


class ConvStacks(nn.Module):
    """Linear -> (x + ReLU(GroupNorm(conv(x)))) x n_layers -> Linear."""

    def __init__(self, channels: int = 256, odim: int = 256, n_layers: int = 2,
                 kernel: int = 5):
        super().__init__()
        self.kernel = kernel
        self.in_proj = xavier_linear(channels, channels)
        self.conv = nn.ModuleList([_ConvBlock(channels, kernel) for _ in range(n_layers)])
        self.out_proj = xavier_linear(channels, odim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.in_proj(x)
        pad = self.kernel // 2
        for block in self.conv:
            conv = block.conv.conv
            h = conv1d_btc(x, conv.weight, conv.bias, pad, pad)
            h = block.norm(h.transpose(1, 2)).transpose(1, 2)
            x = x + torch.relu(h)
        return self.out_proj(x)


@dataclasses.dataclass(frozen=True)
class PEConfig:
    hidden_size: int = 256
    predictor_hidden: int = -1
    predictor_kernel: int = 5
    conv_layers: int = 2
    n_mel_bins: int = 80
    pitch_type: str = "frame"
    use_uv: bool = True
    pitch_norm: str = "log"
    f0_mean: float = 0.0
    f0_std: float = 1.0

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "PEConfig":
        return cls(hidden_size=int(hp.get("hidden_size", 256)),
                   predictor_hidden=int(hp.get("predictor_hidden", -1)),
                   predictor_kernel=int(hp.get("predictor_kernel", 5)),
                   n_mel_bins=int(hp.get("audio_num_mel_bins", 80)),
                   pitch_type=hp.get("pitch_type", "frame"),
                   use_uv=bool(hp.get("use_uv", True)),
                   pitch_norm=hp.get("pitch_norm", "log"),
                   f0_mean=float(hp.get("f0_mean") or 0.0),
                   f0_std=float(hp.get("f0_std") or 1.0))


class PitchExtractor(nn.Module):
    """mel [B, T, M] -> {"pitch_pred" [B, T, 2], "f0_denorm_pred" [B, T] Hz}."""

    def __init__(self, cfg: PEConfig):
        super().__init__()
        self.cfg = c = cfg
        pred_hidden = c.predictor_hidden if c.predictor_hidden > 0 else c.hidden_size
        self.mel_prenet = Prenet(c.n_mel_bins, c.hidden_size)
        if c.conv_layers > 0:
            self.mel_encoder = ConvStacks(c.hidden_size, c.hidden_size, c.conv_layers)
        self.pitch_predictor = PitchPredictor(c.hidden_size, pred_hidden, 5, odim=2,
                                              kernel_size=c.predictor_kernel, dropout=0.1)

    def forward(self, mel: torch.Tensor, train: bool = False,
                drop_gen: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Inference (no autograd) or, with ``train``, the training forward:
        batch statistics, dropout from ``drop_gen`` (None: none), and the
        updated running statistics under ``ret["new_stats"]`` keyed by their
        buffer names in this module."""
        if train:
            return self._forward(mel, {}, drop_gen)
        with torch.no_grad():
            return self._forward(mel, None, None)

    def _forward(self, mel: torch.Tensor, new_stats: Optional[Dict[str, torch.Tensor]],
                 drop_gen: Optional[torch.Generator]) -> Dict[str, Any]:
        c = self.cfg
        h = self.mel_prenet(mel, new_stats)
        if c.conv_layers > 0:
            h = self.mel_encoder(h)
        pitch_pred = self.pitch_predictor(h, drop_gen)
        use_uv = c.pitch_type == "frame" and c.use_uv
        f0 = denorm_f0(pitch_pred[:, :, 0], (pitch_pred[:, :, 1] > 0) if use_uv else None,
                       pitch_norm=c.pitch_norm, f0_mean=c.f0_mean, f0_std=c.f0_std,
                       use_uv=c.use_uv, pitch_padding=mel.abs().sum(-1) == 0)
        ret = {"pitch_pred": pitch_pred, "f0_denorm_pred": f0}
        if new_stats is not None:
            ret["new_stats"] = {"mel_prenet." + k: v for k, v in new_stats.items()}
        return ret
