"""HiFi-GAN discriminators and GAN losses for vocoder training (counterpart
of diffsinger_tpu/models/hifigan_disc.py).

No weight norm and no spectral norm, as in the JAX package. Parameter names
follow its modules: ``discriminators.<i>.convs.<j>`` and
``discriminators.<i>.conv_post``. Waveforms are [B, T]; feature maps are
torch's channels-first tensors ([B, C, T / p, p] for a period
discriminator, [B, C, T] for a scale discriminator), the JAX maps transposed.

The L1 terms take :func:`training.losses.l1`, whose derivative at 0 is +1 as
``jnp.abs``'s is.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.training.losses import l1

LRELU_SLOPE = 0.1
# (channels, kernel, stride, groups, padding) of a scale discriminator's convs
SCALE_SPEC = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
              (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
              (1024, 5, 1, 1, 2))


class DiscriminatorP(nn.Module):
    """Period discriminator: the waveform folded to [T / p, p] (reflect-padded
    to a multiple of p) under strided (k, 1) 2-D convs."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [nn.Conv2d(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0))
             for cin, cout in zip(chans[:-1], chans[1:])]
            + [nn.Conv2d(1024, 1024, (kernel_size, 1), 1, (2, 0))])
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), 1, (1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, T] -> (logits [B, N], feature maps)."""
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        h = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(b, -1), fmap   # one channel: H-major, as JAX flattens


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped strided 1-D convs."""

    def __init__(self):
        super().__init__()
        cins = (1,) + tuple(s[0] for s in SCALE_SPEC[:-1])
        self.convs = nn.ModuleList([nn.Conv1d(cin, ch, k, s, pad, groups=g)
                                    for cin, (ch, k, s, g, pad) in zip(cins, SCALE_SPEC)])
        self.conv_post = nn.Conv1d(SCALE_SPEC[-1][0], 1, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = x[:, None]
        fmap = []
        for conv in self.convs:
            h = F.leaky_relu(conv(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


def _pair(discs, ys):
    """(real logits, fake logits, real maps, fake maps) of each discriminator
    on its (y, y_hat)."""
    out = ([], [], [], [])
    for d, (y, y_hat) in zip(discs, ys):
        r, fr = d(y)
        g, fg = d(y_hat)
        for lst, v in zip(out, (r, g, fr, fg)):
            lst.append(v)
    return out


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Tuple[int, ...] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return _pair(self.discriminators, [(y, y_hat)] * len(self.discriminators))


def avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[B, T] -> [B, T / 2]: flax's ``avg_pool`` window 4, stride 2, padding 1,
    the zero padding counted in the mean."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=1, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList([DiscriminatorS() for _ in range(num_scales)])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        ys = [(y, y_hat)]
        for _ in range(len(self.discriminators) - 1):
            y, y_hat = avg_pool(y), avg_pool(y_hat)
            ys.append((y, y_hat))
        return _pair(self.discriminators, ys)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + l1(rl - gl).mean()
    return loss * 2


def discriminator_loss(real_outputs, gen_outputs):
    """LSGAN: (mean (1 - D(y))^2, mean D(y_hat)^2), each averaged over the
    discriminators."""
    r_losses = sum(((1 - dr) ** 2).mean() for dr in real_outputs)
    g_losses = sum((dg ** 2).mean() for dg in gen_outputs)
    n = len(real_outputs)
    return r_losses / n, g_losses / n


def generator_loss(disc_outputs) -> torch.Tensor:
    return sum(((1 - dg) ** 2).mean() for dg in disc_outputs) / len(disc_outputs)
