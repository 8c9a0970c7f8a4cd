"""Frozen copy of the operation counts of diffsinger_tpu_torch/ops/flops.py,
kept with the benchmark so that a change to the program cannot move the
yardstick, plus the PitchExtractor, which that file does not count.

Counts are matmul and convolution multiply-adds x 2 per call, batch
included; elementwise work is left out (it is bound by bytes, not
operations). The peaks the benchmark divides by are in
``harness/peaks.py``, not here.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


# ---------------------------------------------------------------------------
# model components — all counts are per CALL (batch included), MAC*2
# ---------------------------------------------------------------------------
def fft_stack_flops(b: int, t: int, h: int, layers: int, kernel: int,
                    ffn_mult: int = 4) -> float:
    """One FFT-transformer stack (reference tts_modules.py FFTBlocks):
    per layer: qkv+out projections (4 h^2 matmuls), 2 attention matmuls,
    conv-FFN (k*h -> 4h conv, 4h -> h linear)."""
    per_layer = (
        2 * b * t * h * h * 4              # q,k,v,out projections
        + 2 * b * t * t * h * 2            # qk^T and attnV
        + 2 * b * t * kernel * h * ffn_mult * h   # ffn conv
        + 2 * b * t * ffn_mult * h * h     # ffn out
    )
    return float(layers * per_layer)


def predictor_flops(b: int, t: int, h: int, channels: int, layers: int,
                    kernel: int, odim: int = 1) -> float:
    """Conv predictor stacks (DurationPredictor/PitchPredictor)."""
    first = 2 * b * t * kernel * h * channels
    rest = 2 * b * t * kernel * channels * channels * max(layers - 1, 0)
    out = 2 * b * t * channels * odim
    return float(first + rest + out)


def fs2_flops(hp: Dict[str, Any], b: int, t_txt: int, t_mel: int,
              skip_decoder: bool = False) -> float:
    h = int(hp.get("hidden_size", 256))
    enc_l, dec_l = int(hp.get("enc_layers", 4)), int(hp.get("dec_layers", 4))
    enc_k = int(hp.get("enc_ffn_kernel_size", 9))
    dec_k = int(hp.get("dec_ffn_kernel_size", 9))
    ph = int(hp.get("predictor_hidden", -1))
    ph = ph if ph > 0 else h
    total = fft_stack_flops(b, t_txt, h, enc_l, enc_k)
    total += predictor_flops(b, t_txt, h, ph,
                             int(hp.get("dur_predictor_layers", 2)),
                             int(hp.get("dur_predictor_kernel", 3)))
    if hp.get("use_pitch_embed", True):
        t_pitch = t_txt if hp.get("pitch_type") == "ph" else t_mel
        odim = 2 if hp.get("pitch_type", "ph") == "frame" else 1
        total += predictor_flops(b, t_pitch, h, ph,
                                 int(hp.get("predictor_layers", 2)),
                                 int(hp.get("predictor_kernel", 5)), odim)
    if not skip_decoder:
        total += fft_stack_flops(b, t_mel, h, dec_l, dec_k)
        total += 2 * b * t_mel * h * int(hp.get("audio_num_mel_bins", 80))
    return float(total)


def diffnet_step_flops(hp: Dict[str, Any], b: int, t_mel: int,
                       include_cond_proj: bool = False) -> float:
    """One denoiser evaluation (reference usr/diff/net.py:81-130). The
    conditioner projections are step-invariant and hoisted out of the reverse
    loop (ops/diffnet_stack.py precompute_cond_packed); pass include_cond_proj=True to count
    them (the reference recomputes every step)."""
    m = int(hp.get("audio_num_mel_bins", 80))
    c = int(hp.get("residual_channels", 256))
    layers = int(hp.get("residual_layers", 20))
    total = 2 * b * t_mel * m * c                 # input projection
    per_layer = 2 * b * t_mel * 3 * c * 2 * c     # dilated conv k=3 -> 2C
    per_layer += 2 * b * t_mel * c * 2 * c        # output projection C -> 2C
    if include_cond_proj:
        per_layer += 2 * b * t_mel * int(hp.get("hidden_size", 256)) * 2 * c
    total += layers * per_layer
    total += 2 * b * t_mel * c * c                # skip projection
    total += 2 * b * t_mel * c * m                # out projection
    return float(total)


def cond_proj_flops(hp: Dict[str, Any], b: int, t_mel: int) -> float:
    c = int(hp.get("residual_channels", 256))
    h = int(hp.get("hidden_size", 256))
    layers = int(hp.get("residual_layers", 20))
    return float(layers * 2 * b * t_mel * h * 2 * c)


def sampler_flops(hp: Dict[str, Any], b: int, t_txt: int, t_mel: int) -> float:
    """Full text2mel synthesis: FS2 forward (conditioner incl. aux decoder for
    the shallow boost) + hoisted cond projections + K denoiser steps
    (+1 extra eval on the first PLMS step's order-1 corrector)."""
    k = int(hp.get("K_step", hp.get("timesteps", 100)))
    speedup = int(hp.get("pndm_speedup") or 0)
    n_steps = (k + speedup - 1) // speedup + 1 if speedup else k
    return (fs2_flops(hp, b, t_txt, t_mel)
            + cond_proj_flops(hp, b, t_mel)
            + n_steps * diffnet_step_flops(hp, b, t_mel))


def hifigan_flops(hp: Dict[str, Any], b: int, t_mel: int) -> float:
    """HiFiGAN generator (reference modules/hifigan/hifigan.py:104-180).
    ConvTranspose counts k/stride taps per output sample; each MRF ResBlock1
    kernel contributes 2*len(dilations) convs."""
    m = int(hp.get("audio_num_mel_bins", 80))
    c0 = int(hp.get("upsample_initial_channel", 512))
    rates = list(hp.get("upsample_rates", (8, 8, 2, 2)))
    kernels = list(hp.get("upsample_kernel_sizes", (16, 16, 4, 4)))
    rks = list(hp.get("resblock_kernel_sizes", (3, 7, 11)))
    rds = list(hp.get("resblock_dilation_sizes", ((1, 3, 5),) * 3))
    convs_per_block = (2 if str(hp.get("resblock", "1")) == "1" else 1)
    total = 2 * b * t_mel * 7 * m * c0            # conv_pre
    t = t_mel
    ch_in = c0
    nsf = bool(hp.get("use_nsf") or hp.get("use_pitch_embed"))
    t_wav = t_mel * int(np.prod(rates))
    for i, (u, k) in enumerate(zip(rates, kernels)):
        ch = c0 // (2 ** (i + 1))
        t = t * u
        taps = k / u                              # taps per output sample
        total += 2 * b * t * taps * ch_in * ch    # ConvTranspose
        if nsf:
            if i + 1 < len(rates):
                stride_f0 = int(np.prod(rates[i + 1:]))
                # Conv1d(1, ch, k=2*stride_f0, stride=stride_f0): t outputs
                total += 2 * b * t * (2 * stride_f0) * 1 * ch
            else:
                total += 2 * b * t * 1 * ch
        for rk, rd in zip(rks, rds):
            n_convs = convs_per_block * len(rd)
            total += 2 * b * t * rk * ch * ch * n_convs
        ch_in = ch
    total += 2 * b * t * 7 * ch_in * 1            # conv_post
    if nsf:
        total += 2 * b * t_wav * 9 * 1            # source linear (negligible)
    return float(total)


def train_step_flops(hp: Dict[str, Any], b: int, t_txt: int, t_mel: int) -> float:
    """One diffusion training step: forward (FS2 conditioner skip_decoder +
    one denoiser eval incl. cond projections) + backward at 2x forward."""
    fwd = (fs2_flops(hp, b, t_txt, t_mel, skip_decoder=True)
           + diffnet_step_flops(hp, b, t_mel, include_cond_proj=True))
    return 3.0 * fwd


def pe_flops(hp: Dict[str, Any], b: int, t_mel: int) -> float:
    """The PitchExtractor (models/pe.py): a 3-layer k=5 conv prenet and its
    projection, a 2-layer k=5 conv encoder between two projections, and a
    5-layer pitch predictor with a 2-wide head."""
    h = int(hp.get("hidden_size", 256))
    m = int(hp.get("audio_num_mel_bins", 80))
    ph = int(hp.get("predictor_hidden", -1))
    ph = ph if ph > 0 else h
    k = 5
    prenet = 2 * b * t_mel * k * (m * h + 2 * h * h) + 2 * b * t_mel * h * h
    encoder = 2 * b * t_mel * (2 * h * h + 2 * k * h * h)
    return float(prenet + encoder
                 + predictor_flops(b, t_mel, h, ph, 5, int(hp.get("predictor_kernel", 5)), 2))
