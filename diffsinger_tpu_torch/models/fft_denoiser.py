"""Transformer (FFT) diffusion denoiser, the alternative to the WaveNet
DiffNet (counterpart of diffsinger_tpu/models/fft_denoiser.py), selected by
``diff_decoder_type: fft``.

concat(1x1-conv input projection, cond, broadcast step embedding) -> Linear
-> FFT decoder blocks (positions on, no dropout, padding read off all-zero
rows) -> mel projection. Plain PyTorch: no kernel covers it. Keys follow
upstream's ``FFT`` (usr/diff/candidate_decoder.py): the FastspeechDecoder
keys (``layers.<i>.op.*``, ``layer_norm``, ``pos_embed_alpha``) plus
``input_projection``, ``mlp.0/2``, ``get_decode_inp`` and ``get_mel_out``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.diffnet import _kaiming_conv, _Mish, pointwise, timestep_embedding
from diffsinger_tpu_torch.models.fft_blocks import FFTBlocks


class FFTDenoiser(FFTBlocks):
    """spec [B, T, M], t [B], cond [B, T, H] -> eps_hat [B, T, M]."""

    def __init__(self, in_dims: int = 80, hidden_size: int = 256,
                 residual_channels: int = 256, num_layers: int = 4,
                 ffn_kernel_size: int = 9, num_heads: int = 2):
        super().__init__(hidden_size, num_layers, ffn_kernel_size, num_heads,
                         use_pos_embed=True)
        dim = self.residual_channels = residual_channels
        self.input_projection = _kaiming_conv(nn.Conv1d(in_dims, dim, 1))
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), _Mish(), nn.Linear(4 * dim, dim))
        self.get_decode_inp = nn.Linear(2 * dim + hidden_size, hidden_size)
        self.get_mel_out = nn.Linear(hidden_size, in_dims)

    def forward(self, spec: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor) -> torch.Tensor:
        x = pointwise(spec, self.input_projection)
        step = self.mlp(timestep_embedding(t, self.residual_channels))
        step = step[:, None, :].expand(-1, x.shape[1], -1)
        h = self.get_decode_inp(torch.cat([x, cond, step], dim=-1))
        return self.get_mel_out(super().forward(h))
