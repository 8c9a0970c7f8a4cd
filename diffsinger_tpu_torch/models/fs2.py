"""FastSpeech2 acoustic model (counterpart of diffsinger_tpu/models/fs2.py).

The port covers ``pitch_type: frame`` with ``pitch_norm: log`` or no pitch
embedding at all (``use_pitch_embed: false``, the e2e singing configs), and
the MIDI encoder inputs (``use_midi``: note, note duration and slur
embeddings summed into the token embedding) with ESPnet's relative positions
(``rel_pos``); energy and speaker conditioning raise. Inference uses a static
``t_mel`` bucket for length regulation, as the JAX model does.
Training mode is the forward with ``drop_gen`` (a ``torch.Generator`` for the
dropout masks), given ``mel2ph``, ``f0`` and ``uv``, and usually
``skip_decoder=True`` (the diffusion conditioner). The predictors read their
inputs through the ``predictor_grad`` partial stop-gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from diffsinger_tpu_torch.models.common import Embedding, xavier_linear
from diffsinger_tpu_torch.models.fft_blocks import FastSpeechDecoder, FastSpeechEncoder
from diffsinger_tpu_torch.models.predictors import (DurationPredictor, PitchPredictor,
                                                    expand_by_mel2ph, length_regulator)
from diffsinger_tpu_torch.utils.pitch import denorm_f0, f0_to_coarse


@dataclasses.dataclass(frozen=True)
class FS2Config:
    vocab_size: int
    hidden_size: int = 256
    enc_layers: int = 4
    dec_layers: int = 4
    enc_ffn_kernel_size: int = 9
    dec_ffn_kernel_size: int = 9
    num_heads: int = 2
    dropout: float = 0.1
    ffn_act: str = "gelu"
    out_dims: int = 80
    predictor_hidden: int = -1
    predictor_layers: int = 2
    predictor_kernel: int = 5
    dur_predictor_layers: int = 2
    dur_predictor_kernel: int = 3
    predictor_dropout: float = 0.5
    predictor_grad: float = 0.1
    use_pitch_embed: bool = True
    pitch_type: str = "frame"
    use_uv: bool = True
    pitch_norm: str = "log"
    f0_mean: float = 0.0
    f0_std: float = 1.0
    use_midi: bool = False
    rel_pos: bool = False

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any], vocab_size: int) -> "FS2Config":
        unsupported = [k for k in ("use_energy_embed", "use_spk_id", "use_spk_embed")
                       if hp.get(k)]
        if not hp.get("use_pos_embed", True):
            unsupported.append("use_pos_embed=False")
        if hp.get("use_pitch_embed", True) and hp.get("pitch_type", "frame") != "frame":
            unsupported.append(f"pitch_type={hp.get('pitch_type')}")
        if hp.get("dur_loss", "mse") not in ("mse", "huber"):
            unsupported.append(f"dur_loss={hp.get('dur_loss')}")
        if hp.get("ffn_padding", "SAME") != "SAME":
            unsupported.append(f"ffn_padding={hp.get('ffn_padding')}")
        if str(hp.get("fs2_compute_dtype", "float32")) != "float32":
            unsupported.append("fs2_compute_dtype")
        if unsupported:
            raise NotImplementedError(
                f"the torch port does not cover {unsupported} yet")
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in hp.items() if k in fields}
        kw["vocab_size"] = vocab_size
        kw["out_dims"] = int(hp.get("audio_num_mel_bins", 80))
        kw["use_midi"] = bool(hp.get("use_midi", False))
        kw["rel_pos"] = bool(hp.get("rel_pos", False))
        if hp.get("f0_mean") is not None:
            kw["f0_mean"] = float(hp["f0_mean"])
        if hp.get("f0_std") is not None:
            kw["f0_std"] = float(hp["f0_std"])
        return cls(**kw)

    @property
    def pred_hidden(self) -> int:
        return self.predictor_hidden if self.predictor_hidden > 0 else self.hidden_size


class FastSpeech2(nn.Module):
    def __init__(self, cfg: FS2Config):
        super().__init__()
        c = self.cfg = cfg
        self.encoder = FastSpeechEncoder(c.vocab_size, c.hidden_size, c.enc_layers,
                                         c.enc_ffn_kernel_size, c.num_heads, c.ffn_act,
                                         c.dropout, rel_pos=c.rel_pos)
        self.decoder = FastSpeechDecoder(c.hidden_size, c.dec_layers,
                                         c.dec_ffn_kernel_size, c.num_heads, c.ffn_act,
                                         c.dropout)
        self.mel_out = xavier_linear(c.hidden_size, c.out_dims)
        self.dur_predictor = DurationPredictor(c.hidden_size, c.pred_hidden,
                                               c.dur_predictor_layers,
                                               c.dur_predictor_kernel,
                                               dropout=c.predictor_dropout)
        if c.use_pitch_embed:
            self.pitch_embed = Embedding(300, c.hidden_size, padding_idx=0)
            self.pitch_predictor = PitchPredictor(c.hidden_size, c.pred_hidden,
                                                  c.predictor_layers, odim=2,
                                                  kernel_size=c.predictor_kernel,
                                                  dropout=c.predictor_dropout)
        if c.use_midi:
            self.midi_embed = Embedding(300, c.hidden_size, padding_idx=0)
            self.midi_dur_layer = xavier_linear(1, c.hidden_size)
            self.is_slur_embed = Embedding(2, c.hidden_size)

    def _pred_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Same value; the gradient into the shared encoder is scaled by
        ``predictor_grad``."""
        sg = x.detach()
        return sg + self.cfg.predictor_grad * (x - sg)

    def add_pitch(self, pitch_inp: torch.Tensor, f0, uv, mel2ph: torch.Tensor,
                  ret: Dict[str, Any],
                  drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Frame-level pitch embedding from predicted or given F0."""
        c = self.cfg
        ret["pitch_pred"] = pitch_pred = self.pitch_predictor(self._pred_grad(pitch_inp),
                                                              drop_gen)
        if f0 is None:
            f0 = pitch_pred[:, :, 0]
        if c.use_uv and uv is None:
            uv = pitch_pred[:, :, 1] > 0
        ret["f0_denorm"] = f0_denorm = denorm_f0(
            f0, uv, pitch_norm=c.pitch_norm, f0_mean=c.f0_mean, f0_std=c.f0_std,
            use_uv=c.use_uv, pitch_padding=mel2ph == 0)
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def forward(self, txt_tokens: torch.Tensor, mel2ph: Optional[torch.Tensor] = None,
                f0=None, uv=None, t_mel: Optional[int] = None,
                skip_decoder: bool = False,
                drop_gen: Optional[torch.Generator] = None,
                pitch_midi: Optional[torch.Tensor] = None,
                midi_dur: Optional[torch.Tensor] = None,
                is_slur: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """``pitch_midi`` [B, T_txt] (MIDI numbers, 0 = pad), ``midi_dur``
        [B, T_txt] (note seconds) and ``is_slur`` [B, T_txt] are read when the
        config has ``use_midi``."""
        ret: Dict[str, Any] = {}
        extra_embed = None
        if self.cfg.use_midi:  # the encoder's extra_embed: note, duration, slur
            if pitch_midi is None:
                raise ValueError("a use_midi model needs pitch_midi")
            extra_embed = self.midi_embed(pitch_midi)
            if midi_dur is not None:
                extra_embed = extra_embed + self.midi_dur_layer(midi_dur[:, :, None])
            if is_slur is not None:
                extra_embed = extra_embed + self.is_slur_embed(is_slur)
        encoder_out = self.encoder(txt_tokens, extra_embed, drop_gen)
        src_padding = txt_tokens == 0
        src_nonpadding = (~src_padding).to(encoder_out.dtype)[:, :, None]
        log_dur = self.dur_predictor(self._pred_grad(encoder_out * src_nonpadding),
                                     src_padding, drop_gen)
        ret["dur"] = log_dur
        if mel2ph is None:
            if t_mel is None:
                raise ValueError("inference without mel2ph needs a static t_mel")
            mel2ph = length_regulator(self.dur_predictor.out2dur(log_dur), t_mel,
                                      dur_padding=src_padding)
        ret["mel2ph"] = mel2ph

        decoder_inp = expand_by_mel2ph(encoder_out, mel2ph)
        tgt_nonpadding = (mel2ph > 0).to(encoder_out.dtype)[:, :, None]
        if self.cfg.use_pitch_embed:
            decoder_inp = decoder_inp + self.add_pitch(
                decoder_inp * tgt_nonpadding, f0, uv, mel2ph, ret, drop_gen)
        ret["decoder_inp"] = decoder_inp = decoder_inp * tgt_nonpadding
        if skip_decoder:
            return ret
        x = self.decoder(decoder_inp, padding_mask=mel2ph == 0, drop_gen=drop_gen)
        ret["mel_out"] = self.mel_out(x) * tgt_nonpadding
        return ret
