"""Frozen copy of diffsinger_tpu_torch/models/fs2.py, the plain PyTorch math the
benchmark's reference runs; it imports nothing of the program.

FastSpeech2 acoustic model (counterpart of diffsinger_tpu/models/fs2.py).

Only what the benchmark's configurations run: pitch ``pitch_type: cwt`` (a
10-scale CWT spectrogram plus uv, and the utterance's log-F0 mean and std
from the first encoder frame; ``cwt2f0_norm`` turns them into normalized
F0), or no pitch embedding (``use_pitch_embed: false``, the e2e singing
configs); the MIDI encoder inputs (``use_midi``, with ESPnet's relative
positions under ``rel_pos``); the ``mse`` duration head; float32. Energy,
speakers, the ``frame`` and ``ph`` pitch heads and bf16 are left out, and a
configuration that asks for them is refused. Inference uses a static ``t_mel`` bucket for length regulation, as the JAX model does.
Training mode is the forward with ``drop_gen`` (a ``torch.Generator`` for the
dropout masks), given ``mel2ph``, ``f0``, ``uv`` and ``energy``, and usually
``skip_decoder=True`` (the diffusion conditioner). The predictors read their
inputs through the ``predictor_grad`` partial stop-gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .common import Embedding, xavier_linear
from .fft_blocks import FastSpeechDecoder, FastSpeechEncoder
from .predictors import (DurationPredictor, PitchPredictor,
                                                    expand_by_mel2ph, length_regulator)
from .cwt import cwt2f0
from .pitch import denorm_f0, f0_to_coarse, norm_f0


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
    ffn_padding: str = "SAME"
    out_dims: int = 80
    use_pos_embed: bool = True
    rel_pos: bool = False
    predictor_hidden: int = -1
    predictor_layers: int = 2
    predictor_kernel: int = 5
    dur_predictor_layers: int = 2
    dur_predictor_kernel: int = 3
    predictor_dropout: float = 0.5
    predictor_grad: float = 0.1
    use_pitch_embed: bool = True
    pitch_type: str = "cwt"
    use_uv: bool = True
    cwt_hidden_size: int = 128
    cwt_std_scale: float = 0.8
    pitch_norm: str = "log"
    f0_mean: float = 0.0
    f0_std: float = 1.0
    use_midi: bool = False

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any], vocab_size: int) -> "FS2Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in hp.items() if k in fields}
        kw["vocab_size"] = vocab_size
        kw["out_dims"] = int(hp.get("audio_num_mel_bins", 80))
        kw["use_midi"] = bool(hp.get("use_midi", False))
        kw["rel_pos"] = bool(hp.get("rel_pos", False))
        for k in ("f0_mean", "f0_std"):
            if hp.get(k) is not None:
                kw[k] = float(hp[k])
        left_out = {"use_pitch_embed with pitch_type != cwt":
                    hp.get("use_pitch_embed", True) and hp.get("pitch_type") != "cwt",
                    "dur_loss": hp.get("dur_loss", "mse") != "mse",
                    "use_energy_embed": hp.get("use_energy_embed"),
                    "use_spk_id": hp.get("use_spk_id"), "use_spk_embed": hp.get("use_spk_embed"),
                    "fs2_compute_dtype": hp.get("fs2_compute_dtype", "float32") != "float32"}
        asked = [k for k, v in left_out.items() if v]
        if asked:
            raise NotImplementedError(f"the reference leaves out {asked}")
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
                                         c.dropout, rel_pos=c.rel_pos,
                                         use_pos_embed=c.use_pos_embed,
                                         ffn_padding=c.ffn_padding)
        self.decoder = FastSpeechDecoder(c.hidden_size, c.dec_layers,
                                         c.dec_ffn_kernel_size, c.num_heads, c.ffn_act,
                                         c.dropout, ffn_padding=c.ffn_padding)
        self.mel_out = xavier_linear(c.hidden_size, c.out_dims)
        self.dur_predictor = DurationPredictor(c.hidden_size, c.pred_hidden,
                                               c.dur_predictor_layers,
                                               c.dur_predictor_kernel,
                                               dropout=c.predictor_dropout,
                                               padding=c.ffn_padding)
        if c.use_pitch_embed:
            self.pitch_embed = Embedding(300, c.hidden_size, padding_idx=0)
            # upstream keys: cwt_predictor.0 the input projection, .1 the
            # predictor; cwt_stats_layers.0/2/4 the statistics MLP
            self.cwt_predictor = nn.ModuleList([
                nn.Linear(c.hidden_size, c.cwt_hidden_size),
                PitchPredictor(c.cwt_hidden_size, c.pred_hidden, c.predictor_layers,
                               odim=11 if c.use_uv else 10, kernel_size=c.predictor_kernel,
                               dropout=c.predictor_dropout, padding=c.ffn_padding)])
            self.cwt_stats_layers = nn.Sequential(
                nn.Linear(c.hidden_size, c.cwt_hidden_size), nn.ReLU(),
                nn.Linear(c.cwt_hidden_size, c.cwt_hidden_size), nn.ReLU(),
                nn.Linear(c.cwt_hidden_size, 2))
        if c.use_midi:
            self.midi_embed = Embedding(300, c.hidden_size, padding_idx=0)
            self.midi_dur_layer = xavier_linear(1, c.hidden_size)
            self.is_slur_embed = Embedding(2, c.hidden_size)

    def _pred_grad(self, x: torch.Tensor) -> torch.Tensor:
        """Same value; the gradient into the shared encoder is scaled by
        ``predictor_grad``."""
        sg = x.detach()
        return sg + self.cfg.predictor_grad * (x - sg)

    def cwt2f0_norm(self, cwt_spec: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
        """CWT spectrogram [B, T, 10] and log-F0 mean / std [B] ->
        normalized F0 [B, T]."""
        c = self.cfg
        return norm_f0(cwt2f0(cwt_spec, mean, std), None, pitch_norm=c.pitch_norm,
                       f0_mean=c.f0_mean, f0_std=c.f0_std, use_uv=c.use_uv)

    def add_pitch(self, pitch_inp: torch.Tensor, f0, uv, ret: Dict[str, Any],
                  pitch_inp_ph: torch.Tensor,
                  drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pitch embedding [B, T_mel, H] from predicted or given F0.
        ``pitch_inp`` is the frame-level predictor input, ``pitch_inp_ph`` the
        phone-level one (the cwt statistics)."""
        c = self.cfg
        pitch_inp = self._pred_grad(pitch_inp)
        ret["cwt"] = cwt_out = self.cwt_predictor[1](self.cwt_predictor[0](pitch_inp),
                                                     drop_gen)
        stats = self.cwt_stats_layers(pitch_inp_ph[:, 0, :])
        mean = ret["f0_mean"] = stats[:, 0]
        std = ret["f0_std"] = stats[:, 1]
        if f0 is None:
            f0 = self.cwt2f0_norm(cwt_out[:, :, :10], mean, std * c.cwt_std_scale)
            if c.use_uv:
                uv = cwt_out[:, :, -1] > 0
        ret["f0_denorm"] = f0_denorm = denorm_f0(f0, uv, pitch_norm=c.pitch_norm,
                                                 f0_mean=c.f0_mean, f0_std=c.f0_std,
                                                 use_uv=c.use_uv)
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
        config has ``use_midi``. ``f0`` and ``uv`` are [B, T_mel]."""
        c = self.cfg
        ret: Dict[str, Any] = {}
        extra_embed = None
        if c.use_midi:  # the encoder's extra_embed: note, duration, slur
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

        dur_inp = self._pred_grad(encoder_out * src_nonpadding)
        ret["dur"] = log_dur = self.dur_predictor(dur_inp, src_padding, drop_gen)
        if mel2ph is None:
            if t_mel is None:
                raise ValueError("inference without mel2ph needs a static t_mel")
            ret["dur_choice"] = dur = self.dur_predictor.out2dur(log_dur)
            mel2ph = length_regulator(dur, t_mel, dur_padding=src_padding)
        ret["mel2ph"] = mel2ph

        decoder_inp = expand_by_mel2ph(encoder_out, mel2ph)
        tgt_nonpadding = (mel2ph > 0).to(encoder_out.dtype)[:, :, None]
        if c.use_pitch_embed:
            decoder_inp = decoder_inp + self.add_pitch(decoder_inp * tgt_nonpadding, f0, uv,
                                                       ret, encoder_out * src_nonpadding,
                                                       drop_gen)
        ret["decoder_inp"] = decoder_inp = decoder_inp * tgt_nonpadding
        if skip_decoder:
            return ret
        x = self.decoder(decoder_inp, padding_mask=mel2ph == 0, drop_gen=drop_gen)
        ret["mel_out"] = self.mel_out(x) * tgt_nonpadding
        return ret
