"""FastSpeech2 acoustic model (counterpart of diffsinger_tpu/models/fs2.py).

Pitch: ``pitch_type`` ``frame`` (frame F0 and uv), ``ph`` (phone-level F0,
expanded to frames by ``mel2ph``) or ``cwt`` (a 10-scale CWT spectrogram
plus uv, and the utterance's log-F0 mean and std from the first encoder
frame; ``cwt2f0_norm`` turns them into normalized F0), with ``pitch_norm``
``log`` or ``standard``, or no pitch embedding (``use_pitch_embed: false``,
the e2e singing configs). Energy (``use_energy_embed``), speakers
(``use_spk_id`` with ``use_split_spk_id``, or ``use_spk_embed``) and the
MIDI encoder inputs (``use_midi``, with ESPnet's relative positions under
``rel_pos``) as in the JAX model; ``fs2_compute_dtype: bfloat16`` runs the
encoder's and decoder's projections in bf16 from float32 parameters.
``dur_loss: crf`` decodes durations by the CRF's Viterbi path (``dur_choice``).
Inference uses a static ``t_mel`` bucket for length regulation, as the JAX model does.
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

from diffsinger_tpu_torch.models.common import Embedding, xavier_linear
from diffsinger_tpu_torch.models.fft_blocks import FastSpeechDecoder, FastSpeechEncoder
from diffsinger_tpu_torch.models.predictors import (DurationPredictor, PitchPredictor,
                                                    expand_by_mel2ph, length_regulator)
from diffsinger_tpu_torch.utils.cwt import cwt2f0
from diffsinger_tpu_torch.utils.pitch import denorm_f0, f0_to_coarse, norm_f0

SPK_EMBED_DIM = 256  # width of a given speaker embedding (use_spk_embed)


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
    dur_loss: str = "mse"
    predictor_dropout: float = 0.5
    predictor_grad: float = 0.1
    use_pitch_embed: bool = True
    pitch_type: str = "ph"  # frame|ph|cwt
    use_uv: bool = True
    cwt_hidden_size: int = 128
    cwt_std_scale: float = 0.8
    pitch_norm: str = "log"
    f0_mean: float = 0.0
    f0_std: float = 1.0
    use_energy_embed: bool = False
    use_spk_id: bool = False
    use_split_spk_id: bool = False
    use_spk_embed: bool = False
    num_spk: int = 1
    use_midi: bool = False
    compute_dtype: str = "float32"  # the FFT stacks' (fs2_compute_dtype)

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any], vocab_size: int) -> "FS2Config":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in hp.items() if k in fields}
        kw["vocab_size"] = vocab_size
        kw["out_dims"] = int(hp.get("audio_num_mel_bins", 80))
        kw["use_midi"] = bool(hp.get("use_midi", False))
        kw["rel_pos"] = bool(hp.get("rel_pos", False))
        kw["compute_dtype"] = str(hp.get("fs2_compute_dtype", "float32"))
        if hp.get("f0_mean") is not None:
            kw["f0_mean"] = float(hp["f0_mean"])
        if hp.get("f0_std") is not None:
            kw["f0_std"] = float(hp["f0_std"])
        cfg = cls(**kw)
        if cfg.pitch_type not in ("frame", "ph", "cwt"):
            raise ValueError(f"pitch_type={cfg.pitch_type}")
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"fs2_compute_dtype={cfg.compute_dtype}")
        return cfg

    @property
    def pred_hidden(self) -> int:
        return self.predictor_hidden if self.predictor_hidden > 0 else self.hidden_size


class FastSpeech2(nn.Module):
    def __init__(self, cfg: FS2Config):
        super().__init__()
        c = self.cfg = cfg
        dtype = torch.bfloat16 if c.compute_dtype == "bfloat16" else None
        self.encoder = FastSpeechEncoder(c.vocab_size, c.hidden_size, c.enc_layers,
                                         c.enc_ffn_kernel_size, c.num_heads, c.ffn_act,
                                         c.dropout, rel_pos=c.rel_pos,
                                         use_pos_embed=c.use_pos_embed,
                                         ffn_padding=c.ffn_padding, dtype=dtype)
        self.decoder = FastSpeechDecoder(c.hidden_size, c.dec_layers,
                                         c.dec_ffn_kernel_size, c.num_heads, c.ffn_act,
                                         c.dropout, ffn_padding=c.ffn_padding, dtype=dtype)
        self.mel_out = xavier_linear(c.hidden_size, c.out_dims)
        self.dur_predictor = DurationPredictor(c.hidden_size, c.pred_hidden,
                                               c.dur_predictor_layers,
                                               c.dur_predictor_kernel,
                                               dropout=c.predictor_dropout,
                                               padding=c.ffn_padding, dur_loss=c.dur_loss)
        if c.use_spk_id:
            self.spk_embed_proj = Embedding(c.num_spk + 1, c.hidden_size)
            if c.use_split_spk_id:
                self.spk_embed_f0 = Embedding(c.num_spk + 1, c.hidden_size)
                self.spk_embed_dur = Embedding(c.num_spk + 1, c.hidden_size)
        elif c.use_spk_embed:
            self.spk_embed_proj = xavier_linear(SPK_EMBED_DIM, c.hidden_size)

        def predictor(in_dims: int, odim: int) -> PitchPredictor:
            return PitchPredictor(in_dims, c.pred_hidden, c.predictor_layers, odim=odim,
                                  kernel_size=c.predictor_kernel,
                                  dropout=c.predictor_dropout, padding=c.ffn_padding)

        if c.use_pitch_embed:
            self.pitch_embed = Embedding(300, c.hidden_size, padding_idx=0)
            if c.pitch_type == "cwt":
                # upstream keys: cwt_predictor.0 the input projection, .1 the
                # predictor; cwt_stats_layers.0/2/4 the statistics MLP
                self.cwt_predictor = nn.ModuleList([
                    nn.Linear(c.hidden_size, c.cwt_hidden_size),
                    predictor(c.cwt_hidden_size, 11 if c.use_uv else 10)])
                self.cwt_stats_layers = nn.Sequential(
                    nn.Linear(c.hidden_size, c.cwt_hidden_size), nn.ReLU(),
                    nn.Linear(c.cwt_hidden_size, c.cwt_hidden_size), nn.ReLU(),
                    nn.Linear(c.cwt_hidden_size, 2))
            else:
                self.pitch_predictor = predictor(c.hidden_size,
                                                 2 if c.pitch_type == "frame" else 1)
        if c.use_energy_embed:
            self.energy_embed = Embedding(256, c.hidden_size, padding_idx=0)
            self.energy_predictor = predictor(c.hidden_size, 1)
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

    def add_pitch(self, pitch_inp: torch.Tensor, f0, uv, mel2ph: torch.Tensor,
                  ret: Dict[str, Any], pitch_inp_ph: torch.Tensor,
                  drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Pitch embedding [B, T_mel, H] from predicted or given F0.
        ``pitch_inp`` is the frame-level predictor input, ``pitch_inp_ph`` the
        phone-level one (ph pitch, the cwt statistics)."""
        c = self.cfg
        nf = dict(pitch_norm=c.pitch_norm, f0_mean=c.f0_mean, f0_std=c.f0_std,
                  use_uv=c.use_uv)
        if c.pitch_type == "ph":
            ret["pitch_pred"] = pitch_pred = self.pitch_predictor(
                self._pred_grad(pitch_inp_ph), drop_gen)
            if f0 is None:
                f0 = pitch_pred[:, :, 0]
            ret["f0_denorm"] = f0_denorm = denorm_f0(f0, None, **nf)
            pitch = torch.nn.functional.pad(f0_to_coarse(f0_denorm), (1, 0))
            return self.pitch_embed(torch.gather(pitch, 1, mel2ph))

        pitch_inp = self._pred_grad(pitch_inp)
        pitch_padding = mel2ph == 0
        if c.pitch_type == "cwt":
            pitch_padding = None
            ret["cwt"] = cwt_out = self.cwt_predictor[1](self.cwt_predictor[0](pitch_inp),
                                                         drop_gen)
            stats = self.cwt_stats_layers(pitch_inp_ph[:, 0, :])
            mean = ret["f0_mean"] = stats[:, 0]
            std = ret["f0_std"] = stats[:, 1]
            if f0 is None:
                f0 = self.cwt2f0_norm(cwt_out[:, :, :10], mean, std * c.cwt_std_scale)
                if c.use_uv:
                    uv = cwt_out[:, :, -1] > 0
        else:  # frame
            ret["pitch_pred"] = pitch_pred = self.pitch_predictor(pitch_inp, drop_gen)
            if f0 is None:
                f0 = pitch_pred[:, :, 0]
            if c.use_uv and uv is None:
                uv = pitch_pred[:, :, 1] > 0
        ret["f0_denorm"] = f0_denorm = denorm_f0(f0, uv, pitch_padding=pitch_padding, **nf)
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def add_energy(self, pitch_inp: torch.Tensor, energy, ret: Dict[str, Any],
                   drop_gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Energy embedding from predicted or given frame energy, quantized to
        min(energy * 256 // 4, 255). A negative energy (seeded weights predict
        some) gives a negative id, read as the JAX embedding reads it."""
        ret["energy_pred"] = energy_pred = self.energy_predictor(
            self._pred_grad(pitch_inp), drop_gen)[:, :, 0]
        if energy is None:
            energy = energy_pred
        energy_q = torch.clamp(torch.div(energy * 256, 4, rounding_mode="floor"), max=255)
        return self.energy_embed.take(energy_q.to(torch.long))

    def _speaker(self, spk_embed, spk_embed_dur_id, spk_embed_f0_id):
        """(decoder, duration, pitch) speaker terms, each [B, 1, H] or 0."""
        c = self.cfg
        if c.use_spk_embed:
            s = self.spk_embed_proj(spk_embed)[:, None, :]
            return s, s, s
        if c.use_spk_id:
            s = self.spk_embed_proj(spk_embed)[:, None, :]
            if not c.use_split_spk_id:
                return s, s, s
            dur_id = spk_embed if spk_embed_dur_id is None else spk_embed_dur_id
            f0_id = spk_embed if spk_embed_f0_id is None else spk_embed_f0_id
            return (s, self.spk_embed_dur(dur_id)[:, None, :],
                    self.spk_embed_f0(f0_id)[:, None, :])
        return 0, 0, 0

    def forward(self, txt_tokens: torch.Tensor, mel2ph: Optional[torch.Tensor] = None,
                f0=None, uv=None, t_mel: Optional[int] = None,
                skip_decoder: bool = False,
                drop_gen: Optional[torch.Generator] = None,
                pitch_midi: Optional[torch.Tensor] = None,
                midi_dur: Optional[torch.Tensor] = None,
                is_slur: Optional[torch.Tensor] = None,
                spk_embed: Optional[torch.Tensor] = None,
                energy: Optional[torch.Tensor] = None,
                spk_embed_dur_id: Optional[torch.Tensor] = None,
                spk_embed_f0_id: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """``pitch_midi`` [B, T_txt] (MIDI numbers, 0 = pad), ``midi_dur``
        [B, T_txt] (note seconds) and ``is_slur`` [B, T_txt] are read when the
        config has ``use_midi``. ``spk_embed`` is the speaker: ids [B] with
        ``use_spk_id`` (``spk_embed_dur_id`` / ``spk_embed_f0_id`` override
        them for the split embeddings), an embedding [B, 256] with
        ``use_spk_embed``. ``f0`` is [B, T_txt] for ph pitch, else [B, T_mel];
        ``energy`` [B, T_mel]."""
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
        spk, spk_dur, spk_f0 = self._speaker(spk_embed, spk_embed_dur_id, spk_embed_f0_id)

        dur_inp = self._pred_grad((encoder_out + spk_dur) * src_nonpadding)
        ret["dur"] = log_dur = self.dur_predictor(dur_inp, src_padding, drop_gen)
        if mel2ph is None:
            if t_mel is None:
                raise ValueError("inference without mel2ph needs a static t_mel")
            ret["dur_choice"] = dur = self.dur_predictor.decode(log_dur, src_padding)
            mel2ph = length_regulator(dur, t_mel, dur_padding=src_padding)
        ret["mel2ph"] = mel2ph

        decoder_inp = expand_by_mel2ph(encoder_out, mel2ph)
        tgt_nonpadding = (mel2ph > 0).to(encoder_out.dtype)[:, :, None]
        pitch_inp = (decoder_inp + spk_f0) * tgt_nonpadding
        if c.use_pitch_embed:
            pitch_inp_ph = (encoder_out + spk_f0) * src_nonpadding
            decoder_inp = decoder_inp + self.add_pitch(pitch_inp, f0, uv, mel2ph, ret,
                                                       pitch_inp_ph, drop_gen)
        if c.use_energy_embed:
            decoder_inp = decoder_inp + self.add_energy(pitch_inp, energy, ret, drop_gen)
        ret["decoder_inp"] = decoder_inp = (decoder_inp + spk) * tgt_nonpadding
        if skip_decoder:
            return ret
        x = self.decoder(decoder_inp, padding_mask=mel2ph == 0, drop_gen=drop_gen)
        ret["mel_out"] = self.mel_out(x) * tgt_nonpadding
        return ret
