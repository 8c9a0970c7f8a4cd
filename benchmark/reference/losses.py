"""Frozen copy of the losses of diffsinger_tpu_torch/training/losses.py that
the benchmark's training cells run (DiffSpeech with cwt pitch, DiffSinger
with MIDI inputs), the plain PyTorch math of their reference; it imports
nothing of the program.

Phone, word and sentence duration losses with ``dur_loss: mse``, words from
silences or (the MIDI task) from ``word_boundary``, and the CWT pitch losses.
Word durations are a fixed-size segment sum (the word count is at most the
phone count), as in the JAX package. Every mean is over the whole batch.
"""

from __future__ import annotations

from typing import Dict

import torch

from .predictors import mel2ph_to_dur


def l1(x: torch.Tensor) -> torch.Tensor:
    """|x| with the JAX package's derivative at 0: +1, where torch's ``abs``
    gives 0. It matters where a prediction meets its target exactly, as the
    CWT head's output (0 at padding frames while its biases are 0) meets the
    zero padding of ``cwt_spec``."""
    return torch.where(x >= 0, x, -x)


def clamp0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the JAX package's derivative: 1/2 at x == 0, where
    ``torch.clamp`` gives 1. It matters at padded phones, whose predicted
    log-duration is exactly 0 (the head's output is masked there)."""
    return 0.5 * (x + x.abs())


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def masked_mean(x: torch.Tensor, w: torch.Tensor, clamp: bool = True) -> torch.Tensor:
    den = w.sum()
    return (x * w).sum() / (torch.clamp(den, min=1.0) if clamp else den)


def _word_dur_loss(dur_pred: torch.Tensor, dur_gt: torch.Tensor, word_id: torch.Tensor,
                   n_slots: int) -> torch.Tensor:
    """Squared log word-duration error over the words of the target: phone
    durations summed by ``word_id`` (slot 0 is dropped)."""
    b = dur_pred.shape[0]

    def seg(vals):
        zeros = torch.zeros((b, n_slots), dtype=vals.dtype, device=vals.device)
        return zeros.scatter_add(1, word_id, vals)[:, 1:]

    word_dur_p, word_dur_g = seg(dur_pred), seg(dur_gt)
    wdur = (torch.log(word_dur_p + 1) - torch.log(word_dur_g + 1)) ** 2
    return masked_mean(wdur, (word_dur_g > 0).to(torch.float32))


def duration_losses(losses: Dict[str, torch.Tensor], dur_pred_log: torch.Tensor,
                    mel2ph: torch.Tensor, txt_tokens: torch.Tensor,
                    is_sil: torch.Tensor, *, lambda_ph_dur: float = 1.0,
                    lambda_word_dur: float = 1.0, lambda_sent_dur: float = 1.0) -> None:
    """Phone (``pdur``), word (``wdur``) and sentence (``sdur``) duration
    losses. is_sil: [B, T_txt] 1.0 at silence phones."""
    t_txt = txt_tokens.shape[1]
    nonpadding = (txt_tokens != 0).to(torch.float32)
    dur_gt = mel2ph_to_dur(mel2ph, t_txt).to(torch.float32) * nonpadding
    pdur = (dur_pred_log - torch.log(dur_gt + 1)) ** 2
    losses["pdur"] = masked_mean(pdur, nonpadding, clamp=False) * lambda_ph_dur
    dur_pred = clamp0(torch.exp(dur_pred_log) - 1)

    if lambda_word_dur > 0:
        word_id = (torch.cumsum(is_sil, -1) * (1 - is_sil)).to(torch.long)
        losses["wdur"] = _word_dur_loss(dur_pred, dur_gt, word_id, t_txt + 1) * lambda_word_dur
    if lambda_sent_dur > 0:
        sdur = (torch.log(dur_pred.sum(-1) + 1) - torch.log(dur_gt.sum(-1) + 1)) ** 2
        losses["sdur"] = sdur.mean() * lambda_sent_dur


def midi_duration_loss(losses: Dict[str, torch.Tensor], dur_pred_log: torch.Tensor,
                       mel2ph: torch.Tensor, txt_tokens: torch.Tensor,
                       word_boundary: torch.Tensor, *, lambda_ph_dur: float = 1.0,
                       lambda_word_dur: float = 1.0, lambda_sent_dur: float = 0.0) -> None:
    """The MIDI task's duration losses: as :func:`duration_losses`, but a word
    ends at each phone whose ``word_boundary`` is 1 (word ids from the
    shifted cumsum, padding phones in slot 0, which is dropped)."""
    nonpadding = (txt_tokens != 0).to(torch.float32)
    dur_gt = mel2ph_to_dur(mel2ph, txt_tokens.shape[1]).to(torch.float32) * nonpadding
    pdur = (dur_pred_log - torch.log(dur_gt + 1)) ** 2
    losses["pdur"] = masked_mean(pdur, nonpadding, clamp=False) * lambda_ph_dur
    dur_pred = clamp0(torch.exp(dur_pred_log) - 1)

    if lambda_word_dur > 0:
        shifted = torch.nn.functional.pad(word_boundary, (1, 0))[:, :-1]
        word_id = torch.cumsum(shifted, -1).to(torch.long) + 1
        word_id = torch.where(txt_tokens == 0, torch.zeros_like(word_id), word_id)
        losses["wdur"] = (_word_dur_loss(dur_pred, dur_gt, word_id, txt_tokens.shape[1] + 2)
                          * lambda_word_dur)
    if lambda_sent_dur > 0:
        sdur = (torch.log(dur_pred.sum(-1) + 1) - torch.log(dur_gt.sum(-1) + 1)) ** 2
        losses["sdur"] = sdur.mean() * lambda_sent_dur


def cwt_pitch_loss(losses: Dict[str, torch.Tensor], output: Dict[str, torch.Tensor],
                   cwt_spec: torch.Tensor, f0_mean: torch.Tensor, f0_std: torch.Tensor,
                   uv: torch.Tensor, nonpadding: torch.Tensor, *, use_uv: bool = True,
                   lambda_f0: float = 1.0, lambda_uv: float = 1.0) -> None:
    """CWT-domain pitch losses: the spectrogram (``C``, over every frame of
    the batch, padding included, as upstream), voicing (``uv``) and the
    utterance log-F0 statistics (``f0_mean``, ``f0_std``)."""
    diff = output["cwt"][:, :, :10] - cwt_spec
    losses["C"] = l1(diff).mean() * lambda_f0
    if use_uv:
        bce = binary_cross_entropy_with_logits(output["cwt"][:, :, -1], uv)
        losses["uv"] = masked_mean(bce, nonpadding) * lambda_uv
    losses["f0_mean"] = l1(output["f0_mean"] - f0_mean).mean() * lambda_f0
    losses["f0_std"] = l1(output["f0_std"] - f0_std).mean() * lambda_f0
