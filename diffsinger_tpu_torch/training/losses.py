"""Losses of the DiffSpeech task (counterpart of
diffsinger_tpu/training/losses.py, the subset this task calls): phone, word
and sentence duration losses with ``dur_loss: mse``, the frame-level f0/uv
loss, the phone-level and CWT pitch losses, the energy loss, and
``binary_cross_entropy_with_logits``.

Word durations are a fixed-size ``[B, T_txt + 1]`` segment sum (the word
count is at most the phone count), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from diffsinger_tpu_torch.models.predictors import mel2ph_to_dur


def l1(x: torch.Tensor) -> torch.Tensor:
    """|x| with the JAX package's derivative at 0: +1, where torch's ``abs``
    gives 0. It matters where a prediction meets its target exactly, as the
    CWT head's output (0 at padding frames while its biases are 0) meets the
    zero padding of ``cwt_spec``."""
    return torch.where(x >= 0, x, -x)


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def duration_losses(losses: Dict[str, torch.Tensor], dur_pred_log: torch.Tensor,
                    mel2ph: torch.Tensor, txt_tokens: torch.Tensor,
                    is_sil: torch.Tensor, *, lambda_ph_dur: float = 1.0,
                    lambda_word_dur: float = 1.0, lambda_sent_dur: float = 1.0,
                    dur_loss: str = "mse") -> None:
    """Phone (``pdur``), word (``wdur``) and sentence (``sdur``) duration
    losses. is_sil: [B, T_txt] 1.0 at silence phones."""
    if dur_loss != "mse":
        raise NotImplementedError(f"dur_loss={dur_loss} is not ported yet")
    b, t_txt = txt_tokens.shape
    nonpadding = (txt_tokens != 0).to(torch.float32)
    dur_gt = mel2ph_to_dur(mel2ph, t_txt).to(torch.float32) * nonpadding
    pdur = (dur_pred_log - torch.log(dur_gt + 1)) ** 2
    losses["pdur"] = (pdur * nonpadding).sum() / nonpadding.sum() * lambda_ph_dur
    dur_pred = torch.clamp(torch.exp(dur_pred_log) - 1, min=0)

    if lambda_word_dur > 0:
        word_id = (torch.cumsum(is_sil, -1) * (1 - is_sil)).to(torch.long)

        def seg(vals):
            zeros = torch.zeros((b, t_txt + 1), dtype=torch.float32, device=vals.device)
            return zeros.scatter_add(1, word_id, vals)[:, 1:]

        word_dur_p, word_dur_g = seg(dur_pred), seg(dur_gt)
        wdur = (torch.log(word_dur_p + 1) - torch.log(word_dur_g + 1)) ** 2
        word_nonpadding = (word_dur_g > 0).to(torch.float32)
        losses["wdur"] = ((wdur * word_nonpadding).sum()
                          / torch.clamp(word_nonpadding.sum(), min=1.0) * lambda_word_dur)
    if lambda_sent_dur > 0:
        sdur = (torch.log(dur_pred.sum(-1) + 1) - torch.log(dur_gt.sum(-1) + 1)) ** 2
        losses["sdur"] = sdur.mean() * lambda_sent_dur


def f0_loss(losses: Dict[str, torch.Tensor], pitch_pred: torch.Tensor, f0: torch.Tensor,
            uv: Optional[torch.Tensor], nonpadding: torch.Tensor, *,
            use_uv: bool = True, pitch_loss: str = "l1", lambda_f0: float = 1.0,
            lambda_uv: float = 1.0) -> None:
    """Frame-level f0 (``f0``) and voicing (``uv``) losses."""
    if use_uv and uv is not None:
        bce = binary_cross_entropy_with_logits(pitch_pred[:, :, 1], uv)
        losses["uv"] = ((bce * nonpadding).sum()
                        / torch.clamp(nonpadding.sum(), min=1.0) * lambda_uv)
        nonpadding = nonpadding * (uv == 0).to(torch.float32)
    f0_pred = pitch_pred[:, :, 0]
    err = l1(f0_pred - f0) if pitch_loss == "l1" else (f0_pred - f0) ** 2
    losses["f0"] = (err * nonpadding).sum() / torch.clamp(nonpadding.sum(), min=1.0) * lambda_f0


def ph_pitch_loss(losses: Dict[str, torch.Tensor], pitch_pred: torch.Tensor,
                  f0_ph: torch.Tensor, txt_tokens: torch.Tensor, *,
                  pitch_loss: str = "l1", lambda_f0: float = 1.0) -> None:
    """Phone-level f0 loss (``f0``): f0_ph [B, T_txt] normalized F0."""
    nonpadding = (txt_tokens != 0).to(torch.float32)
    diff = pitch_pred[:, :, 0] - f0_ph
    err = l1(diff) if pitch_loss == "l1" else diff ** 2
    losses["f0"] = (err * nonpadding).sum() / nonpadding.sum() * lambda_f0


def cwt_pitch_loss(losses: Dict[str, torch.Tensor], output: Dict[str, torch.Tensor],
                   cwt_spec: torch.Tensor, f0_mean: torch.Tensor, f0_std: torch.Tensor,
                   uv: torch.Tensor, nonpadding: torch.Tensor, *, use_uv: bool = True,
                   cwt_loss: str = "l1", lambda_f0: float = 1.0,
                   lambda_uv: float = 1.0) -> None:
    """CWT-domain pitch losses: the spectrogram (``C``, over every frame of
    the batch, padding included, as upstream), voicing (``uv``) and the
    utterance log-F0 statistics (``f0_mean``, ``f0_std``)."""
    diff = output["cwt"][:, :, :10] - cwt_spec
    if cwt_loss == "l1":
        losses["C"] = l1(diff).mean() * lambda_f0
    elif cwt_loss == "l2":
        losses["C"] = (diff ** 2).mean() * lambda_f0
    else:
        raise NotImplementedError(cwt_loss)
    if use_uv:
        bce = binary_cross_entropy_with_logits(output["cwt"][:, :, -1], uv)
        losses["uv"] = ((bce * nonpadding).sum()
                        / torch.clamp(nonpadding.sum(), min=1.0) * lambda_uv)
    losses["f0_mean"] = l1(output["f0_mean"] - f0_mean).mean() * lambda_f0
    losses["f0_std"] = l1(output["f0_std"] - f0_std).mean() * lambda_f0


def energy_loss(losses: Dict[str, torch.Tensor], energy_pred: torch.Tensor,
                energy: torch.Tensor, *, lambda_energy: float = 0.1) -> None:
    """Frame energy loss (``e``), squared error over frames of nonzero energy."""
    nonpadding = (energy != 0).to(torch.float32)
    err = ((energy_pred - energy) ** 2 * nonpadding).sum() / torch.clamp(
        nonpadding.sum(), min=1.0)
    losses["e"] = err * lambda_energy
