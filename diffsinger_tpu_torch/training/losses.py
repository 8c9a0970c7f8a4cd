"""Losses of the FS2, diffusion and MIDI tasks (counterpart of
diffsinger_tpu/training/losses.py): the mel l1 and ssim losses and their
``mel_loss`` spec, phone, word and sentence duration losses with ``dur_loss:
mse`` (words from silences, or from ``word_boundary`` for MIDI), the
frame-level f0/uv loss, the phone-level and CWT pitch losses, the energy
loss, and ``binary_cross_entropy_with_logits``. ``dur_loss: crf`` is not
ported.

Word durations are a fixed-size segment sum (the word count is at most the
phone count), as in the JAX package.

Every mean is over the global batch: a masked mean divides by the data
group's summed mask and an unmasked one by the global element count
(``parallel/mesh.py``), so under data parallelism the ranks' losses add up
to the one-process loss on the (padded) global batch. Outside a data mesh
they are the plain means.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from diffsinger_tpu_torch.models.predictors import mel2ph_to_dur
from diffsinger_tpu_torch.ops.ssim import ssim
from diffsinger_tpu_torch.parallel.mesh import global_mean, masked_mean


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


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """[B, T, M] -> same-shape mask, 1 at frames that are not all zero."""
    return (target.abs().sum(-1, keepdim=True) > 0).to(target.dtype).expand_as(target)


def mel_l1_loss(mel_out: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return masked_mean(l1(mel_out - target), weights_nonzero_speech(target))


def mel_ssim_loss(mel_out: torch.Tensor, target: torch.Tensor,
                  bias: float = 6.0) -> torch.Tensor:
    """1 - SSIM per element of the mels shifted by ``bias``, over non-zero
    target frames."""
    ssim_map = 1 - ssim(mel_out + bias, target + bias, reduce_mean=False)
    return masked_mean(ssim_map, weights_nonzero_speech(target))


def parse_mel_loss(spec: str) -> Dict[str, float]:
    """'ssim:0.5|l1:0.5' -> {'ssim': 0.5, 'l1': 0.5}; a bare name weighs 1."""
    out = {}
    for part in spec.split("|"):
        if ":" in part:
            name, lbd = part.split(":")
            out[name] = float(lbd)
        else:
            out[part] = 1.0
    return out


def add_mel_losses(losses: Dict[str, torch.Tensor], mel_out: torch.Tensor,
                   target: torch.Tensor, mel_loss_spec: str = "l1",
                   postfix: str = "") -> None:
    """The ``mel_loss`` terms, each under its own name; an unknown name raises."""
    fns = {"l1": mel_l1_loss, "ssim": mel_ssim_loss}
    for name, lbd in parse_mel_loss(mel_loss_spec).items():
        if name not in fns:
            raise NotImplementedError(name)
        losses[f"{name}{postfix}"] = fns[name](mel_out, target) * lbd


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
                    lambda_word_dur: float = 1.0, lambda_sent_dur: float = 1.0,
                    dur_loss: str = "mse", crf=None) -> None:
    """Phone (``pdur``), word (``wdur``) and sentence (``sdur``) duration
    losses. is_sil: [B, T_txt] 1.0 at silence phones.

    ``dur_loss='crf'``: ``dur_pred_log`` holds the emissions [B, T_txt, 32]
    and ``pdur`` is the mean CRF negative log likelihood of the durations
    clamped to 0-31 under ``crf`` (the head's ``LinearChainCRF``), with the
    first phone of every row counted as valid. The word and sentence terms
    need linear-scale predicted durations, which the CRF head has no
    differentiable form of: they are skipped."""
    t_txt = txt_tokens.shape[1]
    nonpadding = (txt_tokens != 0).to(torch.float32)
    dur_gt = mel2ph_to_dur(mel2ph, t_txt).to(torch.float32) * nonpadding
    if dur_loss == "crf":
        tags = torch.clamp(dur_gt.to(torch.long), 0, 31)
        mask = txt_tokens != 0
        mask[:, 0] = True
        losses["pdur"] = -global_mean(crf.log_likelihood(dur_pred_log, tags, mask)) * lambda_ph_dur
        return
    if dur_loss != "mse":
        raise NotImplementedError(dur_loss)
    pdur = (dur_pred_log - torch.log(dur_gt + 1)) ** 2
    losses["pdur"] = masked_mean(pdur, nonpadding, clamp=False) * lambda_ph_dur
    dur_pred = clamp0(torch.exp(dur_pred_log) - 1)

    if lambda_word_dur > 0:
        word_id = (torch.cumsum(is_sil, -1) * (1 - is_sil)).to(torch.long)
        losses["wdur"] = _word_dur_loss(dur_pred, dur_gt, word_id, t_txt + 1) * lambda_word_dur
    if lambda_sent_dur > 0:
        sdur = (torch.log(dur_pred.sum(-1) + 1) - torch.log(dur_gt.sum(-1) + 1)) ** 2
        losses["sdur"] = global_mean(sdur) * lambda_sent_dur


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
        losses["sdur"] = global_mean(sdur) * lambda_sent_dur


def f0_loss(losses: Dict[str, torch.Tensor], pitch_pred: torch.Tensor, f0: torch.Tensor,
            uv: Optional[torch.Tensor], nonpadding: torch.Tensor, *,
            use_uv: bool = True, pitch_loss: str = "l1", lambda_f0: float = 1.0,
            lambda_uv: float = 1.0) -> None:
    """Frame-level f0 (``f0``) and voicing (``uv``) losses."""
    if use_uv and uv is not None:
        bce = binary_cross_entropy_with_logits(pitch_pred[:, :, 1], uv)
        losses["uv"] = masked_mean(bce, nonpadding) * lambda_uv
        nonpadding = nonpadding * (uv == 0).to(torch.float32)
    f0_pred = pitch_pred[:, :, 0]
    err = l1(f0_pred - f0) if pitch_loss == "l1" else (f0_pred - f0) ** 2
    losses["f0"] = masked_mean(err, nonpadding) * lambda_f0


def ph_pitch_loss(losses: Dict[str, torch.Tensor], pitch_pred: torch.Tensor,
                  f0_ph: torch.Tensor, txt_tokens: torch.Tensor, *,
                  pitch_loss: str = "l1", lambda_f0: float = 1.0) -> None:
    """Phone-level f0 loss (``f0``): f0_ph [B, T_txt] normalized F0."""
    nonpadding = (txt_tokens != 0).to(torch.float32)
    diff = pitch_pred[:, :, 0] - f0_ph
    err = l1(diff) if pitch_loss == "l1" else diff ** 2
    losses["f0"] = masked_mean(err, nonpadding, clamp=False) * lambda_f0


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
        losses["C"] = global_mean(l1(diff)) * lambda_f0
    elif cwt_loss == "l2":
        losses["C"] = global_mean(diff ** 2) * lambda_f0
    else:
        raise NotImplementedError(cwt_loss)
    if use_uv:
        bce = binary_cross_entropy_with_logits(output["cwt"][:, :, -1], uv)
        losses["uv"] = masked_mean(bce, nonpadding) * lambda_uv
    losses["f0_mean"] = global_mean(l1(output["f0_mean"] - f0_mean)) * lambda_f0
    losses["f0_std"] = global_mean(l1(output["f0_std"] - f0_std)) * lambda_f0


def energy_loss(losses: Dict[str, torch.Tensor], energy_pred: torch.Tensor,
                energy: torch.Tensor, *, lambda_energy: float = 0.1) -> None:
    """Frame energy loss (``e``), squared error over frames of nonzero energy."""
    err = masked_mean((energy_pred - energy) ** 2, (energy != 0).to(torch.float32))
    losses["e"] = err * lambda_energy
