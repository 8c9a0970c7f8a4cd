"""One training step of the diffusion task in plain PyTorch: the FS2 training
forward on the batch's durations (with cwt pitch, the F0 its CWT spectrogram
gives; with MIDI inputs, the notes, their lengths and slurs), its dropout
drawn from the caller's generator, in the model's own order; the diffusion
loss through the plain DiffNet; the duration losses (the MIDI task's words
from ``word_boundary``, else from silences) and, with a pitch embedding, the
cwt pitch losses; gradients of the trainable parameters, global-norm clipping
and ``torch.optim.AdamW`` at the schedule's rate. A configuration that trains
what this step leaves out is refused when the step is built (``refuse_left_out``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from . import losses as L
from .schedules import build_lr_schedule
from .system import System


def refuse_left_out(hp: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` naming what the configuration would
    train that this step does not implement, so that the reference never
    drops a loss term or an update silently. The model's own pieces (frame
    or phone pitch with an embedding, energy, speakers, another duration
    loss) are refused where the reference's FS2 is built."""
    pitch = bool(hp.get("use_pitch_embed"))
    asked = {"cwt_loss other than l1": pitch and hp.get("cwt_loss", "l1") != "l1",
             "switch_midi2f0_step with a pitch embedding":
             pitch and hp.get("switch_midi2f0_step") is not None,
             "diff_decoder_type other than wavenet":
             hp.get("diff_decoder_type", "wavenet") != "wavenet",
             "accumulate_grad_batches": int(hp.get("accumulate_grad_batches") or 1) != 1}
    named = [k for k, v in asked.items() if v]
    if named:
        raise NotImplementedError(f"the training reference leaves out {named}")


def trainable_rule(hp: Dict[str, Any]) -> Callable[[str], bool]:
    """Warm-started from ``fs2_ckpt``, FS2 trains only its predictors (but
    the cwt input projection), or nothing with ``freeze_fs2_all``."""
    if not hp.get("fs2_ckpt"):
        return lambda name: True
    freeze_all = bool(hp.get("freeze_fs2_all", hp.get("task_cls", "").find("DiffSpeech") < 0))

    def rule(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != "fs2":
            return True
        if parts[1:3] == ["cwt_predictor", "0"]:
            return False
        return not freeze_all and any("predictor" in p for p in parts)

    return rule


class TrainStep:
    """The optimizer steps of ``system``'s FS2 and denoiser."""

    def __init__(self, system: System):
        self.sys, hp = system, system.hp
        refuse_left_out(hp)
        rule = trainable_rule(hp)
        named = [(n, p) for n, p in system.named_parameters()
                 if n.split(".")[0] in ("fs2", "denoise_fn")]
        for n, p in named:
            p.requires_grad_(rule(n))
        self.names = [n for n, p in named if p.requires_grad]
        self.params = [p for n, p in named if p.requires_grad]
        self.schedule = build_lr_schedule(hp)
        self.clip = float(hp.get("clip_grad_norm", 0) or 0)
        self.adamw = torch.optim.AdamW(
            self.params, lr=self.schedule(0),
            betas=(float(hp.get("optimizer_adam_beta1", 0.9)),
                   float(hp.get("optimizer_adam_beta2", 0.98))),
            eps=1e-8, weight_decay=float(hp.get("weight_decay", 0.0)))
        self.updates = 0

    def loss(self, batch: Dict[str, torch.Tensor], t: torch.Tensor, noise: torch.Tensor,
             drop_gen: torch.Generator) -> Dict[str, torch.Tensor]:
        s, hp = self.sys, self.sys.hp
        fs2 = s.fs2
        midi = {k: batch[k] for k in ("pitch_midi", "midi_dur", "is_slur")} \
            if hp.get("use_midi") else {}
        f0 = (fs2.cwt2f0_norm(batch["cwt_spec"], batch["f0_mean"], batch["f0_std"])
              if hp.get("pitch_type") == "cwt" else batch["f0"])
        ret = fs2(batch["txt_tokens"], mel2ph=batch["mel2ph"], f0=f0, uv=batch["uv"],
                  skip_decoder=True, drop_gen=drop_gen, **midi)
        losses = {"mel": s.gd.training_loss(lambda x, tt, c: s.denoise_fn(x, tt, c),
                                            batch["mels"], t, ret["decoder_inp"], noise)}
        txt, mel2ph = batch["txt_tokens"], batch["mel2ph"]
        lambdas = dict(lambda_ph_dur=hp.get("lambda_ph_dur", 1.0),
                       lambda_word_dur=hp.get("lambda_word_dur", 1.0),
                       lambda_sent_dur=hp.get("lambda_sent_dur", 1.0))
        if hp.get("use_midi"):
            L.midi_duration_loss(losses, ret["dur"], mel2ph, txt, batch["word_boundary"],
                                 **lambdas)
        else:
            L.duration_losses(losses, ret["dur"], mel2ph, txt,
                              torch.zeros_like(txt, dtype=torch.float32), **lambdas)
        if hp.get("use_pitch_embed"):
            L.cwt_pitch_loss(losses, ret, batch["cwt_spec"], batch["f0_mean"],
                             batch["f0_std"], batch["uv"], (mel2ph != 0).to(torch.float32),
                             use_uv=hp.get("use_uv", True), lambda_uv=hp.get("lambda_uv", 1.0),
                             lambda_f0=hp.get("lambda_f0", 1.0))
        return losses

    def step(self, batch: Dict[str, torch.Tensor], t: torch.Tensor, noise: torch.Tensor,
             drop_gen: torch.Generator) -> float:
        """One update; returns the total loss."""
        losses = self.loss(batch, t, noise, drop_gen)
        total = sum(losses.values())
        grads: List[torch.Tensor] = list(torch.autograd.grad(total, self.params,
                                                             allow_unused=True))
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        self.last_norm = float(norm)
        if self.clip > 0:
            scale = torch.clamp(self.clip / norm, max=1.0)
            grads = [g * scale for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.updates += 1
        return float(total.detach())
