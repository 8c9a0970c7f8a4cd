"""Faults a cell can have, each a context that plants it in the program for
the length of a run: ``correct`` has to come out false under every one (the
CPU tests in ``tests/test_bench_faults.py``), and a training cell's limits
take their upper readings from them as read on the chip (``run.py
--readings N --fault <name>``). One chip: there is no exchange between chips
to leave out."""

from __future__ import annotations

from unittest import mock


def altered_answer():
    """The vocoder's first waveform row moved by 1e-3 where it is made."""
    from diffsinger_tpu_torch.inference import vocoder

    orig = vocoder.hifigan_mrf_apply

    def fault(*a, **kw):
        wav = orig(*a, **kw)
        wav[0] = wav[0] + 1e-3
        return wav

    return mock.patch.object(vocoder, "hifigan_mrf_apply", fault)


def half_batch():
    """The stack computes the first half of a batch's rows and repeats them
    in place of the rest."""
    from diffsinger_tpu_torch.ops import diffnet_stack as ds

    orig = ds.diffnet_stack

    def fault(x0, step_proj, cond_proj, *rest, **kw):
        b = x0.shape[0]
        h = max(b // 2, 1)
        out = orig(x0[:h], step_proj[:, :h], cond_proj[:, :h], *rest, **kw)
        return out.repeat((-(-b // h), 1, 1))[:b]

    return mock.patch.object(ds, "diffnet_stack", fault)


def unchanged_step():
    """Every reverse step returns its state unchanged."""
    from diffsinger_tpu_torch.models.diffusion import GaussianDiffusion

    return mock.patch.multiple(GaussianDiffusion,
                               p_sample_step=lambda self, x, *a, **k: x,
                               _plms_x_pred=lambda self, x, *a, **k: x)


def train_unchanged_state():
    """The optimizer's step leaves the state unchanged."""
    from diffsinger_tpu_torch.training.trainer import Optimizer

    return mock.patch.object(Optimizer, "step", lambda self, grads, norm: None)


def train_half_batch():
    """Half of the batch left out: the loss the mean over the rest."""
    from diffsinger_tpu_torch.training.tasks import DiffSingerTask

    orig = DiffSingerTask.train_loss

    def fault(self, batch, t=None, noise=None, **kw):
        h = max(len(t) // 2, 1)
        half = {k: v[:h] if getattr(v, "ndim", 0) >= 1 else v for k, v in batch.items()}
        return orig(self, half, t=t[:h], noise=noise[:h], **kw)

    return mock.patch.object(DiffSingerTask, "train_loss", fault)


def train_altered_loss():
    """The loss moved by 1e-3 of itself where the task makes it."""
    from diffsinger_tpu_torch.training.trainer import Trainer

    orig = Trainer._task_loss

    def fault(self, *a, **kw):
        total, losses, state = orig(self, *a, **kw)
        return total + 1e-3 * total.detach().abs(), losses, state

    return mock.patch.object(Trainer, "_task_loss", fault)


SERVING = {"altered_answer": altered_answer, "half_batch": half_batch,
           "unchanged_step": unchanged_step}
TRAINING = {"train_unchanged_state": train_unchanged_state,
            "train_half_batch": train_half_batch, "train_altered_loss": train_altered_loss}
ALL = {**SERVING, **TRAINING}
