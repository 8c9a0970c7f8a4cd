"""Train or infer from the command line (counterpart of diffsinger_tpu/cli.py):

    python -m diffsinger_tpu_torch.cli --config <yaml> --exp_name <name> \\
        [--infer] [--reset] [--hparams k=v,...]

The config's ``task_cls`` picks the task (``training/tasks.py:build_task``:
diffusion, FastSpeech2 or PitchExtractor). The run's directory is
``checkpoints/<exp_name>``: ``--config`` is resolved with its saved
``config.yaml``; training (``Trainer.fit``) validates and
writes ``model_ckpt_steps_*.ckpt`` there and resumes from the newest one;
``--infer`` synthesizes the test split from it into ``generated_*``. It runs
on the card: ``run``, ``train`` and ``infer`` take a ``device`` (default
CUDA; raises without one).

Data and tensor parallel training: ``torchrun --nproc_per_node N -m
diffsinger_tpu_torch.cli --config <yaml> --exp_name <name>`` (one process
per card; ``num_model_shards`` splits the ranks into data x model, and
``tp_min_param_size`` is the smallest parameter the model axis shards).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from diffsinger_tpu_torch.utils.device import resolve_device


def maybe_init_distributed(hp: Dict[str, Any], device="cuda") -> bool:
    """Start the default process group when the process was launched for one
    (torchrun's ``WORLD_SIZE`` > 1, or ``multi_host: true`` with torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``): NCCL for
    the card, gloo for ``device="cpu"``; a card rank then runs on
    ``cuda:{LOCAL_RANK}``. Returns whether a group is up (the counterpart of
    the JAX CLI's ``jax.distributed.initialize``)."""
    import os

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not (hp.get("multi_host") or int(os.environ.get("WORLD_SIZE", "1")) > 1):
        return False
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"a distributed run needs torchrun's environment; {missing} "
                           "unset (launch with torchrun --nproc_per_node N -m "
                           "diffsinger_tpu_torch.cli ...)")
    cpu = torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            resolve_device(device)  # raises: no CUDA device
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if cpu else "nccl")
    print(f"| rank {dist.get_rank()}/{dist.get_world_size()} up "
          f"({dist.get_backend()})", flush=True)
    return True


def run(argv: Optional[Sequence[str]] = None, device="cuda") -> None:
    from diffsinger_tpu_torch.config.hparams import set_hparams

    hp = set_hparams(argv=argv, print_hparams=True)
    maybe_init_distributed(hp, device)
    dev = resolve_device(device)
    if hp.get("infer"):
        infer(hp, device=dev)
    else:
        train(hp, device=dev)


def _build(hp: Dict[str, Any], device):
    """(phone encoder, task) for the binarized data of ``binary_data_dir``:
    the task ``task_cls`` names (``build_task``)."""
    from diffsinger_tpu_torch.training.tasks import build_task
    from diffsinger_tpu_torch.utils.text_encoder import build_phone_encoder

    encoder = build_phone_encoder(hp["binary_data_dir"])
    sil_ids = [encoder.encode(p)[0] for p in encoder.sil_phonemes() if encoder.encode(p)]
    task = build_task(hp, vocab_size=len(encoder), device=device, sil_ids=tuple(sil_ids))
    return encoder, task


def _dataset_cls(hp: Dict[str, Any]):
    from diffsinger_tpu_torch.data.dataset import FastSpeechDataset, OpencpopDataset

    return OpencpopDataset if hp.get("use_midi") else FastSpeechDataset


def make_valid_plotter(hp: Dict[str, Any], task):
    """The first ``num_valid_plots`` validation batches: ground-truth and
    predicted mel side by side, and the first one's audio, into TensorBoard.
    Does nothing when the trainer has no writer."""
    state: Dict[str, Any] = {}

    def plotter(trainer, batch, batch_idx):
        w = trainer.writer
        if w is None:
            return
        import torch

        from diffsinger_tpu_torch.inference.vocoder import get_vocoder_cls

        gen = torch.Generator(device=trainer.device).manual_seed(batch_idx)
        out = task.inference(batch, use_gt_dur=True,
                             use_gt_f0=bool(hp.get("use_gt_f0", False)), generator=gen)
        mel_pred = out["mel_out"][0].float().cpu().numpy()
        mel_gt = np.asarray(batch["mels"])[0]
        n = int(batch["mel_lengths"][0])
        cat = np.concatenate([mel_gt[:n], mel_pred[:n]], axis=1)
        try:
            from diffsinger_tpu_torch.utils.plot import spec_to_figure

            w.add_figure(f"mel_{batch_idx}", spec_to_figure(
                cat, hp.get("mel_vmin", -6), hp.get("mel_vmax", 1.5)), trainer.global_step)
        except ImportError:
            print("| matplotlib not available: no validation mel figure")
        if "vocoder" not in state:
            try:
                state["vocoder"] = get_vocoder_cls(hp)(hp, device=trainer.device)
            except Exception as e:
                print(f"| vocoder unavailable for validation audio: {e}")
                state["vocoder"] = None
        voc = state["vocoder"]
        if voc is not None and batch_idx == 0:
            f0 = (out["f0_denorm"][0][:n].float().cpu().numpy()
                  if "f0_denorm" in out else None)
            wav = voc.spec2wav(mel_pred[:n], f0=f0)
            w.add_audio(f"pred_{batch_idx}", wav[:, None], global_step=trainer.global_step,
                        sample_rate=hp["audio_sample_rate"])

    return plotter


def train(hp: Dict[str, Any], device="cuda"):
    """Build the task and datasets and ``fit``; returns the trainer."""
    from diffsinger_tpu_torch.training.trainer import Trainer

    dev = resolve_device(device)
    _, task = _build(hp, dev)
    ds_cls = _dataset_cls(hp)
    train_ds = ds_cls(hp, hp.get("train_set_name", "train"), shuffle=True)
    valid_ds = ds_cls(hp, hp.get("valid_set_name", "valid"))
    trainer = Trainer(hp, task, device=dev)
    trainer.plotter = make_valid_plotter(hp, task)
    trainer.fit(train_ds, valid_ds)
    return trainer


def infer(hp: Dict[str, Any], device="cuda") -> str:
    """Synthesize the test split from the newest checkpoint of ``work_dir``;
    returns the output directory."""
    from diffsinger_tpu_torch.inference.synthesize import synthesize_dataset

    dev = resolve_device(device)
    _, task = _build(hp, dev)
    test_ds = _dataset_cls(hp)(hp, hp.get("test_set_name", "test"))
    return synthesize_dataset(hp, task, test_ds, device=dev)


if __name__ == "__main__":
    run()
