"""Test-split synthesis, ``--infer`` (counterpart of
diffsinger_tpu/inference/synthesize.py): mel generation, vocoding and the
files a run leaves.

Every test utterance is one batch: the task's reverse diffusion on the device
(noise from a ``torch.Generator`` seeded with ``hp["seed"]``; an FS2 task's
decoder mel for ``task_cls: fs2``), its mel cut to
the aligned frames, F0 from the PitchExtractor (``pe_enable`` + ``pe_ckpt``)
or the model's ``f0_denorm``, then the vocoder. Under
``work_dir/generated_{step}_{gen_dir_name}/`` it writes ``wavs/P_<item>.wav``,
``P_mels_npy/<item>.npy`` and, with ``save_gt``, the ground truth through the
same vocoder (``G_*``); PNG plots go to ``plot/`` when matplotlib imports.
Files are written by a pool of 4 threads. ``profile_infer`` prints the audio
seconds, the wall time and the real-time factor.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from diffsinger_tpu_torch.convert.checkpoint import (find_latest_ckpt, load_torch_state_dict,
                                                     merge_state_dict, split_keys)
from diffsinger_tpu_torch.inference.vocoder import get_vocoder_cls, pad_frames
from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
from diffsinger_tpu_torch.utils.device import resolve_device
from diffsinger_tpu_torch.utils.misc import save_wav
from diffsinger_tpu_torch.utils.pitch import denorm_f0


def _save_result(wav, mel, base_fn, gen_dir, hp, f0=None, png: bool = True):
    save_wav(wav, f"{gen_dir}/wavs/{base_fn}.wav", hp["audio_sample_rate"],
             norm=hp.get("out_wav_norm", False))
    if png:
        try:
            # object-oriented matplotlib only: this runs on a thread pool and
            # pyplot's state machine is global
            from matplotlib.figure import Figure

            fig = Figure(figsize=(14, 5))
            ax = fig.add_subplot(111)
            ax.pcolor(mel.T)
            if f0 is not None:
                ax.plot(f0 / 10, c="white", linewidth=1, alpha=0.6)
            fig.tight_layout()
            fig.savefig(f"{gen_dir}/plot/{base_fn}.png", format="png")
        except Exception as e:  # plotting must never stop synthesis
            print(f"| plot failed for {base_fn}: {e}")


def synthesize_dataset(hp: Dict[str, Any], task, dataset, device="cuda") -> str:
    """Synthesize ``dataset`` (a test split) with ``task`` after it takes the
    newest checkpoint of ``work_dir`` (through ``Trainer.initialize``).
    Returns the output directory."""
    from diffsinger_tpu_torch.training.trainer import Trainer

    dev = resolve_device(device)
    trainer = Trainer(hp, task, device=dev)
    trainer.initialize()
    step = trainer.global_step
    del trainer
    gen_dir = os.path.join(hp.get("work_dir") or "infer_out",
                           f"generated_{step}_{hp.get('gen_dir_name', '')}")
    for sub in ("wavs", "plot", "P_mels_npy", "G_mels_npy"):
        os.makedirs(os.path.join(gen_dir, sub), exist_ok=True)

    vocoder = get_vocoder_cls(hp)(hp, device=dev)
    pe = _maybe_load_pe(hp, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(hp.get("seed", 1234)))
    f0_norm = dict(pitch_norm=hp.get("pitch_norm", "log"), f0_mean=hp.get("f0_mean") or 0.0,
                   f0_std=hp.get("f0_std") or 1.0, use_uv=hp.get("use_uv", True))
    pool = ThreadPoolExecutor(max_workers=4)
    futures = []
    audio_seconds, voc_s = 0.0, 0.0
    t_start = time.perf_counter()
    for batch in dataset.iter_batches(max_sentences=1):
        out = task.inference(batch, use_gt_dur=bool(hp.get("use_gt_dur", True)),
                             use_gt_f0=bool(hp.get("use_gt_f0", False)), generator=gen)
        mel_pred = out["mel_out"].float().cpu().numpy()
        mel2ph = out["mel2ph"].cpu().numpy()
        for i, item_name in enumerate(batch["item_name"]):
            n_frames = int((mel2ph[i] > 0).sum()) or mel_pred.shape[1]
            mel_i = mel_pred[i, :n_frames]
            if pe is not None:
                f0_i = pe.predict(mel_i)
            elif "f0_denorm" in out:
                f0_i = out["f0_denorm"][i, :n_frames].float().cpu().numpy()
            else:
                f0_i = None
            t_v = time.perf_counter()
            wav = vocoder.spec2wav(mel_i, f0=f0_i)
            voc_s += time.perf_counter() - t_v
            audio_seconds += len(wav) / hp["audio_sample_rate"]
            np.save(f"{gen_dir}/P_mels_npy/{item_name}.npy", mel_i)
            futures.append(pool.submit(_save_result, wav, mel_i, f"P_{item_name}", gen_dir,
                                       hp, f0_i))
            if hp.get("save_gt") and batch.get("mels") is not None:
                gt_len = int(batch["mel_lengths"][i])
                mel_gt = np.asarray(batch["mels"])[i, :gt_len]
                f0_gt = None
                if pe is not None:
                    f0_gt = pe.predict(mel_gt)
                elif batch.get("f0") is not None:
                    f0_gt = denorm_f0(torch.from_numpy(np.asarray(batch["f0"][i, :gt_len])),
                                      torch.from_numpy(np.asarray(batch["uv"][i, :gt_len])),
                                      **f0_norm).numpy()
                wav_gt = vocoder.spec2wav(mel_gt, f0=f0_gt)
                np.save(f"{gen_dir}/G_mels_npy/{item_name}.npy", mel_gt)
                futures.append(pool.submit(_save_result, wav_gt, mel_gt, f"G_{item_name}",
                                           gen_dir, hp, f0_gt))
    total = time.perf_counter() - t_start
    for f in futures:
        f.result()
    pool.shutdown()
    if hp.get("profile_infer"):
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"| generated {audio_seconds:.1f}s audio in {total:.1f}s (vocoder "
              f"{voc_s:.1f}s) => RTF {audio_seconds / max(total, 1e-9):.2f}x on {where}")
    print(f"| synthesized outputs -> {gen_dir}")
    return gen_dir


class _PEWrapper:
    """A loaded PitchExtractor: ``module`` for the fused serving path and
    ``predict(mel [T, M]) -> f0 [T]`` (Hz, 0 where unvoiced)."""

    def __init__(self, module: PitchExtractor, hp: Dict[str, Any], device):
        self.module = module.to(device).eval()
        self.device = device
        self._hp = hp

    @torch.no_grad()
    def predict(self, mel) -> np.ndarray:
        mel = np.asarray(mel, np.float32)
        t = mel.shape[0]
        t_pad = pad_frames(t, self._hp)
        if t_pad != t:
            # zero frames are the PE's padding mask: F0 0 there, then cut
            mel = np.pad(mel, ((0, t_pad - t), (0, 0)))
        out = self.module(torch.from_numpy(mel)[None].to(self.device))
        return out["f0_denorm_pred"][0, :t].float().cpu().numpy()


def load_pe(path: str, hp: Dict[str, Any]) -> PitchExtractor:
    """A PitchExtractor from an upstream PE checkpoint, BatchNorm running
    statistics included; keys that differ from the model's raise."""
    module = PitchExtractor(PEConfig.from_hparams(hp))
    sd = load_torch_state_dict(path)
    _, mismatched, missing, unexpected = split_keys(module, sd)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if mismatched or missing or unexpected:
        raise RuntimeError(f"pe checkpoint {path} does not match the PitchExtractor: "
                           f"missing={missing[:5]} unexpected={unexpected[:5]} "
                           f"shape mismatch={mismatched[:5]}")
    merge_state_dict(module, sd)
    return module.eval()


def _maybe_load_pe(hp: Dict[str, Any], device="cuda") -> Optional[_PEWrapper]:
    """With ``pe_enable``: the PitchExtractor of ``pe_ckpt`` (a file or the
    newest checkpoint of a directory); a missing checkpoint warns and leaves
    F0 to the model."""
    dev = resolve_device(device)
    if not hp.get("pe_enable"):
        return None
    path = find_latest_ckpt(hp.get("pe_ckpt") or "")
    if path is None:
        print(f"| warning: pe_ckpt {hp.get('pe_ckpt')} missing; f0 from model")
        return None
    return _PEWrapper(load_pe(path, hp), hp, dev)
