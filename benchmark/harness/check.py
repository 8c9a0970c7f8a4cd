"""How ``correct`` is decided for a serving cell: the program's outputs on the
sampled device batches against the plain reference's on the same requests,
weights and draws, stage by stage.

* ``mel_gap``: the sampler mel the program handed its vocoder (bucket
  padding at the batch's silence floor) against the reference's, from the
  requests and the sampler's draws alone: the FS2 conditioner, every reverse
  step through the stack kernel. Largest difference over the reference's
  largest magnitude (at least 1).
* ``f0_gap`` (an NSF vocoder): the F0 the program handed its vocoder
  against the reference's: the PitchExtractor's on the program's own mel,
  else the FS2's. Judging the PE on the mel the program made keeps a frame
  whose voicing sits on the threshold from turning a rounding difference of
  the sampler into an F0 of 0 Hz.
* ``wav_gap``: each returned waveform, its length exactly, against the
  reference's: the vocoder through ``mrf_stage``, the trim. Without NSF the
  reference's waveform is its own from the requests, the whole chain. With
  NSF it is the reference vocoder's on the program's mel and F0 and the same
  source draws: the source's phase is a running sum of the F0, so one frame
  whose voicing flipped on rounding would shift the sines of every sample
  after it.

With NSF the reference follows the program at two seams, the mel and the
F0; the start of each stage is the reference's own work from the requests.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..reference.system import System, precision

def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return float("inf")
    scale = max(float(want.abs().max()), 1.0)
    diff = float((got.to(torch.float32) - want).abs().max()) if got.numel() else 0.0
    return diff / scale if np.isfinite(diff) else float("inf")


def _dev(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                           device=device).to(torch.float32)


def compare(ref: System, case: Dict[str, Any], noise, source, with_pe: bool) -> Dict[str, float]:
    dev = noise.device
    inf = float("inf")
    nsf = bool(ref.voc.cfg.use_pitch_embed)
    with precision(False):
        mel_raw, mel2ph, f0_fs2 = ref.mel(case["batch"], case["t_b"], noise)
        floored = System.floor(mel_raw, mel2ph)
        mel = _dev(case["mel"], dev)
        out = {"mel_gap": _gap(mel, floored)}
        if mel.shape != floored.shape:
            return dict(out, **({"f0_gap": inf} if nsf else {}), wav_gap=inf)
        f0 = None
        if nsf:
            # the F0 that drives the NSF source: the PE's on the program's
            # mel, else the FS2's own
            want = (ref.f0(torch.where((mel2ph > 0)[..., None], mel, 0.0)) if with_pe
                    else f0_fs2)
            f0 = _dev(case["f0"], dev)
            if f0 is None:
                return dict(out, f0_gap=inf, wav_gap=inf)
            out["f0_gap"] = _gap(f0, want)
        wav_ref = ref.wav(mel if nsf else floored, f0, source)
    worst = 0.0
    for j, wav in enumerate(case["wavs"][:case["real"]]):
        n = int((mel2ph[j] > 0).sum()) or case["t_b"]
        got = torch.as_tensor(np.asarray(wav, np.float32), device=dev)
        worst = max(worst, _gap(got, wav_ref[j, :n * ref.hop]))
    out["wav_gap"] = worst
    return out


def control_case(ref: System, case: Dict[str, Any], noise, source) -> Dict[str, Any]:
    """The control: the reference itself in the program's place, its float32
    products in TF32 (the nearest precision below the configuration's)."""
    with precision(True):
        mel_raw, mel2ph, f0_fs2 = ref.mel(case["batch"], case["t_b"], noise)
        floored = System.floor(mel_raw, mel2ph)
        f0 = ref.f0(mel_raw) if ref.pe is not None else f0_fs2
        wav = ref.wav(floored, f0, source)
    wavs = []
    for j in range(case["real"]):
        n = int((mel2ph[j] > 0).sum()) or case["t_b"]
        wavs.append(wav[j, :n * ref.hop].cpu().numpy())
    return dict(case, mel=floored, f0=f0, wavs=wavs)


def verdict(numbers: Dict[str, float], limits: Dict[str, float], samples: int,
            failed: int) -> bool:
    """Correct: every number within its limit, at least one batch compared,
    no request failed."""
    return (samples > 0 and failed == 0 and set(limits) <= set(numbers)
            and all(numbers[k] <= limits[k] for k in limits))
