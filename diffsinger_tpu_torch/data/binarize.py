"""Host-side data helpers (the port's own copies of pieces of
diffsinger_tpu/data/binarize.py and data/dataset.py; the rest of the
binarizer and the dataset are not ported yet).

  * ``note_to_midi``: note names to MIDI numbers;
  * ``get_f0cwt``: the CWT extras of one utterance (``cwt_spec``,
    ``cwt_scales`` and the per-utterance log-F0 ``f0_mean`` / ``f0_std``);
  * ``collate_cwt``: the ``cwt_spec`` / ``f0_mean`` / ``f0_std`` keys of a
    ``pitch_type: cwt`` training batch, as the JAX dataset builds them.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Sequence

import numpy as np

from diffsinger_tpu_torch.utils.cwt import get_cont_lf0, get_lf0_cwt

NOTE_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


class BinarizationError(Exception):
    pass


def note_to_midi(note: str) -> int:
    """'A4' / 'C#5' / 'Db4' -> midi number (librosa.note_to_midi semantics)."""
    m = re.match(r"([A-Ga-g])([#b♯♭!]*)(-?\d+)", note.strip())
    if not m:
        raise ValueError(f"bad note {note!r}")
    pitch = NOTE_OFFSETS[m.group(1).upper()]
    for acc in m.group(2):
        pitch += 1 if acc in "#♯" else -1
    octave = int(m.group(3))
    return 12 * (octave + 1) + pitch


def get_f0cwt(f0: np.ndarray, res: Dict[str, Any]) -> None:
    """Add the CWT of the continuous log-F0 of ``f0`` (Hz, 0 = unvoiced) to
    ``res``: ``cwt_spec`` [T, 10], ``cwt_scales`` [10] and the log-F0 mean
    and std it was normalized with."""
    _, cont_lf0 = get_cont_lf0(f0)
    mean, std = np.mean(cont_lf0), np.std(cont_lf0)
    w, scales = get_lf0_cwt((cont_lf0 - mean) / std)
    if np.any(np.isnan(w)):
        raise BinarizationError("NaN CWT")
    res["cwt_spec"] = w
    res["cwt_scales"] = scales
    res["f0_mean"] = mean
    res["f0_std"] = std


def collate_cwt(items: Sequence[Dict[str, Any]], t_mel: int) -> Dict[str, np.ndarray]:
    """The cwt keys of a batch of ``get_f0cwt`` results: ``cwt_spec``
    [B, t_mel, 10] (cut or zero-padded to t_mel frames), ``f0_mean`` and
    ``f0_std`` [B] float32."""
    spec = np.zeros((len(items), t_mel, 10), np.float32)
    for i, it in enumerate(items):
        w = np.asarray(it["cwt_spec"], np.float32)[:t_mel]
        spec[i, : len(w)] = w
    return {"cwt_spec": spec,
            "f0_mean": np.asarray([float(np.mean(it["f0_mean"])) for it in items], np.float32),
            "f0_std": np.asarray([float(np.mean(it["f0_std"])) for it in items], np.float32)}
