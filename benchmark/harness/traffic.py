"""The one general traffic generator. A mix is a data file,
``traffic/<mix>.json``; the lengths come from the configuration's
``corpus``: the corpus's published mean and range, and a spread (``sigma``)
of the benchmark's own, since neither corpus publishes one. So the set is
not the corpus's length distribution. ``--seed`` orders and fills it.

Every seed gets the same set of lengths: ``length_set`` stratified quantiles
of a clipped log-normal whose location is solved so that the set's mean is
the stated mean. The seed only permutes the set and draws the tokens, notes
and slurs, so the work of a run does not change with its seed.

Mixes (``kind``):

* ``batch_calls``: one caller, closed loop, ``requests_per_call`` requests a
  call to ``FusedSynthesizer.synthesize_many``. Every call holds the whole
  length set in its own seeded order.
* ``closed_b1``: one client, closed loop, one phrase at a time, the length
  set in a seeded order, repeated.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

NOTE_NAMES = ("C", "C#/Db", "D", "D#/Eb", "E", "F", "F#/Gb", "G", "G#/Ab", "A", "A#/Bb", "B")


def load_mix(name: str) -> Dict[str, Any]:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _norm_ppf(q: np.ndarray) -> np.ndarray:
    """The standard normal quantile (Acklam's rational approximation,
    relative error below 1.2e-9)."""
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    q = np.asarray(q, np.float64)
    out = np.empty_like(q)
    lo, hi = q < 0.02425, q > 1 - 0.02425
    mid = ~(lo | hi)
    r = q[mid] - 0.5
    s = r * r
    out[mid] = ((((((a[0] * s + a[1]) * s + a[2]) * s + a[3]) * s + a[4]) * s + a[5]) * r /
                (((((b[0] * s + b[1]) * s + b[2]) * s + b[3]) * s + b[4]) * s + 1))
    for mask, sign, qq in ((lo, 1.0, q[lo]), (hi, -1.0, 1 - q[hi])):
        u = np.sqrt(-2 * np.log(qq))
        out[mask] = sign * ((((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) /
                            ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1))
    return out


def length_set(corpus: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` durations in seconds: the stratified quantiles (i + 0.5) / n of
    a log-normal of shape ``sigma`` clipped to ``clip_s``, its location
    solved by bisection so that the set's mean is ``mean_s``."""
    lo, hi = corpus["clip_s"]
    z = _norm_ppf((np.arange(n) + 0.5) / n)
    sigma, target = float(corpus["sigma"]), float(corpus["mean_s"])

    def durations(mu: float) -> np.ndarray:
        return np.clip(np.exp(mu + sigma * z), lo, hi)

    a, b = math.log(lo), math.log(hi)
    for _ in range(100):
        mid = 0.5 * (a + b)
        a, b = (mid, b) if durations(mid).mean() < target else (a, mid)
    return durations(0.5 * (a + b))


def phones_of(corpus: Dict[str, Any], seconds: np.ndarray) -> np.ndarray:
    """Phones a clip holds: its frames over the frames a phone lasts."""
    frames = seconds * float(corpus["frames_per_s"])
    return np.maximum(1, np.rint(frames / int(corpus["frames_per_phone"]))).astype(np.int64)


def note_name(midi: int) -> str:
    """A MIDI number as the Opencpop transcriptions spell it ('C#4/Db4')."""
    octave = midi // 12 - 1
    return "/".join(f"{n}{octave}" for n in NOTE_NAMES[midi % 12].split("/"))


class Traffic:
    """The requests of one run: ``calls(k)`` for the batch mix (a list of
    request specs per call), ``phrases()`` for the one-at-a-time mix."""

    def __init__(self, mix: Dict[str, Any], config: Dict[str, Any], seed: int):
        self.mix, self.config, self.seed = mix, config, int(seed)
        self.corpus = config["corpus"]
        self.n_phones = phones_of(self.corpus, length_set(self.corpus, int(mix["length_set"])))

    def rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, *stream]))

    def draw_seed(self, *stream: int) -> int:
        """A 63-bit seed for a torch generator, from the run's seed and a stream."""
        return int(np.random.SeedSequence([self.seed, *stream]).generate_state(2, np.uint64)[0]
                   >> np.uint64(1))

    def spec(self, rng: np.random.Generator, n: int) -> Dict[str, Any]:
        """One request's content: ``n`` phone ids, and for a MIDI model the
        notes (MIDI 48-76), one note per phone lasting the phone's frames,
        and slurs on a tenth of the phones (never the first)."""
        vocab = int(self.config["vocab_size"])
        spec: Dict[str, Any] = {"n_phones": int(n),
                                "frames": int(n) * int(self.corpus["frames_per_phone"]),
                                "tokens": rng.integers(3, vocab, size=n).astype(np.int64)}
        if self.config["hparams"].get("use_midi"):
            spec["midi"] = rng.integers(48, 77, size=n).astype(np.int64)
            slur = (rng.random(n) < 0.1).astype(np.int64)
            slur[0] = 0
            spec["is_slur"] = slur
            spec["note_s"] = (int(self.corpus["frames_per_phone"])
                              / float(self.corpus["frames_per_s"]))
        return spec

    def call(self, k: int) -> List[Dict[str, Any]]:
        """Call ``k`` of the batch mix: the whole length set in a seeded order."""
        rng = self.rng(1, k)
        order = rng.permutation(len(self.n_phones))
        return [self.spec(rng, self.n_phones[i]) for i in order]

    def phrases(self) -> List[Dict[str, Any]]:
        """The one-at-a-time mix: the length set in a seeded order."""
        rng = self.rng(2)
        order = rng.permutation(len(self.n_phones))
        return [self.spec(rng, self.n_phones[i]) for i in order]


def fused_request(spec: Dict[str, Any]):
    """A request for ``FusedSynthesizer.synthesize_many``: (batch, t_mel)."""
    n = spec["n_phones"]
    batch = {"txt_tokens": spec["tokens"][None]}
    if "midi" in spec:
        batch["pitch_midi"] = spec["midi"][None]
        batch["midi_dur"] = np.full((1, n), spec["note_s"], np.float32)
        batch["is_slur"] = spec["is_slur"][None]
    return batch, spec["frames"]


def phoneme_input(spec: Dict[str, Any], phone_list: Sequence[str]) -> Dict[str, str]:
    """A phoneme-level singing input, as the Opencpop transcriptions and the
    demo's phoneme mode give it."""
    ids = spec["tokens"]
    return {"text": "", "input_type": "phoneme",
            "ph_seq": " ".join(phone_list[i - 3] for i in ids),
            "note_seq": " ".join(note_name(int(m)) for m in spec["midi"]),
            "note_dur_seq": " ".join(f"{spec['note_s']:.3f}" for _ in ids),
            "is_slur_seq": " ".join(str(int(s)) for s in spec["is_slur"])}
