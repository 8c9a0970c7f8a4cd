"""Note names to MIDI numbers (the port's own copy of ``note_to_midi`` from
diffsinger_tpu/data/binarize.py; the binarizer itself is not ported yet).
"""

from __future__ import annotations

import re

NOTE_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


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
