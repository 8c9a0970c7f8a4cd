"""The singing demo's core (counterpart of diffsinger_tpu/inference/gradio_app.py):
sentence splitting, synthesis and int16 concatenation, with an optional
gradio UI.

Lyrics, notes and note durations are split together on CJK sentence
punctuation and batched up to ~400 characters; each chunk is sung, clipped
to [-1, 1] (NaN to 0), scaled to int16 and followed by 0.3 s of silence.
``gradio`` is optional: ``run`` raises ``ImportError`` without it, and
``inference/web_app.py`` serves the same core over the standard library's
HTTP server.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Tuple

import numpy as np

PUNCS = "。？；："


def split_sentences(text: str, notes: str, notes_duration: str
                    ) -> List[Tuple[str, str, str]]:
    """Aligned (text, notes, durations) chunks, split after each CJK
    sentence mark and joined up to ~400 characters of text."""
    sents = re.split(rf"([{PUNCS}])", text.replace("\n", ","))
    sents_notes = re.split(rf"([{PUNCS}])", notes.replace("\n", ","))
    sents_dur = re.split(rf"([{PUNCS}])", notes_duration.replace("\n", ","))
    if sents[-1] not in list(PUNCS):
        sents += [""]
        sents_notes += [""]
        sents_dur += [""]
    chunks = []
    s = n = d = ""
    for i in range(0, len(sents), 2):
        if len(sents[i]) > 0:
            s += sents[i] + sents[i + 1]
            n += sents_notes[i] + sents_notes[i + 1]
            d += sents_dur[i] + sents_dur[i + 1]
        if len(s) >= 400 or (i >= len(sents) - 2 and len(s) > 0):
            chunks.append((s, n, d))
            s = n = d = ""
    return chunks


class GradioInfer:
    """``inference_cls(hp, **infer_kw)`` (an ``svs.BaseSVSInfer``) behind
    ``greet``. Requests from several threads share the one model on the
    device: a lock runs their synthesis one at a time."""

    def __init__(self, hp: Dict, inference_cls, title: str = "DiffSinger",
                 description: str = "", article: str = "", example_inputs=(), **infer_kw):
        self.hp = hp
        self.title = title
        self.description = description
        self.article = article
        self.example_inputs = list(example_inputs)
        self.infer_ins = inference_cls(hp, **infer_kw)
        self._lock = threading.Lock()

    def greet(self, text: str, notes: str, notes_duration: str) -> Tuple[int, np.ndarray]:
        """-> (sample rate, int16 waveform of every chunk, each followed by
        0.3 s of silence)."""
        sr = self.hp["audio_sample_rate"]
        audio_outs = []
        for s, n, d in split_sentences(text, notes, notes_duration):
            with self._lock:
                wav = self.infer_ins.infer_once({"text": s, "notes": n, "notes_duration": d})
            wav = np.clip(np.nan_to_num(np.asarray(wav)), -1.0, 1.0)
            audio_outs.append((wav * 32767).astype(np.int16))
            audio_outs.append(np.zeros(int(sr * 0.3), np.int16))
        return sr, np.concatenate(audio_outs)

    def run(self, **launch_kwargs):
        try:
            import gradio as gr
        except ImportError as e:
            raise ImportError("gradio is not installed; serve the same core with "
                              "python -m diffsinger_tpu_torch.inference.web_app") from e
        iface = gr.Interface(
            fn=self.greet,
            inputs=[gr.Textbox(label="Input Text"), gr.Textbox(label="Input Note"),
                    gr.Textbox(label="Input Duration")],
            outputs=gr.Audio(label="Output Audio"),
            title=self.title, description=self.description, article=self.article,
            examples=self.example_inputs, allow_flagging="never")
        iface.launch(**launch_kwargs)
