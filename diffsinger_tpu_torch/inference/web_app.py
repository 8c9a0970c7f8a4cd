"""Web demo over the standard library's HTTP server (counterpart of
diffsinger_tpu/inference/web_app.py): lyrics and MIDI notes in, a wav out.

Endpoints:
  GET  /                 an HTML form (text, notes, note durations)
  POST /api/synthesize   JSON {"text", "notes", "notes_duration"} -> audio/wav
                         (RIFF/WAVE PCM16 mono at the model's sample rate)
A bad ``Content-Length`` (not an integer, or negative) gets 400 without the
body being read, a body over ``MAX_REQUEST_BYTES`` 413, a synthesis error 400
with its message, any other path 404. Requests are served on threads; the
core (``gradio_app.GradioInfer``) runs their synthesis one at a time.

Run on the card:
    python -m diffsinger_tpu_torch.inference.web_app --config configs/opencpop/ds1000.yaml \
        [--exp_name NAME] [--host 127.0.0.1] [--port 7860] [--device cuda]
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Tuple

import numpy as np

# lyric + MIDI JSON is small: refuse anything bigger
MAX_REQUEST_BYTES = 1 << 20

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{font-family:sans-serif;max-width:48rem;margin:2rem auto}}
textarea{{width:100%;height:4rem}}</style></head>
<body><h1>{title}</h1><p>{description}</p>
<form id="f">
<label>Input Text<textarea name="text"></textarea></label>
<label>Input Note<textarea name="notes"></textarea></label>
<label>Input Duration<textarea name="notes_duration"></textarea></label>
<button type="submit">Synthesize</button></form>
<audio id="out" controls></audio>
<script>
f.onsubmit = async (e) => {{
  e.preventDefault();
  const body = JSON.stringify(Object.fromEntries(new FormData(f)));
  const r = await fetch('/api/synthesize', {{method: 'POST', body}});
  if (!r.ok) {{ alert(await r.text()); return; }}
  out.src = URL.createObjectURL(await r.blob());
  out.play();
}};
</script></body></html>
"""


def wav_bytes(wav_int16: np.ndarray, sample_rate: int) -> bytes:
    """RIFF/WAVE PCM16 encoding of a mono int16 waveform."""
    data = np.asarray(wav_int16, dtype="<i2").tobytes()
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16,
        1, 1, sample_rate, sample_rate * 2, 2, 16, b"data", len(data))
    return hdr + data


class SVSWebApp:
    """A ``GradioInfer`` core behind an HTTP server. The core needs only
    ``greet(text, notes, durations) -> (sample rate, int16 wav)``, ``title``
    and ``description``."""

    def __init__(self, core):
        self.core = core
        self._httpd = None

    def _page(self) -> bytes:
        return _PAGE.format(title=self.core.title,
                            description=self.core.description).encode()

    def _synthesize(self, payload: Dict[str, str]) -> Tuple[int, bytes]:
        sr, wav = self.core.greet(payload.get("text", ""), payload.get("notes", ""),
                                  payload.get("notes_duration", ""))
        return sr, wav_bytes(wav, sr)

    def _make_handler(self):
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html; charset=utf-8", app._page())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path != "/api/synthesize":
                    self._send(404, "text/plain", b"not found")
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    n = -1
                if n < 0:  # rfile.read(-1) would wait for the client to close
                    self._send(400, "text/plain", b"bad Content-Length")
                    return
                if n > MAX_REQUEST_BYTES:
                    self._send(413, "text/plain", b"request body too large")
                    return
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    _, body = app._synthesize(payload)
                except Exception as e:  # the message goes back to the page
                    self._send(400, "text/plain", str(e).encode())
                    return
                self._send(200, "audio/wav", body)

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Serve on a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self._httpd.server_address[1]

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    def run_forever(self, host: str = "127.0.0.1", port: int = 7860):
        """Serve until interrupted. Loopback by default: the app has no
        authentication, so ``--host 0.0.0.0`` is a deliberate choice."""
        httpd = ThreadingHTTPServer((host, port), self._make_handler())
        print(f"| serving on http://{host}:{port}", flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()


def main(argv=None):
    import argparse

    from diffsinger_tpu_torch.config.hparams import set_hparams
    from diffsinger_tpu_torch.inference.gradio_app import GradioInfer
    from diffsinger_tpu_torch.inference.svs import DiffSingerE2EInfer

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--exp_name", default="")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    hp = set_hparams(args.config, args.exp_name)
    core = GradioInfer(hp, DiffSingerE2EInfer, title="DiffSinger",
                       description="lyrics + MIDI notes -> singing voice", device=args.device)
    SVSWebApp(core).run_forever(args.host, args.port)


if __name__ == "__main__":
    main()
