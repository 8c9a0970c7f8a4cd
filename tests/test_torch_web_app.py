"""The serving demos of the port against the JAX package: the gradio core's
sentence splitting and ``greet``, the unfused SVS path, the stdlib web
server over real HTTP (with its status rules and concurrent requests), the
headless gradio UI, ``example_run`` from checkpoints on disk, and the web
server's entry point.

The model is tests/test_torch_singing_serve.py's: a tiny DiffSinger with
MIDI, PLMS, a PitchExtractor and NSF-HiFiGAN on shared weights, fixed phone
durations and a PE that voices every frame. The draws come from the JAX keys
(the fused path's PLMS start noise and NSF source as that file takes them;
the unfused path's from ``task.inference``'s key and the vocoder's
``PRNGKey(0)``). Tolerance 1e-4 on waveforms, 5 LSB on their int16 form
(1e-4 * 32767 plus the rounding).
"""

import http.client
import json
import socket
import sys
import threading
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from diffsinger_tpu.inference import gradio_app as jgradio
from diffsinger_tpu.inference import svs as jsvs
from diffsinger_tpu.inference.synthesize import _PEWrapper as JPEWrapper
from diffsinger_tpu_torch.inference import gradio_app as tgradio
from diffsinger_tpu_torch.inference import svs as tsvs
from diffsinger_tpu_torch.inference import web_app as tweb
from diffsinger_tpu_torch.tools.fixtures import write_hifigan_dir, write_task_ckpt
from tests import test_torch_singing_serve as sing

torch.set_num_threads(1)
SEED = 1234
WAV_TOL = 1e-4

# the reference gradio demo sentences, text / notes / durations
DEMO = [
    ("你 说 你 不 SP 懂 为 何 在 这 时 牵 手 AP",
     "D#4/Eb4 | D#4/Eb4 | D#4/Eb4 | D#4/Eb4 | rest | D#4/Eb4 | D4 | D4 | D4 "
     "| D#4/Eb4 | F4 | D#4/Eb4 | D4 | rest",
     "0.113740 | 0.329060 | 0.287950 | 0.133480 | 0.150900 | 0.484730 | "
     "0.242010 | 0.180820 | 0.343570 | 0.152050 | 0.266720 | 0.280310 | "
     "0.633300 | 0.444590"),
    ("小酒窝长睫毛AP是你最美的记号",
     "C#4/Db4 | F#4/Gb4 | G#4/Ab4 | A#4/Bb4 F#4/Gb4 | F#4/Gb4 C#4/Db4 | "
     "C#4/Db4 | rest | C#4/Db4 | A#4/Bb4 | G#4/Ab4 | A#4/Bb4 | G#4/Ab4 | F4 "
     "| C#4/Db4",
     "0.407140 | 0.376190 | 0.242180 | 0.509550 0.183420 | 0.315400 0.235020"
     " | 0.361660 | 0.223070 | 0.377270 | 0.340550 | 0.299620 | 0.344510 | "
     "0.283770 | 0.323390 | 0.360340"),
    ("我真的SP爱你SP句句不轻易",
     "D4 | A4 | F#4 |  rest | A4 | D4 | rest | B4 | A4 F#4 | F#4 | A4 | A4",
     "0.8 | 0.4 | 0.967 | 0.3 | 0.4 | 0.967 | 0.4 | 0.8 | 0.4 0.4 | 0.25 | "
     "0.967 | 0.9"),
    ("好冷啊 AP 我在东北玩泥巴",
     "F4 | F4 | D4 | rest | D4 | D4 | C4 | C4 | B3 | C4 | D4",
     "0.5 | 0.3 | 0.3 | 0.3 | 0.2 | 0.2 | 0.2 | 0.2 | 0.25 | 0.25 | 0.4"),
]
# sentences that split_sentences cuts into several chunks of ~400 characters
LONG = ("好冷啊。" * 120, "F4 | F4 | D4。" * 120, "0.5 | 0.3 | 0.3。" * 120)
TWO = DEMO[3]


@pytest.mark.parametrize("inp", DEMO + [LONG, ("好冷啊", "F4 | F4 | D4", "1 | 1 | 1")])
def test_split_sentences_matches_jax(inp):
    got = tgradio.split_sentences(*inp)
    assert got == jgradio.split_sentences(*inp) and len(got) == (2 if inp is LONG else 1)


@pytest.fixture(scope="module")
def pair():
    return sing._build_pair(sing.HP)


def _jax_infer(jsyn, hp, fused: bool):
    """The JAX ``DiffSingerE2EInfer`` around the pair's JAX parts."""
    j = object.__new__(jsvs.DiffSingerE2EInfer)
    j.hp = hp
    j.ph_encoder = jsvs.TokenTextEncoder(jsvs.CPOP_PHONE_LIST, replace_oov=",")
    j.pinyin2phs = jsvs.build_pinyin2ph_map()
    j.spk_map = {"opencpop": 0}
    j.task, j.params, j.vocoder = jsyn.task, jsyn.params, jsyn.vocoder
    j.pe = JPEWrapper(*jsyn.pe, hp)
    j.fused = jsyn if fused else None
    return j


def _port_core(parts, hp):
    ttask, tvoc, tpe = parts
    return tgradio.GradioInfer(hp, tsvs.DiffSingerE2EInfer, title="web", description="d",
                               task=ttask, vocoder=tvoc, pe=tpe, device="cpu")


def _with_jax_draws(infer, fused: bool):
    """``infer.forward_model`` with the draws the JAX path takes for the item."""
    plain = infer.forward_model

    def forward_model(item, **kw):
        t_mel = infer.estimate_t_mel(item)
        if fused:  # FusedSynthesizer.__call__ on PRNGKey(seed), bucketed
            t_b = -(-t_mel // sing.HP["mel_pad_multiple"]) * sing.HP["mel_pad_multiple"]
            noise, source = sing.jax_draws(jax.random.PRNGKey(SEED), 1, t_b)
        else:  # task.inference on PRNGKey(seed): PLMS start from its second split
            init = jax.random.split(jax.random.PRNGKey(SEED))[1]
            noise = np.asarray(jax.random.normal(init, (1, t_mel, sing.MEL)))[None]
            n = len(item["ph_token"]) * sing.FRAMES_PER_PHONE  # the trimmed mel
            phase, rest = jax.random.split(jax.random.PRNGKey(0))  # the vocoder's key
            source = (np.asarray(jax.random.uniform(phase, (1, 1, 9)).at[:, :, 0].set(0.0)),
                      np.asarray(jax.random.normal(rest, (1, n * sing.HOP, 9))))
        return plain(item, noise=noise, source=source, **kw)

    infer.forward_model = forward_model


def test_greet_matches_jax(pair):
    jsyn, _, parts = pair
    hp = dict(sing.HP, fused_infer=True)
    jcore = object.__new__(jgradio.GradioInfer)
    jcore.hp, jcore.infer_ins = hp, _jax_infer(jsyn, hp, fused=True)
    core = _port_core(parts, hp)
    assert core.infer_ins.fused is not None
    _with_jax_draws(core.infer_ins, fused=True)
    sr, got = core.greet(*TWO)
    jsr, want = jcore.greet(*TWO)
    assert sr == jsr == sing.SR and got.dtype == want.dtype == np.int16
    assert got.shape == want.shape
    gap = int(0.3 * sr)
    assert (got[-gap:] == 0).all() and np.abs(want).max() > 300
    np.testing.assert_allclose(got.astype(np.int32), want.astype(np.int32), atol=5)


def test_unfused_svs_matches_jax(pair):
    """``fused_infer: false``: task.inference, the mel cut by mel2ph, the PE's
    F0 of the cut mel and vocoder.spec2wav, as JAX's unfused forward_model."""
    jsyn, _, (ttask, tvoc, tpe) = pair
    hp = dict(sing.HP, fused_infer=False)
    want = _jax_infer(jsyn, hp, fused=False).infer_once(jsvs.EXAMPLE_INPUT)
    infer = tsvs.DiffSingerE2EInfer(hp, ttask, tvoc, pe=tpe, device="cpu")
    assert infer.fused is None and infer.pe.module is tpe
    _with_jax_draws(infer, fused=False)
    got = infer.infer_once(tsvs.EXAMPLE_INPUT)
    n = len(tsvs.EXAMPLE_INPUT["ph_seq"].split()) * sing.FRAMES_PER_PHONE
    assert got.shape == np.asarray(want).shape == (n * sing.HOP,)
    np.testing.assert_allclose(got, np.asarray(want), atol=WAV_TOL)
    assert np.abs(got).max() > 1e-2
    # without fixed draws: one generator seeded with hp['seed'] a request
    plain = tsvs.DiffSingerE2EInfer(hp, ttask, tvoc, pe=tpe, device="cpu")
    np.testing.assert_array_equal(plain.infer_once(tsvs.EXAMPLE_INPUT),
                                  plain.infer_once(tsvs.EXAMPLE_INPUT))
    # the cascade class reads the model's own F0: none here, so no NSF source
    cascade = tsvs.DiffSingerCascadeInfer(hp, ttask, tvoc, pe=tpe, device="cpu")
    assert cascade.pe is None and cascade.extract_f0({"f0_denorm": None}, np.zeros((3, 2))) \
        is None


def _post(port, body: bytes, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.putrequest("POST", "/api/synthesize")
    for k, v in {"Content-Length": str(len(body)), **(headers or {})}.items():
        conn.putheader(k, v)
    conn.endheaders()
    if body:
        conn.send(body)
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read()
    conn.close()
    return out


@pytest.fixture(scope="module")
def served(pair):
    core = _port_core(pair[2], dict(sing.HP))
    app = tweb.SVSWebApp(core)
    port = app.start()
    yield core, port
    app.stop()


def test_real_http_roundtrip_and_concurrent_requests(served):
    core, port = served
    page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60).read()
    assert b"<title>web</title>" in page
    payload = json.dumps(dict(zip(("text", "notes", "notes_duration"), TWO))).encode()
    status, ctype, body = _post(port, payload)
    assert status == 200 and ctype == "audio/wav"
    assert body[:4] == b"RIFF" and body[8:16] == b"WAVEfmt "
    sr, wav = core.greet(*TWO)
    assert int.from_bytes(body[24:28], "little") == sr == sing.SR
    assert int.from_bytes(body[34:36], "little") == 16          # PCM16
    assert body == tweb.wav_bytes(wav, sr) and (len(body) - 44) // 2 == len(wav)
    results = [None, None]

    def worker(i):
        results[i] = _post(port, payload)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert [r[2] for r in results] == [body, body]


def test_http_status_rules(served):
    _, port = served
    # a negative Content-Length gets 400 at once, not a read that waits for EOF
    assert _post(port, b"", {"Content-Length": "-1"}, timeout=5)[0] == 400
    assert _post(port, b"", {"Content-Length": "abc"}, timeout=5)[0] == 400
    # over the limit: refused before the body is read
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.putrequest("POST", "/api/synthesize")
    conn.putheader("Content-Length", str(tweb.MAX_REQUEST_BYTES + 1))
    conn.endheaders()
    assert conn.getresponse().status == 413
    conn.close()
    # a misaligned notes string: 400 with the reason
    bad = json.dumps({"text": "小酒窝", "notes": "C4 | D4", "notes_duration": "1 | 1"})
    status, _, msg = _post(port, bad.encode())
    assert status == 400 and b"line up" in msg
    assert _post(port, b"{bad json")[0] == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=5)
    assert e.value.code == 404
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("POST", "/nope", body=b"{}")
    assert conn.getresponse().status == 404
    conn.close()
    with socket.create_connection(("127.0.0.1", port), timeout=5):
        pass  # still serving


def _fake_gradio(rec):
    gr = types.ModuleType("gradio")

    class Textbox:
        def __init__(self, label=""):
            self.label = label

    class Audio(Textbox):
        pass

    class Interface:
        def __init__(self, fn=None, inputs=None, outputs=None, **kw):
            self.fn, self.inputs, self.outputs, self.kw = fn, inputs, outputs, kw
            rec.append(self)

        def launch(self, **kw):
            self.launched = kw

    gr.Textbox, gr.Audio, gr.Interface = Textbox, Audio, Interface
    return gr


def test_gradio_ui_headless(pair, monkeypatch):
    core = _port_core(pair[2], dict(sing.HP))
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        core.run()
    rec = []
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio(rec))
    core.run(prevent_thread_lock=True)
    (iface,) = rec
    assert iface.kw["title"] == "web" and iface.launched == {"prevent_thread_lock": True}
    assert [t.label for t in iface.inputs] == ["Input Text", "Input Note", "Input Duration"]
    sr, audio = iface.fn("小酒窝", "C#4 | F#4 | G#4", "0.4 | 0.4 | 0.4")
    assert sr == sing.SR and audio.dtype == np.int16 and len(audio) > int(0.3 * sr)


def test_example_run_from_checkpoints_on_disk(pair, tmp_path):
    """``example_run`` builds the task, the vocoder and the PE from their
    checkpoint files and writes the waveform; it equals a call on the same
    objects passed in."""
    _, _, (ttask, tvoc, tpe) = pair
    hp = {**sing.HP, **sing.VOC_HP, "work_dir": str(tmp_path / "exp"),
          "vocoder_ckpt": str(tmp_path / "voc"), "pe_enable": True,
          "pe_ckpt": str(tmp_path / "pe"), "lr": 1e-3, "decay_steps": 100}
    write_task_ckpt(hp["work_dir"], ttask.checkpoint_module().state_dict(), step=10)
    geom = {k: sing.VOC_HP[k] for k in ("upsample_rates", "upsample_kernel_sizes",
                                        "upsample_initial_channel", "resblock_kernel_sizes",
                                        "resblock_dilation_sizes", "resblock")}
    write_hifigan_dir(hp["vocoder_ckpt"], tvoc.model.state_dict(), geom)
    write_task_ckpt(hp["pe_ckpt"], tpe.state_dict(), step=5)
    out = tsvs.DiffSingerE2EInfer.example_run(hp, tsvs.EXAMPLE_INPUT,
                                              str(tmp_path / "out" / "a.wav"), device="cpu")
    from diffsinger_tpu_torch.utils.misc import load_wav

    wav = load_wav(out, sing.SR)
    want = tsvs.DiffSingerE2EInfer(sing.HP, ttask, tvoc, pe=tpe,
                                   device="cpu").infer_once(tsvs.EXAMPLE_INPUT)
    assert wav.shape == want.shape
    np.testing.assert_allclose(wav, want, atol=2 / 32767)


def test_web_app_main_runs_on_the_card_by_default(monkeypatch):
    served_args = []
    monkeypatch.setattr(tweb.SVSWebApp, "run_forever",
                        lambda self, host, port: served_args.append((host, port)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tweb.main(["--config", "configs/opencpop/ds1000.yaml"])
    assert served_args == []
