"""The port's tracer (``utils/trace.py``) and its spans in serving, singing and
training, each under a CPU ``torch.profiler.profile``.

Off (no profiler recording) a span reads one flag and does nothing else; on,
spans nest per thread and lie on the profile's own clock around their
``record_function`` ranges. The program's outputs are
the same bit for bit with the tracer on and off. Widths are tiny: the
serving cases are the shapes of ``test_torch_serve.py`` and
``test_torch_singing_serve.py``, with the port's own initial weights."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import __graft_entry__ as g
from diffsinger_tpu_torch.inference import svs
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer
from diffsinger_tpu_torch.utils import trace

torch.set_num_threads(1)


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(recs, parent):
    return [r for r in recs if r.parent == parent]


def _names(recs, parent):
    return [r.name for r in _children(recs, parent)]


# ---------------------------------------------------------------- the tracer
def test_the_flag_follows_the_profiler():
    """The tracer's only switch: torch's own flag, True exactly between the
    profiler's start and stop."""
    assert autograd_profiler._is_profiler_enabled is False
    prof = _profile()
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled is True
    finally:
        prof.stop()
    assert autograd_profiler._is_profiler_enabled is False


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    tr = trace.Tracer()
    with _profile():
        with tr.span("ds.on"):
            pass
    assert [r.name for r in tr.spans()] == ["ds.on"]

    def fail(*a, **k):
        raise AssertionError("the tracer did work while off")

    monkeypatch.setattr(time, "time_ns", fail)
    monkeypatch.setattr(autograd_profiler, "record_function", fail)
    ctx = tr.span("ds.off", id=3)
    assert ctx is trace._OFF
    with ctx:
        pass
    assert len(tr.spans()) == 1
    # the process's tracer is off too
    assert trace.span("ds.off") is trace._OFF


def test_spans_nest_per_thread():
    tr = trace.Tracer()
    barrier = threading.Barrier(2, timeout=30)

    def work(k):
        with tr.span("ds.outer", id=k):
            barrier.wait()   # both threads hold an open span at once
            for j in range(2):
                with tr.span("ds.inner", id=j):
                    barrier.wait()

    with _profile():
        threads = [threading.Thread(target=work, args=(k,)) for k in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    recs = tr.spans()
    assert len(recs) == 6 and all(r.end_ns is not None for r in recs)
    outers = [i for i, r in enumerate(recs) if r.name == "ds.outer"]
    assert len({recs[i].thread for i in outers}) == 2
    for i in outers:
        o = recs[i]
        assert o.parent is None and o.id in (1, 2)
        inner = _children(recs, i)
        assert [r.id for r in inner] == [0, 1]
        for r in inner:
            assert r.name == "ds.inner" and r.thread == o.thread
            assert o.start_ns <= r.start_ns <= r.end_ns <= o.end_ns
    s = tr.summary()
    assert s["ds.outer"]["count"] == 2 and s["ds.inner"]["count"] == 4
    for name in ("ds.outer", "ds.inner"):
        ms = sum((r.end_ns - r.start_ns) / 1e6 for r in recs if r.name == name)
        assert s[name]["total_ms"] == pytest.approx(ms)
    tr.clear()
    assert tr.spans() == () and tr.summary() == {}


def test_a_span_closes_when_its_body_raises():
    """An exception leaves through the span: the span and its range close,
    the thread's stack unwinds, and ``summary`` leaves out a span still open."""
    tr = trace.Tracer()
    with _profile() as prof:
        with pytest.raises(KeyError):
            with tr.span("ds.outer"):
                with tr.span("ds.raises"):
                    raise KeyError("x")
        with tr.span("ds.after"):
            with tr.span("ds.open") as still_open:
                assert tr.summary().keys() == {"ds.outer", "ds.raises"}
                assert tr.spans()[-1].end_ns is None and still_open.index == 3
    recs = tr.spans()
    assert [(r.name, r.parent) for r in recs] == [("ds.outer", None), ("ds.raises", 0),
                                                   ("ds.after", None), ("ds.open", 2)]
    assert all(r.end_ns is not None for r in recs) and tr._stack() == []
    ranges = [e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("ds.")]
    assert sorted(ranges) == sorted(r.name for r in recs)


def test_spans_lie_on_the_profiles_clock():
    """Each span in memory has its range in the profile, inside its own
    stamps with less than 1 ms at each end."""
    tr = trace.Tracer()
    with _profile() as prof:
        for k in range(3):
            with tr.span("ds.clock", id=k):
                torch.ones(64).sum()
                with tr.span("ds.clock.inner"):
                    time.sleep(0.002)
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("ds.")]
    assert all(str(e.activity_type()) == "user_annotation" for e in events)
    recs = tr.spans()
    assert len(recs) == 6
    for r in recs:
        inside = [e for e in events if e.name() == r.name
                  and r.start_ns <= e.start_ns()
                  and e.start_ns() + e.duration_ns() <= r.end_ns]
        assert len(inside) == 1, r
        e = inside[0]
        assert e.start_ns() - r.start_ns < 1_000_000
        assert r.end_ns - (e.start_ns() + e.duration_ns()) < 1_000_000


def test_past_the_bound_recording_stops():
    tr = trace.Tracer(limit=3)
    with _profile() as prof:
        for k in range(3):
            with tr.span("ds.kept", id=k):
                with tr.span("ds.kept.inner"):
                    pass
    recs = tr.spans()
    assert [r.name for r in recs] == ["ds.kept", "ds.kept.inner", "ds.kept"]
    assert [r.id for r in recs] == [0, None, 1]
    assert all(r.end_ns is not None for r in recs)
    # dropped spans still get their range in the profile
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("ds.")]
    assert len(ranges) == 6


# ---------------------------------------------------------------- serving
VOCAB, K, MEL = 24, 5, 80
LJ_HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
         "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
         "ffn_padding": "SAME", "dropout": 0.0, "predictor_hidden": -1,
         "predictor_layers": 2, "predictor_kernel": 5, "predictor_dropout": 0.0,
         "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "use_pitch_embed": True,
         "pitch_type": "frame", "use_uv": True, "pitch_norm": "log",
         "use_energy_embed": False, "use_spk_id": False, "use_spk_embed": False,
         "use_midi": False, "audio_num_mel_bins": MEL, "audio_sample_rate": 22050,
         "hop_size": 256, "timesteps": 8, "K_step": K, "schedule_type": "linear",
         "max_beta": 0.06, "diff_decoder_type": "wavenet", "residual_layers": 4,
         "residual_channels": 32, "dilation_cycle_length": 1, "keep_bins": MEL,
         "spec_min": [-6.0] * MEL, "spec_max": [1.5] * MEL, "task_cls": "diff",
         "txt_pad_multiple": 16, "mel_pad_multiple": 64, "seed": 1234}
LJ_VOC = {"vocoder": "hifigan", "vocoder_ckpt": "", "vocoder_backend": "mrf",
          "use_nsf": False, "resblock": "1", "upsample_rates": [16, 16],
          "upsample_kernel_sizes": [32, 32], "upsample_initial_channel": 32,
          "resblock_kernel_sizes": [3, 7, 11],
          "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
          "audio_sample_rate": 22050, "audio_num_mel_bins": MEL}
SING_VOCAB, SING_MEL, SING_HOP = len(svs.CPOP_PHONE_LIST) + 3, 16, 16
SING_HP = dict(LJ_HP, use_pitch_embed=False, use_midi=True, rel_pos=True,
               audio_num_mel_bins=SING_MEL, audio_sample_rate=24000, hop_size=SING_HOP,
               timesteps=50, K_step=50, pndm_speedup=10, gaussian_start=True,
               max_beta=0.02, dilation_cycle_length=4, keep_bins=SING_MEL,
               spec_min=[-6.0] * SING_MEL, spec_max=[1.5] * SING_MEL, max_frames=400)
SING_VOC = dict(LJ_VOC, use_nsf=True, nsf_source_mode="exact", upsample_rates=[4, 2, 2],
                upsample_kernel_sizes=[8, 4, 4], audio_sample_rate=24000,
                audio_num_mel_bins=SING_MEL, hop_size=SING_HOP)


def _build(kind):
    torch.manual_seed(0)
    if kind == "ddpm":
        hp, vocab, voc_hp, pe = LJ_HP, VOCAB, LJ_VOC, None
    else:
        hp, vocab, voc_hp = SING_HP, SING_VOCAB, SING_VOC
        pe = PitchExtractor(PEConfig.from_hparams(hp))
    task = DiffSingerTask(hp, vocab, device="cpu")
    # a nonzero DiffNet output projection (zero at init), so the sampler moves x
    with torch.no_grad():
        proj = task.denoise_fn.output_projection
        proj.weight.copy_(torch.randn_like(proj.weight) * 0.1)
    return hp, task, HifiGAN(voc_hp, device="cpu"), pe


def _requests(kind, rng):
    out = []
    for t_txt, t_mel in ((20, 100), (12, 64), (17, 90)):
        b = {"txt_tokens": rng.randint(3, 20, size=(1, t_txt)).astype(np.int64)}
        if kind == "ddpm":
            mel2ph = np.zeros((1, t_mel), np.int64)
            mel2ph[0, :t_txt * (t_mel // t_txt)] = np.repeat(np.arange(1, t_txt + 1),
                                                             t_mel // t_txt)
            b.update(mel2ph=mel2ph,
                     f0=rng.uniform(120, 300, size=(1, t_mel)).astype(np.float32),
                     uv=(rng.rand(1, t_mel) < 0.2).astype(np.float32))
        else:
            b.update(pitch_midi=rng.randint(50, 75, size=(1, t_txt)).astype(np.int64),
                     midi_dur=(rng.rand(1, t_txt) * 0.5).astype(np.float32),
                     is_slur=(rng.rand(1, t_txt) < 0.25).astype(np.int64))
        out.append((b, t_mel))
    return out


def _check_batch(recs, i, steps, with_pe):
    """The span tree of the device batch ``i``: its assembly, FS2, the
    sampler's steps, the PE, the vocoder, the fetch."""
    want = ["ds.serve.stack", "ds.fs2", "ds.sampler"] + (["ds.pe"] if with_pe else []) + \
        ["ds.vocoder", "ds.serve.fetch"]
    assert _names(recs, i) == want
    sampler = next(j for j, r in enumerate(recs) if r.parent == i and r.name == "ds.sampler")
    step_spans = _children(recs, sampler)
    assert [r.name for r in step_spans] == ["ds.sampler.step"] * steps
    assert [r.id for r in step_spans] == list(range(steps))
    # nothing issues spans below a step, the PE or the vocoder
    for j, r in enumerate(recs):
        if r.parent is not None and recs[r.parent].name in ("ds.sampler.step", "ds.pe",
                                                             "ds.vocoder"):
            raise AssertionError(f"span {r.name} under {recs[r.parent].name}")


@pytest.mark.parametrize("kind", ["ddpm", "plms_pe"])
def test_synthesize_many_spans_and_unchanged_waveforms(kind):
    hp, task, voc, pe = _build(kind)
    syn = FusedSynthesizer(hp, task, voc, pe=pe, use_gt_dur=kind == "ddpm",
                           use_gt_f0=kind == "ddpm", device="cpu")
    requests = _requests(kind, np.random.RandomState(1))
    plan = syn.plan(requests)
    assert [(t, [i for i, _ in items], b) for t, items, b in plan] == \
        [(64, [1], 1), (128, [0, 2], 2)]
    off = syn.synthesize_many(requests, seed=5)
    trace.clear()
    with _profile():
        on = syn.synthesize_many(requests, seed=5)
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    recs = trace.spans()
    trace.clear()
    batches = [i for i, r in enumerate(recs) if r.name == "ds.serve.batch"]
    assert len(batches) == len(plan) and all(recs[i].parent is None for i in batches)
    # one step a DDPM step; PLMS: 50 steps at speedup 10
    steps = K if kind == "ddpm" else 5
    for i in batches:
        _check_batch(recs, i, steps, pe is not None)


def test_infer_once_spans_and_unchanged_waveform():
    hp, task, voc, pe = _build("plms_pe")
    infer = svs.DiffSingerE2EInfer(hp, task, voc, pe=pe, device="cpu")
    off = infer.infer_once(svs.EXAMPLE_INPUT)
    trace.clear()
    with _profile():
        on = infer.infer_once(svs.EXAMPLE_INPUT)
        again = infer.infer_once(svs.EXAMPLE_INPUT)
    assert np.array_equal(off, on) and np.array_equal(on, again)
    recs = trace.spans()
    trace.clear()
    requests = [i for i, r in enumerate(recs) if r.name == "ds.svs.request"]
    assert len(requests) == 2 and all(recs[i].parent is None for i in requests)
    for i in requests:
        assert _names(recs, i) == ["ds.svs.frontend", "ds.svs.frontend", "ds.serve.batch"]
        batch = next(j for j, r in enumerate(recs) if r.parent == i
                     and r.name == "ds.serve.batch")
        _check_batch(recs, batch, 5, True)   # PLMS: 50 steps at speedup 10


# ---------------------------------------------------------------- training
def test_train_step_spans_and_unchanged_steps():
    hp = g._tiny_hp()
    rng = np.random.RandomState(3)
    batch = {k: v for k, v in g._synthetic_batch(rng, b=2, t_txt=16, t_mel=64).items()
             if isinstance(v, np.ndarray)}

    def two_steps(traced):
        torch.manual_seed(0)
        task = DiffSingerTask(hp, 16, device="cpu")
        trainer = Trainer(hp, task, device="cpu")
        trainer.initialize()
        gen = torch.Generator().manual_seed(4)
        if traced:
            with _profile():
                losses = [trainer.train_step(batch, generator=gen) for _ in range(2)]
        else:
            losses = [trainer.train_step(batch, generator=gen) for _ in range(2)]
        return losses, {k: v.clone() for k, v in task.state_dict().items()}

    trace.clear()
    (l_off, p_off), (l_on, p_on) = two_steps(False), two_steps(True)
    for a, b in zip(l_off, l_on):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert p_off.keys() == p_on.keys() and all(torch.equal(p_off[k], p_on[k]) for k in p_off)
    recs = trace.spans()
    trace.clear()
    steps = [i for i, r in enumerate(recs) if r.name == "ds.train.step"]
    assert [recs[i].id for i in steps] == [0, 1]
    for i in steps:
        assert recs[i].parent is None
        assert _names(recs, i) == ["ds.train.h2d", "ds.train.forward", "ds.train.backward",
                                   "ds.train.optimizer"]
