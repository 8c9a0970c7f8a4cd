"""The singing slice as a whole: the port's FusedSynthesizer with MIDI input,
PLMS, the PitchExtractor and the NSF vocoder against the JAX one; the SVS
frontend against the JAX ``BaseSVSInfer``; and the guards of this slice.

Same weights (the JAX trees through ``convert/from_jax.py``), the main-path
switches at small widths (cycle-4 bf16 DiffNet stack through the kernel
path, ``vocoder_backend: mrf`` with NSF, exact source), and the same draws:
the PLMS start noise and the NSF source draws made with jax.random from the
keys serve.py, diffusion.py:sample and hifigan.py:sine_source split. Phone
durations are fixed (the duration head's weight is zero, its bias log 5:
four frames a phone) and the PitchExtractor's uv logit sits far below 0, so
that no 1e-6 difference can move a rounded duration or a voicing decision;
its padding mask still zeroes the bucket tail. Tolerance 1e-4 on waveforms in
[-1, 1], as for the LJ slice: the bf16 stack matches JAX to float32
summation order, which PLMS carries through 5 steps without DDPM's clipping;
the rest is float32 (measured: at most 4.3e-6).
The frontend must agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.inference import svs as jsvs
from diffsinger_tpu.inference.serve import FusedSynthesizer as JSynth
from diffsinger_tpu.inference.vocoder import HifiGAN as JHifiGAN
from diffsinger_tpu.models import pe as jpe
from diffsinger_tpu.training.tasks import build_task
from diffsinger_tpu_torch.convert.from_jax import (hifigan_state_dict, pe_state_dict,
                                                   task_state_dict)
from diffsinger_tpu_torch.inference import svs as tsvs
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
from diffsinger_tpu_torch.training.tasks import DiffSingerTask

torch.set_num_threads(1)
VOCAB = len(tsvs.CPOP_PHONE_LIST) + 3
MEL, HOP, SR = 16, 16, 24000
FRAMES_PER_PHONE = 4
WAV_TOL = 1e-4
HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
      "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
      "ffn_padding": "SAME", "dropout": 0.0, "predictor_hidden": -1,
      "predictor_layers": 2, "predictor_kernel": 5, "predictor_dropout": 0.0,
      "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "use_pitch_embed": False,
      "pitch_type": "frame", "use_uv": True, "pitch_norm": "log",
      "use_energy_embed": False, "use_spk_id": False, "use_spk_embed": False,
      "use_midi": True, "rel_pos": True, "audio_num_mel_bins": MEL,
      "audio_sample_rate": SR, "hop_size": HOP, "timesteps": 50, "K_step": 50,
      "pndm_speedup": 10, "gaussian_start": True, "schedule_type": "linear",
      "max_beta": 0.02, "diff_decoder_type": "wavenet", "residual_layers": 4,
      "residual_channels": 32, "dilation_cycle_length": 4, "keep_bins": MEL,
      "spec_min": [-6.0] * MEL, "spec_max": [1.5] * MEL, "task_cls": "diff",
      "compute_dtype": "bfloat16", "use_pallas_diffnet": True, "max_frames": 400,
      "txt_pad_multiple": 16, "mel_pad_multiple": 64, "seed": 1234}
VOC_HP = {"vocoder": "hifigan", "vocoder_ckpt": "", "vocoder_backend": "mrf",
          "use_nsf": True, "nsf_source_mode": "exact", "resblock": "1",
          "upsample_rates": [4, 2, 2], "upsample_kernel_sizes": [8, 4, 4],
          "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
          "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
          "audio_sample_rate": SR, "audio_num_mel_bins": MEL, "hop_size": HOP}
WORD_INPUT = {"text": "小酒窝长睫毛AP是你最美的记号",
              "notes": "C#4/Db4 | F#4/Gb4 | G#4/Ab4 | A#4/Bb4 F#4/Gb4 | F#4/Gb4 C#4/Db4 | "
                       "C#4/Db4 | rest | C#4/Db4 | A#4/Bb4 | G#4/Ab4 | A#4/Bb4 G#4/Ab4 | "
                       "F#4/Gb4 | C#4/Db4 | C#4/Db4",
              "notes_duration": "0.407 | 0.376 | 0.242 | 0.509 0.183 | 0.315 0.235 | "
                                "0.361 | 0.223 | 0.377 | 0.340 | 0.299 | 0.344 0.283 | "
                                "0.323 | 0.360 | 0.300",
              "input_type": "word"}


def _rand(rng, shape, scale):
    return jnp.asarray(rng.randn(*shape).astype(np.float32) * scale)


def _build_pair(hp):
    """The JAX and the port's FusedSynthesizer for ``hp`` on shared weights."""
    rng = np.random.RandomState(0)
    jtask = build_task(hp, vocab_size=VOCAB)
    init_batch = {"txt_tokens": np.ones((1, 8), np.int64),
                  "mel2ph": np.ones((1, 16), np.int64),
                  "mels": np.zeros((1, 16, MEL), np.float32),
                  "pitch_midi": np.full((1, 8), 60, np.int64),
                  "midi_dur": np.full((1, 8), 0.2, np.float32),
                  "is_slur": np.zeros((1, 8), np.int64)}
    params = jtask.init_params(jax.random.PRNGKey(0), init_batch)
    params["fs2"] = dict(params["fs2"])
    params["fs2"]["dur_predictor"] = dict(params["fs2"]["dur_predictor"])
    params["fs2"]["dur_predictor"]["linear"] = {  # every phone FRAMES_PER_PHONE frames
        "kernel": jnp.zeros((32, 1), jnp.float32),
        "bias": jnp.full((1,), np.log(FRAMES_PER_PHONE + 1.0), jnp.float32)}
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {  # zero at init
        "kernel": _rand(rng, (1, 32, MEL), 0.1), "bias": jnp.zeros((MEL,), jnp.float32)}

    jpe_mod = jpe.PitchExtractor(jpe.PEConfig.from_hparams(hp))
    pe_vars = jpe_mod.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, MEL)))
    pe_params = dict(pe_vars["params"])
    pe_params["pitch_predictor"] = dict(pe_params["pitch_predictor"])
    pe_params["pitch_predictor"]["linear"] = {  # f0 near 2^7.5 Hz, always voiced
        "kernel": _rand(rng, (32, 2), 0.01),
        "bias": jnp.asarray([7.5, -4.0], jnp.float32)}
    stats = {name: {"mean": _rand(rng, bn["mean"].shape, 0.2),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, bn["var"].shape)
                                       .astype(np.float32))}
             for name, bn in pe_vars["batch_stats"]["mel_prenet"].items()}
    pe_vars = {"params": pe_params, "batch_stats": {"mel_prenet": stats}}

    jvoc = JHifiGAN(VOC_HP)
    vparams = jvoc.model.init(jax.random.PRNGKey(1), np.zeros((1, 8, MEL), np.float32),
                              np.full((1, 8), 200.0, np.float32),
                              jax.random.PRNGKey(3))["params"]
    jvoc.params = jax.tree_util.tree_map(lambda a: _rand(rng, a.shape, 0.05), vparams)

    ttask = DiffSingerTask(hp, VOCAB, device="cpu")
    ttask.load_state_dict(task_state_dict(params), strict=True)
    tvoc = HifiGAN(VOC_HP, device="cpu")
    tvoc.load_state_dict(hifigan_state_dict(jvoc.params), strict=True)
    tpe = PitchExtractor(PEConfig.from_hparams(hp))
    tpe.load_state_dict(pe_state_dict(pe_vars), strict=True)
    jsyn = JSynth(hp, jtask, params, jvoc, pe=(jpe_mod, pe_vars))
    tsyn = FusedSynthesizer(hp, ttask, tvoc, pe=tpe, device="cpu")
    return jsyn, tsyn, (ttask, tvoc, tpe)


@pytest.fixture(scope="module")
def slice_pair():
    return _build_pair(HP)


# the shipped singing configs set no compute_dtype: a float32 stack; JAX runs
# its shipped serving path, use_pallas_diffnet off (diffnet.apply on the
# hoisted cond projections)
HP_F32 = dict(HP, compute_dtype="float32", use_pallas_diffnet=False)


@pytest.fixture(scope="module")
def slice_pair_f32():
    return _build_pair(HP_F32)


def _request(rng, n_phones, t_mel):
    tokens = rng.randint(3, VOCAB, size=(1, n_phones)).astype(np.int64)
    pitch_midi = rng.randint(50, 75, size=(1, n_phones)).astype(np.int64)
    pitch_midi[0, 0] = 0  # a rest
    return {"txt_tokens": tokens, "pitch_midi": pitch_midi,
            "midi_dur": (rng.rand(1, n_phones) * 0.5).astype(np.float32),
            "is_slur": (rng.rand(1, n_phones) < 0.25).astype(np.int64)}, t_mel


def jax_draws(rng_g, b, t_mel):
    """The draws of one JAX batch key: PLMS start noise and NSF source."""
    rng_s, rng_v = jax.random.split(rng_g)
    start = jax.random.normal(jax.random.split(rng_s)[1], (b, t_mel, MEL))
    rng_phase, rng_noise = jax.random.split(rng_v)
    rand_ini = jax.random.uniform(rng_phase, (b, 1, 9)).at[:, :, 0].set(0.0)
    noise = jax.random.normal(rng_noise, (b, t_mel * HOP, 9))
    return np.asarray(start)[None], (np.asarray(rand_ini), np.asarray(noise))


def test_singing_synthesize_many_matches_jax(slice_pair):
    jsyn, tsyn, _ = slice_pair
    rng = np.random.RandomState(1)
    # 10 and 13 phones -> 40 and 52 frames, bucket 64; 20 phones -> 80, bucket 128
    requests = [_request(rng, 10, 50), _request(rng, 20, 90), _request(rng, 13, 60)]
    key = jax.random.PRNGKey(7)
    want = jsyn.synthesize_many(requests, rng=key)
    plan = tsyn.plan(requests)
    assert [(t, [i for i, _ in items], b) for t, items, b in plan] == \
        [(64, [0, 2], 2), (128, [1], 1)]
    noises, sources, rng_k = [], [], key
    for t_mel_b, _, b_pad in plan:
        rng_k, rng_g = jax.random.split(rng_k)
        noise, source = jax_draws(rng_g, b_pad, t_mel_b)
        noises.append(noise)
        sources.append(source)
    got = tsyn.synthesize_many(requests, noises=noises, sources=sources)
    for (batch, _), g, w in zip(requests, got, want):
        n = batch["txt_tokens"].shape[1] * FRAMES_PER_PHONE
        assert g.shape == w.shape == (n * HOP,)
        np.testing.assert_allclose(g, np.asarray(w), atol=WAV_TOL)
    assert max(np.abs(w).max() for w in want) > 1e-2


def test_svs_e2e_call_matches_jax(slice_pair):
    """DiffSingerE2EInfer on EXAMPLE_INPUT through the port against the JAX
    synthesizer's __call__ on the JAX frontend's batch."""
    jsyn, _, (ttask, tvoc, tpe) = slice_pair
    infer = tsvs.DiffSingerE2EInfer(HP, ttask, tvoc, pe=tpe, device="cpu")
    jinfer = object.__new__(jsvs.DiffSingerE2EInfer)
    jinfer.hp = HP
    jinfer.ph_encoder = jsvs.TokenTextEncoder(jsvs.CPOP_PHONE_LIST, replace_oov=",")
    jinfer.pinyin2phs = jsvs.build_pinyin2ph_map()
    jinfer.spk_map = {"opencpop": 0}
    item = jinfer.preprocess_input(jsvs.EXAMPLE_INPUT, "phoneme")
    t_mel = jinfer.estimate_t_mel(item)
    key = jax.random.PRNGKey(5)
    want = jsyn(jinfer.input_to_batch(item), t_mel, rng=key)
    t_b = -(-t_mel // 64) * 64
    noise, source = jax_draws(key, 1, t_b)
    got = infer.infer_once(tsvs.EXAMPLE_INPUT, noise=noise, source=source)
    n_ph = len(tsvs.EXAMPLE_INPUT["ph_seq"].split())
    assert got.shape == want.shape == (n_ph * FRAMES_PER_PHONE * HOP,)
    np.testing.assert_allclose(got, np.asarray(want), atol=WAV_TOL)
    # the cascade variant ignores the PE: no f0 from this model, no source
    cascade = tsvs.DiffSingerCascadeInfer(HP, ttask, tvoc, pe=tpe, device="cpu")
    assert cascade.fused.pe is None and infer.fused.pe is tpe


def test_singing_call_pads_midi_keys_and_warmup_runs(slice_pair):
    _, tsyn, _ = slice_pair
    tsyn.warmup([64], batch_sizes=(2,))
    batch, t_mel = _request(np.random.RandomState(4), 7, 40)  # 7 tokens: pad to 16
    a = tsyn(batch, t_mel, seed=3)
    b = tsyn(batch, t_mel, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (7 * FRAMES_PER_PHONE * HOP,) and np.isfinite(a).all()


@pytest.mark.parametrize("kind", ["phoneme", "word"])
def test_svs_preprocessing_matches_jax_exactly(kind):
    jinfer = object.__new__(jsvs.BaseSVSInfer)
    jinfer.hp = dict(HP, max_frames=8000, hop_size=128)
    jinfer.ph_encoder = jsvs.TokenTextEncoder(jsvs.CPOP_PHONE_LIST, replace_oov=",")
    jinfer.pinyin2phs = jsvs.build_pinyin2ph_map()
    jinfer.spk_map = {"opencpop": 0}
    tinfer = object.__new__(tsvs.BaseSVSInfer)
    tinfer.hp = jinfer.hp
    tinfer.ph_encoder = tsvs.TokenTextEncoder(tsvs.CPOP_PHONE_LIST, replace_oov=",")
    tinfer.pinyin2phs = tsvs.build_pinyin2ph_map()
    tinfer.spk_map = {"opencpop": 0}
    assert tinfer.pinyin2phs == jinfer.pinyin2phs
    inp = tsvs.EXAMPLE_INPUT if kind == "phoneme" else WORD_INPUT
    want = jinfer.preprocess_input(inp, kind)
    got = tinfer.preprocess_input(inp, kind)
    assert want is not None and got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["pitch_midi"].dtype == want["pitch_midi"].dtype
    assert tinfer.estimate_t_mel(got) == jinfer.estimate_t_mel(want)
    jb, tb = jinfer.input_to_batch(want), tinfer.input_to_batch(got)
    assert jb.keys() == tb.keys()
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    if kind == "word":  # slurs repeat the word's last phone on the extra notes
        assert sum(got["is_slur"]) == 3 and "AP" in got["ph"].split()
        bad = dict(WORD_INPUT, notes="C4 | D4")
        assert tinfer.preprocess_input(bad, "word") is None


def test_midi_training_and_checkpoints_raise(tmp_path):
    """The MIDI task trains with its word-boundary duration losses (held
    against JAX in tests/test_torch_midi_train.py); a checkpoint on disk
    beside an object passed for the same part raises."""
    task = DiffSingerTask(dict(HP, residual_layers=2), VOCAB, device="cpu")
    assert task.hp["task_type"] == "midi"
    batch = {"txt_tokens": np.ones((1, 4), np.int64), "mels": np.ones((1, 8, MEL)),
             "mel2ph": np.repeat(np.arange(1, 5), 2)[None], "f0": np.ones((1, 8)),
             "uv": np.zeros((1, 8)), "energy": np.zeros((1, 8)),
             "pitch_midi": np.full((1, 4), 60), "word_boundary": np.array([[0, 1, 0, 1]])}
    _, losses = task.train_loss(batch, generator=torch.Generator().manual_seed(0))
    assert {"mel", "pdur", "wdur", "sdur"} <= set(losses)
    assert all(torch.isfinite(v) for v in losses.values())
    with pytest.raises(KeyError, match="word_boundary"):
        task.train_loss({k: v for k, v in batch.items() if k != "word_boundary"},
                        generator=torch.Generator().manual_seed(0))
    voc = HifiGAN(VOC_HP, device="cpu")
    pe = PitchExtractor(PEConfig.from_hparams(HP))
    (tmp_path / "model_ckpt_steps_100.ckpt").write_bytes(b"")
    # a checkpoint on disk beside an object passed for the same part: which
    # one to use is not guessed
    for key in ("pe_ckpt", "vocoder_ckpt", "work_dir"):
        with pytest.raises(ValueError, match=key):
            tsvs.DiffSingerE2EInfer(dict(HP, **{key: str(tmp_path)}), task, voc, pe=pe,
                                    device="cpu")
    # paths that hold no checkpoint (the released names, absent here) are fine
    tsvs.DiffSingerE2EInfer(dict(HP, pe_ckpt="checkpoints/0102_xiaoma_pe"), task, voc,
                            device="cpu")


def test_singing_float32_stack_matches_jax_shipped_path(slice_pair_f32):
    """A float32 request as the shipped ds1000 config makes it: the port runs
    its stack wrapper (the plain twin on the CPU, the float32 tensor-core body
    on the card) against JAX's ``diffnet.apply``. The sampler mel within 5e-5
    of its scale (module parity; PLMS carries float32 summation-order
    differences through 5 steps without clipping), the waveform within
    WAV_TOL, on the JAX draws."""
    jsyn, tsyn, (ttask, _, _) = slice_pair_f32
    assert ttask.compute_dtype is None and not jsyn.hp["use_pallas_diffnet"]
    rng = np.random.RandomState(2)
    requests = [_request(rng, 12, 50), _request(rng, 14, 60)]
    key = jax.random.PRNGKey(11)
    want = jsyn.synthesize_many(requests, rng=key)
    (t_mel_b, items, b_pad), = tsyn.plan(requests)
    _, rng_g = jax.random.split(key)
    noise, source = jax_draws(rng_g, b_pad, t_mel_b)
    got = tsyn.synthesize_many(requests, noises=[noise], sources=[source])
    for (batch, _), g, w in zip(requests, got, want):
        assert g.shape == w.shape == (batch["txt_tokens"].shape[1] * FRAMES_PER_PHONE * HOP,)
        np.testing.assert_allclose(g, np.asarray(w), atol=WAV_TOL)
    # the sampler mel of the same batch, on the same start noise
    stacked = tsyn._stack_group(items, 16, t_mel_b)
    rng_s, _ = jax.random.split(rng_g)
    want_mel = np.asarray(jsyn.task.inference(jsyn.params, stacked, rng_s, t_mel=t_mel_b,
                                              use_gt_dur=False)["mel_out"])
    with torch.no_grad():
        got_mel = ttask.inference(stacked, t_mel=t_mel_b, use_gt_dur=False,
                                  noise=torch.from_numpy(np.array(noise)))["mel_out"].numpy()
    scale = max(float(np.abs(want_mel).max()), 1.0)
    np.testing.assert_allclose(got_mel, want_mel, atol=5e-5 * scale)
    assert np.abs(want_mel).max() > 1.0
