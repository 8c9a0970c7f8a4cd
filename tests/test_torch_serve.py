"""The whole slice: the port's FusedSynthesizer against the JAX one.

Same weights (the JAX trees through ``convert/from_jax.py``), the main-path
switches at small widths (bf16 DiffNet stack through the kernel path,
``vocoder_backend: mrf``), ground-truth durations and f0 (a 1e-6 difference
can move a rounded duration or coarse-f0 bin by a whole step), and the same
noise: drawn with jax.random from the key split as serve.py:74 and
diffusion.py:239-294 split it. Tolerance 1e-4 on waveforms in [-1, 1]: the
bf16 stack matches its JAX counterpart to float32 summation order, and the
rest runs in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.inference.serve import FusedSynthesizer as JSynth
from diffsinger_tpu.inference.vocoder import HifiGAN as JHifiGAN
from diffsinger_tpu.training.tasks import build_task
from diffsinger_tpu_torch.convert.from_jax import hifigan_state_dict, task_state_dict
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.training.tasks import DiffSingerTask

torch.set_num_threads(1)
VOCAB, K, MEL = 24, 5, 80
HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
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
      "compute_dtype": "bfloat16", "use_pallas_diffnet": True,
      "txt_pad_multiple": 16, "mel_pad_multiple": 64, "seed": 1234}
# the vocoder's own hparams: the JAX wrapper reads ``use_pitch_embed`` as the
# NSF switch, so the acoustic model's pitch flag must not reach it
VOC_HP = {"vocoder": "hifigan", "vocoder_ckpt": "", "vocoder_backend": "mrf",
          "use_nsf": False, "resblock": "1", "upsample_rates": [16, 16],
          "upsample_kernel_sizes": [32, 32], "upsample_initial_channel": 32,
          "resblock_kernel_sizes": [3, 7, 11],
          "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
          "audio_sample_rate": 22050, "audio_num_mel_bins": MEL}


def _request(rng, t_txt, t_mel):
    tokens = rng.randint(3, VOCAB, size=(1, t_txt)).astype(np.int64)
    mel2ph = np.zeros((1, t_mel), np.int64)
    n = min(t_txt, t_mel)
    mel2ph[0, :n * (t_mel // n)] = np.repeat(np.arange(1, n + 1), t_mel // n)
    mel2ph[0, -3:] = 0  # a few unaligned tail frames
    f0 = rng.uniform(120, 300, size=(1, t_mel)).astype(np.float32)
    uv = (rng.rand(1, t_mel) < 0.2).astype(np.float32)
    return {"txt_tokens": tokens, "mel2ph": mel2ph, "f0": f0, "uv": uv}, t_mel


def jax_sampler_noise(rng, shape):
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape)]
    draws += [jax.random.normal(r, shape) for r in jax.random.split(rng, K)]
    return np.stack([np.asarray(d) for d in draws])


@pytest.fixture(scope="module")
def slice_pair():
    rng = np.random.RandomState(0)
    hp = dict(HP)
    jtask = build_task(hp, vocab_size=VOCAB)
    init_batch = {"txt_tokens": np.ones((1, 8), np.int64),
                  "mel2ph": np.ones((1, 16), np.int64),
                  "mels": np.zeros((1, 16, MEL), np.float32)}
    params = jtask.init_params(jax.random.PRNGKey(0), init_batch)
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {  # zero at init
        "kernel": jnp.asarray(rng.randn(1, 32, MEL).astype(np.float32) * 0.1),
        "bias": jnp.zeros((MEL,), jnp.float32)}
    jvoc = JHifiGAN(VOC_HP)
    vparams = jvoc.model.init(jax.random.PRNGKey(1),
                              np.zeros((1, 8, MEL), np.float32))["params"]
    jvoc.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.04), vparams)

    ttask = DiffSingerTask(hp, VOCAB, device="cpu")
    ttask.load_state_dict(task_state_dict(params), strict=True)
    tvoc = HifiGAN(VOC_HP, device="cpu")
    tvoc.load_state_dict(hifigan_state_dict(jvoc.params), strict=True)
    jsyn = JSynth(hp, jtask, params, jvoc, use_gt_dur=True, use_gt_f0=True)
    tsyn = FusedSynthesizer(hp, ttask, tvoc, use_gt_dur=True, use_gt_f0=True,
                            device="cpu")
    requests = [_request(rng, 20, 100), _request(rng, 12, 64), _request(rng, 17, 90)]
    return jsyn, tsyn, requests


def test_synthesize_many_matches_jax(slice_pair):
    jsyn, tsyn, requests = slice_pair
    key = jax.random.PRNGKey(7)
    want = jsyn.synthesize_many(requests, rng=key)

    plan = tsyn.plan(requests)
    # buckets of 64 frames: 64 -> 64 (one row), 90 and 100 -> 128 (two rows)
    assert [(t, [i for i, _ in items], b) for t, items, b in plan] == \
        [(64, [1], 1), (128, [0, 2], 2)]
    noises, rng = [], key
    for t_mel_b, _, b_pad in plan:
        rng, rng_g = jax.random.split(rng)
        rng_s, _ = jax.random.split(rng_g)
        noises.append(jax_sampler_noise(rng_s, (b_pad, t_mel_b, MEL)))
    got = tsyn.synthesize_many(requests, noises=noises)
    for (batch, _), g, w in zip(requests, got, want):
        n = int((batch["mel2ph"] > 0).sum())
        assert g.shape == w.shape == (n * 256,)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
    assert max(np.abs(w).max() for w in want) > 1e-2


def test_call_and_int16_output(slice_pair):
    jsyn, tsyn, requests = slice_pair
    # the 64-frame request: the same shapes as its synthesize_many batch, so
    # the JAX program compiled there is reused
    batch, t_mel = requests[1]
    key = jax.random.PRNGKey(3)
    want = jsyn(batch, t_mel, rng=key)
    # __call__ keeps the request's own frame count when mel2ph is given
    noise = jax_sampler_noise(jax.random.split(key)[0], (1, t_mel, MEL))
    got = tsyn(batch, t_mel, noise=noise)
    np.testing.assert_allclose(got, want, atol=1e-4)

    tsyn.wav_int16 = True
    try:
        pcm = tsyn(batch, t_mel, noise=noise)
    finally:
        tsyn.wav_int16 = False
    assert pcm.dtype == np.int16 and pcm.shape == got.shape
    np.testing.assert_array_equal(pcm, (np.clip(got, -1, 1) * 32767).astype(np.int16))


def test_default_noise_is_seeded_and_warmup_runs(slice_pair):
    _, tsyn, requests = slice_pair
    tsyn.warmup([64], batch_sizes=(2,))
    a = tsyn.synthesize_many(requests[:2], seed=11)
    b = tsyn.synthesize_many(requests[:2], seed=11)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert np.isfinite(x).all()
