"""The cwt slice as a whole: DiffSpeech with ``pitch_type: cwt`` from text to
mel through ``DiffSingerTask.inference`` and to waveform through
``FusedSynthesizer``, against the JAX task and the JAX synthesizer on the same
weights (``convert/from_jax.py``) and the same noise, drawn with jax.random
from the keys the JAX code splits (``diffusion.py:239-294``, ``serve.py``).
Also ``offline_boost`` from a batch's ``fs2_mels``, the FFT denoiser
(``diff_decoder_type: fft``) and a speaker batch (``use_spk_id``) through
``synthesize_many``.

Durations are given (``mel2ph``); the pitch is predicted from the CWT head,
so the weights put the F0 in the voice range and each test asserts that
every coarse-pitch value and voicing logit lies at least 2e-3 from its
rounding boundary. Tolerances: the task's mel atol 1e-4 (float32 DDPM over
the float32 stack twin, values in [-6, 1.5]); waveforms atol 1e-4 (the bf16
stack matches JAX's to float32 summation order, as in test_torch_serve.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.inference.serve import FusedSynthesizer as JSynth
from diffsinger_tpu.inference.vocoder import HifiGAN as JHifiGAN
from diffsinger_tpu.training.tasks import build_task
from diffsinger_tpu.utils import pitch as jpitch
from diffsinger_tpu_torch.convert.from_jax import hifigan_state_dict, task_state_dict
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.training.tasks import DiffSingerTask

torch.set_num_threads(1)
VOCAB, K, MEL = 24, 4, 80
MARGIN = 2e-3
HP = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
      "enc_ffn_kernel_size": 9, "dec_ffn_kernel_size": 9, "ffn_act": "gelu",
      "ffn_padding": "SAME", "dropout": 0.0, "predictor_hidden": -1,
      "predictor_layers": 2, "predictor_kernel": 5, "predictor_dropout": 0.0,
      "dur_predictor_layers": 2, "dur_predictor_kernel": 3, "use_pitch_embed": True,
      "pitch_type": "cwt", "cwt_hidden_size": 16, "cwt_std_scale": 0.8, "use_uv": True,
      "pitch_norm": "log", "use_energy_embed": False, "use_spk_id": False,
      "use_spk_embed": False, "num_spk": 4, "use_midi": False, "audio_num_mel_bins": MEL,
      "audio_sample_rate": 22050, "hop_size": 256, "timesteps": 8, "K_step": K,
      "schedule_type": "linear", "max_beta": 0.06, "diff_decoder_type": "wavenet",
      "residual_layers": 4, "residual_channels": 32, "dilation_cycle_length": 1,
      "keep_bins": MEL, "spec_min": [-6.0] * MEL, "spec_max": [1.5] * MEL,
      "task_cls": "diff", "compute_dtype": "float32", "txt_pad_multiple": 16,
      "mel_pad_multiple": 64, "seed": 1234}
VOC_HP = {"vocoder": "hifigan", "vocoder_ckpt": "", "vocoder_backend": "mrf",
          "use_nsf": False, "resblock": "1", "upsample_rates": [16, 16],
          "upsample_kernel_sizes": [32, 32], "upsample_initial_channel": 32,
          "resblock_kernel_sizes": [3, 7, 11],
          "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
          "audio_sample_rate": 22050, "audio_num_mel_bins": MEL}


def jax_sampler_noise(rng, shape):
    """The DDPM draws of GaussianDiffusion.sample from ``rng``: the boost
    noise, then one per reverse step."""
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape)]
    draws += [jax.random.normal(r, shape) for r in jax.random.split(rng, K)]
    return np.stack([np.asarray(d) for d in draws])


def _batch(rng, b, t_txt, t_mel):
    tokens = rng.randint(3, VOCAB, size=(b, t_txt)).astype(np.int64)
    mel2ph = np.zeros((b, t_mel), np.int64)
    for i in range(b):
        n = t_txt - 2 * i  # row i: 2i padded phones
        tokens[i, n:] = 0
        per = t_mel // t_txt
        mel2ph[i, : n * per] = np.repeat(np.arange(1, n + 1), per)
    return {"txt_tokens": tokens, "mel2ph": mel2ph,
            "mels": np.zeros((b, t_mel, MEL), np.float32),
            "spk_ids": rng.randint(0, 5, size=(b,)).astype(np.int64)}


def _jax_task(hp, seed=0):
    rng = np.random.RandomState(seed)
    jtask = build_task(hp, vocab_size=VOCAB)
    params = jtask.init_params(jax.random.PRNGKey(seed), _batch(rng, 1, 8, 16))
    p = jax.tree_util.tree_map(np.array, params)
    # the cwt statistics put F0 around e^5.2 = 181 Hz with some spread
    p["fs2"]["cwt_stats_2"]["kernel"] *= 0.1
    p["fs2"]["cwt_stats_2"]["bias"][:] = [5.2, 0.35]
    p["fs2"]["cwt_predictor"]["linear"]["kernel"][:, -1] *= 5.0  # voicing logits off 0
    if "output_projection" in p["denoiser"]:  # zero at init
        p["denoiser"]["output_projection"]["kernel"] = (
            rng.randn(*p["denoiser"]["output_projection"]["kernel"].shape) * 0.1
        ).astype(np.float32)
    return jtask, p


def _port_task(hp, params):
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    task.load_state_dict(task_state_dict(params), strict=True)
    return task.eval()


def assert_rounding_margins(jtask, params, batch):
    """The predicted coarse pitch and voicing of ``batch`` (FS2 on the JAX
    side) are not near a rounding boundary."""
    kw = jtask._fs2_kwargs(batch)
    ret = jtask.m.fs2.apply({"params": params["fs2"]}, jnp.asarray(batch["txt_tokens"]),
                            mel2ph=jnp.asarray(batch["mel2ph"]), skip_decoder=True,
                            infer=True, **kw)
    real = np.asarray(batch["mel2ph"]) > 0
    f0 = np.asarray(ret["f0_denorm"], np.float64)
    v = ((1127 * np.log(1 + f0 / 700) - jpitch.F0_MEL_MIN) * 254
         / (jpitch.F0_MEL_MAX - jpitch.F0_MEL_MIN) + 1)
    v = v[real & (f0 > 0) & (v > 1.5) & (v < 254.5)]
    assert v.size > 10 and np.abs(v % 1 - 0.5).min() > MARGIN
    assert np.abs(np.asarray(ret["cwt"])[..., -1])[real].min() > MARGIN


@pytest.mark.parametrize("case", ["cwt", "offline_boost", "fft_denoiser", "split_spk_id"])
def test_task_inference_matches_jax(case):
    hp = dict(HP)
    if case == "offline_boost":
        hp["offline_boost"] = True
    if case == "fft_denoiser":
        hp["diff_decoder_type"] = "fft"
    if case == "split_spk_id":
        hp.update(use_spk_id=True, use_split_spk_id=True)
    jtask, params = _jax_task(hp)
    task = _port_task(hp, params)
    rng = np.random.RandomState(1)
    batch = _batch(rng, 2, 16, 64)
    if case == "offline_boost":
        batch["fs2_mels"] = rng.uniform(-5.0, 1.0, size=(2, 64, MEL)).astype(np.float32)
    assert_rounding_margins(jtask, params, batch)
    key = jax.random.PRNGKey(4)
    want = jtask.inference(params, batch, key, t_mel=64)
    noise = torch.from_numpy(jax_sampler_noise(key, (2, 64, MEL)))
    got = task.inference(batch, t_mel=64, noise=noise)
    for k in ("decoder_inp", "cwt", "f0_mean", "f0_std", "fs2_mel", "mel_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["f0_denorm"].numpy(), np.asarray(want["f0_denorm"]),
                               rtol=1e-5, err_msg="f0_denorm")
    if case == "offline_boost":  # the boost mel is the batch's; no FS2 mel is decoded
        np.testing.assert_array_equal(got["fs2_mel"].numpy(), batch["fs2_mels"])
    assert float(np.abs(np.asarray(want["mel_out"])).max()) > 1.0


@pytest.fixture(scope="module")
def synth_pair():
    """The main path's switches at small widths (bf16 stack through the
    kernel path, vocoder_backend: mrf), cwt pitch and speaker ids."""
    hp = dict(HP, compute_dtype="bfloat16", use_pallas_diffnet=True, use_spk_id=True)
    jtask, params = _jax_task(hp, seed=2)
    rng = np.random.RandomState(3)
    jvoc = JHifiGAN(VOC_HP)
    vparams = jvoc.model.init(jax.random.PRNGKey(1),
                              np.zeros((1, 8, MEL), np.float32))["params"]
    jvoc.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.04), vparams)
    tvoc = HifiGAN(VOC_HP, device="cpu")
    tvoc.load_state_dict(hifigan_state_dict(jvoc.params), strict=True)
    jsyn = JSynth(hp, jtask, params, jvoc, use_gt_dur=True)
    tsyn = FusedSynthesizer(hp, _port_task(hp, params), tvoc, use_gt_dur=True, device="cpu")
    requests = []
    for t_txt, t_mel, spk in ((20, 100, 1), (12, 64, 3), (17, 90, 4)):
        b = _batch(rng, 1, t_txt, t_mel)
        b["spk_ids"] = np.asarray([spk], np.int64)
        del b["mels"]
        requests.append((b, t_mel))
    return jtask, params, jsyn, tsyn, requests


def test_synthesize_many_with_speakers_matches_jax(synth_pair):
    jtask, params, jsyn, tsyn, requests = synth_pair
    plan = tsyn.plan(requests)
    assert [(t, [i for i, _ in items], b) for t, items, b in plan] == \
        [(64, [1], 1), (128, [0, 2], 2)]
    noises, rng = [], jax.random.PRNGKey(7)
    for t_mel_b, items, b_pad in plan:
        t_txt_b = -(-max(b["txt_tokens"].shape[1] for _, b in items) // 16) * 16
        stacked = tsyn._stack_group(items, t_txt_b, t_mel_b)
        # speaker ids stay [B] (padded rows repeat the first request's)
        assert stacked["spk_ids"].shape == (b_pad,)
        assert_rounding_margins(jtask, params, stacked)
        rng, rng_g = jax.random.split(rng)
        noises.append(jax_sampler_noise(jax.random.split(rng_g)[0], (b_pad, t_mel_b, MEL)))
    want = jsyn.synthesize_many(requests, rng=jax.random.PRNGKey(7))
    got = tsyn.synthesize_many(requests, noises=noises)
    for (batch, _), g, w in zip(requests, got, want):
        n = int((batch["mel2ph"] > 0).sum())
        assert g.shape == w.shape == (n * 256,)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)
    assert max(np.abs(w).max() for w in want) > 1e-2
    # the speakers reach the waveform
    swapped = [(dict(b, spk_ids=np.asarray([0], np.int64)), t) for b, t in requests]
    other = tsyn.synthesize_many(swapped, noises=noises)
    assert max(float(np.abs(a - b).max()) for a, b in zip(got, other)) > 1e-3


def test_speaker_embeddings_stack_unpadded_and_warmup_runs(synth_pair):
    """spk_embed [B, 256] rows are stacked as they are, not padded to the
    text bucket; warm-up feeds zero speaker ids."""
    _, _, _, tsyn, requests = synth_pair
    items = [(i, dict(b, spk_embed=np.full((1, 256), i, np.float32)))
             for i, (b, _) in enumerate(requests[:3])]
    stacked = tsyn._stack_group(items, 32, 128)
    assert stacked["spk_embed"].shape == (4, 256)
    np.testing.assert_array_equal(stacked["spk_embed"][:, 0], [0, 1, 2, 0])
    assert stacked["txt_tokens"].shape == (4, 32)
    tsyn.warmup([64], batch_sizes=(2,))
