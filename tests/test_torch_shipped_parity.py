"""Three shipped configs as shipped, against the JAX package on the same
weights (``convert/from_jax.py``) and the same draws (made with jax.random from
the keys ``serve.py``, ``diffusion.py:sample`` and ``hifigan.py:sine_source``
split, and passed to the port through its explicit-noise arguments):

  * ``configs/lj/ds_pndm.yaml``: DiffSpeech + PNDM from a Gaussian start,
    ``max_beta`` 0.02, frame pitch and no pitch embedding, HiFiGAN; at
    ``timesteps = K_step = 30`` and ``pndm_speedup = 5``: six PLMS steps, so
    the two-call warm-up, orders 2 and 3 and three order-4 steps run (the
    step at t = 0 barely moves x, so order 4 must also run before it for a
    fault there to show). The sampler mel within 5e-5
    of its scale (module parity; PLMS carries float32 summation-order
    differences without DDPM's clipping) and the waveform within 1e-4, as
    ``test_torch_singing_serve.py`` holds the float32 PLMS path.
  * ``configs/opencpop/ds100_adj_rel.yaml``: OpenCpop e2e, DDPM from a
    Gaussian start on the linear schedule (``max_beta`` 0.06), cycle 4, MIDI +
    ``rel_pos``, the F0 from the PitchExtractor into NSF-HiFiGAN; at
    ``timesteps = K_step = 8``. The mel within 1e-4, the PE's F0 on one mel
    within 1e-5 relative and the NSF waveform within 1e-4, as
    ``test_torch_cwt_serve.py`` holds DDPM.
  * ``configs/popcs/ds_beta6_offline.yaml``: the shallow boost from the
    batch's ``fs2_mels`` (the FS2 decoder skipped), ground-truth durations
    and F0 as the config sets them, the NSF vocoder on that F0; at
    ``timesteps = 8``, ``K_step = 4``. The mel and the waveform within 1e-4.

Only the widths are cut (hidden 32, 2 + 2 FFT layers, DiffNet 4 x 32, a
vocoder of 32 channels); each config keeps its sampler, schedule and
``max_beta`` (not the JAX matrix test's ``max_beta=0.06`` shrink). Phone
durations are fixed by the duration head (zero weight, bias log 5: four
frames a phone) and the PE's uv logit sits far below 0, so that no 1e-6
difference moves a rounded duration or a voicing decision."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.inference.serve import FusedSynthesizer as JSynth
from diffsinger_tpu.inference.vocoder import HifiGAN as JHifiGAN
from diffsinger_tpu.models import pe as jpe
from diffsinger_tpu.training.tasks import build_task
from diffsinger_tpu_torch.config.hparams import set_hparams
from diffsinger_tpu_torch.convert.from_jax import (hifigan_state_dict, pe_state_dict,
                                                   task_state_dict)
from diffsinger_tpu_torch.inference.serve import FusedSynthesizer
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
from diffsinger_tpu_torch.training.tasks import DiffSingerTask

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 40
MEL = 80
FRAMES_PER_PHONE = 4
WAV_TOL = 1e-4
WIDTHS = {"hidden_size": 32, "enc_layers": 2, "dec_layers": 2, "num_heads": 2,
          "predictor_hidden": -1, "predictor_layers": 2, "dur_predictor_layers": 2,
          "residual_layers": 4, "residual_channels": 32, "txt_pad_multiple": 16,
          "mel_pad_multiple": 64}
VOCODERS = {  # the shipped geometries at 32 channels: LJ's hop 256, the singers' 128
    256: {"upsample_rates": [16, 16], "upsample_kernel_sizes": [32, 32]},
    128: {"upsample_rates": [8, 8, 2], "upsample_kernel_sizes": [16, 16, 4]}}


def _hp(rel, **over):
    hp = set_hparams(os.path.join(REPO, "configs", rel))
    hp.update(WIDTHS, **over)
    return hp


def _rand(rng, shape, scale):
    return jnp.asarray(rng.randn(*shape).astype(np.float32) * scale)


def _init_batch(hp):
    b = {"txt_tokens": np.ones((1, 8), np.int64), "mel2ph": np.ones((1, 16), np.int64),
         "mels": np.zeros((1, 16, MEL), np.float32), "f0": np.full((1, 16), 200.0, np.float32),
         "uv": np.zeros((1, 16), np.float32)}
    if hp.get("use_midi"):
        b.update(pitch_midi=np.full((1, 8), 60, np.int64),
                 midi_dur=np.full((1, 8), 0.2, np.float32), is_slur=np.zeros((1, 8), np.int64))
    return b


def _tasks(hp, seed=0):
    """The JAX task, its params (fixed durations, a nonzero DiffNet output
    projection) and the port's task on them."""
    rng = np.random.RandomState(seed)
    jtask = build_task(hp, vocab_size=VOCAB)
    params = jax.tree_util.tree_map(
        np.array, jtask.init_params(jax.random.PRNGKey(seed), _init_batch(hp)))
    lin = params["fs2"]["dur_predictor"]["linear"]
    lin["kernel"][:] = 0.0
    lin["bias"][:] = np.log(FRAMES_PER_PHONE + 1.0)
    proj = params["denoiser"]["output_projection"]  # zero at init
    proj["kernel"] = (rng.randn(*proj["kernel"].shape) * 0.1).astype(np.float32)
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    task.load_state_dict(task_state_dict(params), strict=True)
    assert task.compute_dtype is None  # no shipped config sets compute_dtype
    return jtask, params, task.eval()


def _vocoders(hp, seed=1):
    """The JAX HifiGAN (its default module backend) with seeded weights and
    the port's on them, at the config's hop and NSF switch."""
    voc_hp = {"vocoder": "hifigan", "vocoder_ckpt": "", "use_nsf": bool(hp.get("use_nsf")),
              "nsf_source_mode": "exact", "resblock": "1", "upsample_initial_channel": 32,
              "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
              "audio_sample_rate": hp["audio_sample_rate"], "audio_num_mel_bins": MEL,
              "hop_size": hp["hop_size"], **VOCODERS[int(hp["hop_size"])]}
    jvoc = JHifiGAN(voc_hp)
    mel = np.zeros((1, 8, MEL), np.float32)
    args = (mel, np.full((1, 8), 200.0, np.float32), jax.random.PRNGKey(3)) \
        if jvoc.cfg.use_pitch_embed else (mel,)
    rng = np.random.RandomState(seed)
    jvoc.params = jax.tree_util.tree_map(lambda a: _rand(rng, a.shape, 0.05),
                                         jvoc.model.init(jax.random.PRNGKey(1), *args)["params"])
    voc = HifiGAN(voc_hp, device="cpu")
    voc.load_state_dict(hifigan_state_dict(jvoc.params), strict=True)
    return jvoc, voc


def _pes(hp, seed=2):
    """A seeded PitchExtractor with running statistics, F0 near 2^7.5 Hz and
    every frame voiced, on both sides."""
    rng = np.random.RandomState(seed)
    jmod = jpe.PitchExtractor(jpe.PEConfig.from_hparams(hp))
    pe_vars = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, MEL)))
    params = dict(pe_vars["params"])
    params["pitch_predictor"] = dict(params["pitch_predictor"])
    params["pitch_predictor"]["linear"] = {
        "kernel": _rand(rng, (int(hp["hidden_size"]), 2), 0.01),
        "bias": jnp.asarray([7.5, -4.0], jnp.float32)}
    stats = {name: {"mean": _rand(rng, bn["mean"].shape, 0.2),
                    "var": jnp.asarray(rng.uniform(0.5, 2.0, bn["var"].shape)
                                       .astype(np.float32))}
             for name, bn in pe_vars["batch_stats"]["mel_prenet"].items()}
    pe_vars = {"params": params, "batch_stats": {"mel_prenet": stats}}
    pe = PitchExtractor(PEConfig.from_hparams(hp))
    pe.load_state_dict(pe_state_dict(pe_vars), strict=True)
    return (jmod, pe_vars), pe.eval()


def _request(rng, hp, n_phones):
    req = {"txt_tokens": rng.randint(3, VOCAB, size=(1, n_phones)).astype(np.int64)}
    if hp.get("use_midi"):
        req.update(pitch_midi=rng.randint(50, 75, size=(1, n_phones)).astype(np.int64),
                   midi_dur=(rng.rand(1, n_phones) * 0.5).astype(np.float32),
                   is_slur=(rng.rand(1, n_phones) < 0.25).astype(np.int64))
    return req, n_phones * FRAMES_PER_PHONE


def jax_sampler_draws(rng_s, hp, b, t_mel):
    """The sampler's draws of ``GaussianDiffusion.sample`` from ``rng_s``:
    the start noise, then for DDPM one draw per reverse step."""
    rng, init_rng = jax.random.split(rng_s)
    draws = [jax.random.normal(init_rng, (b, t_mel, MEL))]
    if not hp.get("pndm_speedup"):
        draws += [jax.random.normal(r, (b, t_mel, MEL))
                  for r in jax.random.split(rng, int(hp["K_step"]))]
    return np.stack([np.asarray(d) for d in draws])


def jax_source_draws(rng_v, b, t_wav):
    rng_phase, rng_noise = jax.random.split(rng_v)
    rand_ini = jax.random.uniform(rng_phase, (b, 1, 9)).at[:, :, 0].set(0.0)
    return np.asarray(rand_ini), np.asarray(jax.random.normal(rng_noise, (b, t_wav, 9)))


def _serve_pair(hp, with_pe):
    jtask, params, task = _tasks(hp)
    jvoc, voc = _vocoders(hp)
    jpe_pair, pe = _pes(hp) if with_pe else (None, None)
    jsyn = JSynth(hp, jtask, params, jvoc, pe=jpe_pair)
    syn = FusedSynthesizer(hp, task, voc, pe=pe, device="cpu")
    return jsyn, syn


def _serve_and_compare(hp, jsyn, syn, requests, key, mel_atol):
    """One padded batch through both synthesizers on the JAX draws: the
    waveforms within WAV_TOL, then the sampler mel of that batch within
    ``mel_atol(scale)``. Returns the stacked batch, the JAX mel and the key of
    the vocoder's draws."""
    want = jsyn.synthesize_many(requests, rng=key)
    (t_mel_b, items, b_pad), = syn.plan(requests)
    _, rng_g = jax.random.split(key)
    rng_s, rng_v = jax.random.split(rng_g)
    noise = jax_sampler_draws(rng_s, hp, b_pad, t_mel_b)
    source = jax_source_draws(rng_v, b_pad, t_mel_b * syn.hop) if hp.get("use_nsf") else None
    got = syn.synthesize_many(requests, noises=[noise],
                              sources=None if source is None else [source])
    for (req, t_mel), g, w in zip(requests, got, want):
        assert g.shape == w.shape == (t_mel * syn.hop,)
        np.testing.assert_allclose(g, np.asarray(w), atol=WAV_TOL)
    assert max(np.abs(np.asarray(w)).max() for w in want) > 1e-2
    stacked = syn._stack_group(items, 16, t_mel_b)
    want_mel = np.asarray(jsyn.task.inference(jsyn.params, stacked, rng_s, t_mel=t_mel_b,
                                              use_gt_dur=False)["mel_out"])
    got_mel = syn.task.inference(stacked, t_mel=t_mel_b, use_gt_dur=False,
                                 noise=torch.from_numpy(noise))["mel_out"].numpy()
    scale = max(float(np.abs(want_mel).max()), 1.0)
    np.testing.assert_allclose(got_mel, want_mel, atol=mel_atol(scale))
    assert np.abs(want_mel).max() > 1.0
    return stacked, want_mel


def test_ds_pndm_as_shipped_matches_jax():
    hp = _hp("lj/ds_pndm.yaml", timesteps=30, K_step=30, pndm_speedup=5)
    assert (hp["gaussian_start"], hp["max_beta"], hp["pitch_type"], hp["use_pitch_embed"],
            hp["schedule_type"]) == (True, 0.02, "frame", False, "linear")
    jsyn, syn = _serve_pair(hp, with_pe=False)
    assert syn.task.gd.denoiser_calls() == 7 and not syn.vocoder.cfg.use_pitch_embed
    rng = np.random.RandomState(1)
    requests = [_request(rng, hp, 12), _request(rng, hp, 15)]
    _serve_and_compare(hp, jsyn, syn, requests, jax.random.PRNGKey(7),
                       mel_atol=lambda scale: 5e-5 * scale)


def test_ds100_adj_rel_as_shipped_matches_jax():
    hp = _hp("opencpop/ds100_adj_rel.yaml", timesteps=8, K_step=8)
    assert (hp["gaussian_start"], hp["max_beta"], hp["schedule_type"],
            hp["dilation_cycle_length"], hp["pe_enable"], hp["use_nsf"], hp["use_midi"],
            hp["rel_pos"], hp["use_pitch_embed"]) == \
        (True, 0.06, "linear", 4, True, True, True, True, False)
    assert "pndm_speedup" not in hp or not hp["pndm_speedup"]
    jsyn, syn = _serve_pair(hp, with_pe=True)
    assert syn.task.gd.denoiser_calls() == 8 and syn.hop == 128
    rng = np.random.RandomState(2)
    requests = [_request(rng, hp, 10), _request(rng, hp, 14)]
    _, mel = _serve_and_compare(hp, jsyn, syn, requests, jax.random.PRNGKey(11),
                                mel_atol=lambda scale: 1e-4)
    # the PE's F0 on one mel (the JAX sampler's): every real frame voiced
    jmod, pe_vars = jsyn.pe
    want_f0 = np.asarray(jmod.apply(pe_vars, jnp.asarray(mel), train=False)["f0_denorm_pred"])
    with torch.no_grad():
        got_f0 = syn.pe(torch.from_numpy(np.array(mel)))["f0_denorm_pred"].numpy()
    np.testing.assert_allclose(got_f0, want_f0, rtol=1e-5)
    real = np.abs(mel).sum(-1) > 0
    assert (want_f0[real] > 50).all() and (want_f0[~real] == 0).all()


@pytest.mark.parametrize("with_boost", [True, False])
def test_ds_beta6_offline_as_shipped_matches_jax(with_boost):
    """With ``fs2_mels`` in the batch the boost starts from them; without,
    from the FS2 decoder's mel (the training split carries none)."""
    hp = _hp("popcs/ds_beta6_offline.yaml", timesteps=8, K_step=4)
    assert (hp["offline_boost"], hp["gaussian_start"] if "gaussian_start" in hp else False,
            hp["use_gt_dur"], hp["use_gt_f0"], hp["use_nsf"], hp["pitch_type"]) == \
        (True, False, True, True, True, "frame")
    jtask, params, task = _tasks(hp)
    jvoc, voc = _vocoders(hp)
    rng = np.random.RandomState(3)
    b, t_txt, t_mel = 2, 16, 64
    tokens = rng.randint(3, VOCAB, size=(b, t_txt)).astype(np.int64)
    tokens[1, 12:] = 0
    mel2ph = np.repeat(np.arange(1, t_txt + 1), FRAMES_PER_PHONE)[None].repeat(b, 0)
    mel2ph[1, 48:] = 0
    f0 = rng.uniform(150, 400, size=(b, t_mel)).astype(np.float32)
    uv = (rng.rand(b, t_mel) < 0.2).astype(np.float32)
    f0[uv > 0] = 0.0
    batch = {"txt_tokens": tokens, "mel2ph": mel2ph, "f0": f0, "uv": uv,
             "mels": np.zeros((b, t_mel, MEL), np.float32)}
    if with_boost:
        batch["fs2_mels"] = rng.uniform(-5.0, 1.0, size=(b, t_mel, MEL)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(t_mel=t_mel, use_gt_dur=True, use_gt_f0=True)
    want = jtask.inference(params, batch, key, **kw)
    got = task.inference(batch, noise=torch.from_numpy(jax_sampler_draws(key, hp, b, t_mel)),
                         **kw)
    for k in ("fs2_mel", "mel_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, err_msg=k)
    if with_boost:
        np.testing.assert_array_equal(got["fs2_mel"].numpy(), batch["fs2_mels"])
    assert float(np.abs(np.asarray(want["mel_out"])).max()) > 1.0
    # the NSF vocoder on the batch's F0 and the JAX source draws
    lengths = [int((m > 0).sum()) for m in mel2ph]
    mels = np.asarray(want["mel_out"])
    vkey = jax.random.PRNGKey(5)
    want_wav = jvoc.spec2wav_batch(mels, lengths, f0s=f0, rng=vkey)
    got_wav = voc.spec2wav_batch(mels, lengths, f0s=f0,
                                 source=jax_source_draws(vkey, b, t_mel * 128))
    for g, w, n in zip(got_wav, want_wav, lengths):
        assert g.shape == w.shape == (n * 128,)
        np.testing.assert_allclose(g, np.asarray(w), atol=WAV_TOL)
