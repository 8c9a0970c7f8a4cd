"""Places where the port once differed from the JAX package, each held to the
JAX behaviour:

  * hparams without ``pitch_type`` or ``use_pitch_embed``: JAX builds a
    phone-level pitch predictor (``pitch_type`` defaults to ``ph``) and, with
    ``use_pitch_embed`` absent, trains no pitch loss;
  * ``offline_boost``: the shallow boost starts from the batch's
    ``fs2_mels`` and the FS2 decoder is skipped;
  * ``vocoder_ckpt`` naming an existing checkpoint: the port once raised; it
    now loads it, and gives JAX's waveform on the same weights;
  * ``spec2wav_batch`` with an NSF vocoder: the port once took no F0, so the
    batch was vocoded without its source; it now takes ``f0s`` and gives
    JAX's waveform on the same weights and source draws;
  * ``task_cls``: the port's CLI once built a diffusion task whatever the
    config named, so ``configs/lj/fs2.yaml`` trained a DiffNet and
    ``configs/opencpop/pe.yaml`` a diffusion model; it now builds the task
    JAX's ``build_task`` builds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.models import fs2 as jfs2
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu.inference.vocoder import HifiGAN as JHifiGAN
from diffsinger_tpu_torch.convert.from_jax import hifigan_state_dict, task_state_dict
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
from diffsinger_tpu_torch.tools.fixtures import write_hifigan_dir
from diffsinger_tpu_torch.models import fs2 as tfs2
from diffsinger_tpu_torch.training.tasks import DiffSingerTask

torch.set_num_threads(1)
VOCAB = 16


def _hp_without_pitch_keys():
    hp = g._tiny_hp()
    del hp["pitch_type"], hp["use_pitch_embed"]
    return hp


def _batch():
    rng = np.random.RandomState(3)
    batch = g._synthetic_batch(rng, b=2, t_txt=16, t_mel=64)
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def test_minimal_hparams_take_jax_defaults():
    """{"hidden_size": 32}: both build a ph-pitch FS2 whose predictor has one
    output."""
    hp = {"hidden_size": 32}
    jcfg, tcfg = jfs2.FS2Config.from_hparams(hp, VOCAB), tfs2.FS2Config.from_hparams(hp, VOCAB)
    assert jcfg.pitch_type == tcfg.pitch_type == "ph"
    tokens = np.ones((1, 6), np.int64)
    params = jfs2.FastSpeech2(jcfg).init(jax.random.PRNGKey(0), tokens,
                                         mel2ph=np.ones((1, 12), np.int64))["params"]
    jax_odim = params["pitch_predictor"]["linear"]["kernel"].shape[1]
    assert tfs2.FastSpeech2(tcfg).pitch_predictor.linear.out_features == jax_odim == 1


def test_absent_use_pitch_embed_trains_no_pitch_loss():
    """Without pitch_type and use_pitch_embed: the same loss terms as JAX's
    task, none of them a pitch term."""
    hp, batch = _hp_without_pitch_keys(), _batch()
    jtask = JTask(hp, VOCAB)
    params = jtask.init_params(jax.random.PRNGKey(0), batch)
    _, j_losses = jtask.train_loss(params, batch, jax.random.PRNGKey(1), deterministic=True)
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    _, losses = task.train_loss(batch, t=torch.tensor([1, 2]),
                                noise=torch.zeros(batch["mels"].shape), deterministic=True)
    assert set(losses) == set(j_losses) == {"mel", "pdur", "wdur", "sdur"}


def test_offline_boost_starts_from_the_batch_mel():
    hp = {**g._tiny_hp(), "offline_boost": True, "K_step": 3}
    batch = _batch()
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    fs2_mels = np.random.RandomState(0).uniform(-5, 1, size=(2, 64, 80)).astype(np.float32)
    noise = torch.randn((4, 2, 64, 80), generator=torch.Generator().manual_seed(0))
    out = task.inference({**batch, "fs2_mels": fs2_mels}, noise=noise)
    np.testing.assert_array_equal(out["fs2_mel"].numpy(), fs2_mels)
    # with no fs2_mels in the batch the FS2 decoder gives the boost mel
    own = task.inference(batch, noise=noise)
    np.testing.assert_array_equal(own["fs2_mel"].numpy(),
                                  task.fs2(torch.from_numpy(batch["txt_tokens"]),
                                           mel2ph=torch.from_numpy(batch["mel2ph"]))
                                  ["mel_out"].detach().numpy())
    assert (own["mel_out"] - out["mel_out"]).abs().max() > 1e-3


VOC_GEOM = {"resblock": "1", "upsample_rates": [4, 2, 2], "upsample_kernel_sizes": [8, 4, 4],
            "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
            "audio_sample_rate": 24000, "audio_num_mel_bins": 16, "hop_size": 16}


def _jax_vocoder(hp, key=0):
    """The JAX wrapper with seeded random weights (its module backend, whose
    key draws the NSF source as ``jax_source_draws`` does)."""
    jvoc = JHifiGAN({**hp, "vocoder_backend": "module"})
    rng = np.random.RandomState(key)
    mel = np.zeros((1, 8, 16), np.float32)
    args = (mel, np.full((1, 8), 200.0, np.float32), jax.random.PRNGKey(1)) \
        if jvoc.cfg.use_pitch_embed else (mel,)
    params = jvoc.model.init(jax.random.PRNGKey(0), *args)["params"]
    jvoc.params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05), params)
    return jvoc


def jax_source_draws(rng, b, t_wav):
    rng_phase, rng_noise = jax.random.split(rng)
    rand_ini = jax.random.uniform(rng_phase, (b, 1, 9)).at[:, :, 0].set(0.0)
    return np.asarray(rand_ini), np.asarray(jax.random.normal(rng_noise, (b, t_wav, 9)))


def test_existing_vocoder_checkpoint_raises(tmp_path):
    """An existing vocoder checkpoint is loaded, not ignored: a HiFiGAN
    directory (config.yaml, weight-norm pairs under model_gen) gives JAX's
    waveform on the same weights; a file that is no checkpoint raises; an
    absent path or an empty directory leaves the Griffin-Lim fallback."""
    hp = {**VOC_GEOM, "vocoder": "hifigan", "use_nsf": False, "use_pitch_embed": False}
    jvoc = _jax_vocoder(hp)
    write_hifigan_dir(str(tmp_path / "voc"), hifigan_state_dict(jvoc.params), hp)
    want_voc = JHifiGAN({**hp, "vocoder_ckpt": str(tmp_path / "voc")})
    got_voc = HifiGAN({**hp, "vocoder_ckpt": str(tmp_path / "voc")}, device="cpu")
    mel = (np.random.RandomState(1).randn(20, 16) * 0.5 - 3).astype(np.float32)
    want = want_voc.spec2wav(mel)
    got = got_voc.spec2wav(mel)
    assert got_voc.has_weights and got.shape == want.shape == (20 * 16,)
    np.testing.assert_allclose(got, want, atol=5e-5)
    bad = tmp_path / "bad" / "model_ckpt_steps_1000.ckpt"
    bad.parent.mkdir()
    bad.write_bytes(b"not loaded")
    with pytest.raises(Exception):
        HifiGAN({**hp, "vocoder_ckpt": str(bad.parent)}, device="cpu")
    (tmp_path / "empty").mkdir()
    for path in (str(tmp_path / "missing"), str(tmp_path / "empty"), ""):
        voc = HifiGAN({**hp, "vocoder_ckpt": path}, device="cpu")
        assert not voc.has_weights and voc.model is not None


def test_nsf_spec2wav_batch_takes_f0():
    """An NSF vocoder vocodes a batch from its F0: the same waveforms as JAX's
    ``spec2wav_batch`` with ``f0s`` on the same weights and source draws, and
    not the waveforms without a source."""
    hp = {**VOC_GEOM, "vocoder": "hifigan", "use_nsf": True}
    jvoc = _jax_vocoder(hp, key=2)
    voc = HifiGAN(hp, device="cpu")
    voc.load_state_dict(hifigan_state_dict(jvoc.params), strict=True)
    rng = np.random.RandomState(3)
    mels = (rng.randn(2, 24, 16) * 0.5 - 3).astype(np.float32)
    f0s = rng.uniform(150, 500, size=(2, 24)).astype(np.float32)
    f0s[0, 5:9] = 0.0
    lengths = [24, 19]
    key = jax.random.PRNGKey(7)
    want = jvoc.spec2wav_batch(mels, lengths, f0s=f0s, rng=key)
    got = voc.spec2wav_batch(mels, lengths, f0s=f0s, source=jax_source_draws(key, 2, 24 * 16))
    no_source = voc.spec2wav_batch(mels, lengths)
    for g, w, n, length in zip(got, want, no_source, lengths):
        assert g.shape == w.shape == (length * 16,)
        np.testing.assert_allclose(g, w, atol=5e-5)
        assert np.abs(g - n).max() > 1e-3


@pytest.mark.parametrize("config,want", [("configs/lj/fs2.yaml", "FastSpeech2Task"),
                                         ("configs/opencpop/aux_rel.yaml", "FastSpeech2Task"),
                                         ("configs/popcs/fs2.yaml", "FastSpeech2Task"),
                                         ("configs/opencpop/pe.yaml", "PitchExtractionTask"),
                                         ("configs/opencpop/ds1000.yaml", "DiffSingerTask")])
def test_cli_builds_the_task_that_task_cls_names(tmp_path, config, want):
    """``cli._build`` reads ``task_cls`` as JAX's ``cli._build`` does: an FS2
    config trains a FastSpeech2 with its mel decoder and no denoiser, the PE
    config a PitchExtractor; an unknown name raises ``KeyError``."""
    import json
    from pathlib import Path

    from diffsinger_tpu import cli as jcli
    from diffsinger_tpu.config.hparams import set_hparams as jset_hparams
    from diffsinger_tpu_torch import cli
    from diffsinger_tpu_torch.config.hparams import set_hparams

    root = Path(__file__).resolve().parents[1]
    (tmp_path / "phone_set.json").write_text(json.dumps(["a", "b", "c", "SP", "AP"]))
    over = {"binary_data_dir": str(tmp_path)}
    hp = {**set_hparams(str(root / config)), **over}
    _, task = cli._build(hp, "cpu")
    assert type(task).__name__ == want
    assert type(jcli._build({**jset_hparams(str(root / config)), **over})[1]).__name__ == want
    if want == "FastSpeech2Task":
        assert getattr(task, "denoise_fn", None) is None and task.fs2.mel_out is not None
    with pytest.raises(KeyError, match="unknown task_cls"):
        cli._build({**hp, "task_cls": "usr.nope.Task"}, "cpu")
