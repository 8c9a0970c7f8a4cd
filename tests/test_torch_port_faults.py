"""Three places where the port once differed from the JAX package without a
word, each held to the JAX behaviour:

  * hparams without ``pitch_type`` or ``use_pitch_embed``: JAX builds a
    phone-level pitch predictor (``pitch_type`` defaults to ``ph``) and, with
    ``use_pitch_embed`` absent, trains no pitch loss;
  * ``offline_boost``: the shallow boost starts from the batch's
    ``fs2_mels`` and the FS2 decoder is skipped;
  * ``vocoder_ckpt`` naming an existing checkpoint: the port cannot load it
    yet, so it raises instead of serving seeded weights.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.models import fs2 as jfs2
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.inference.vocoder import HifiGAN
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


def test_existing_vocoder_checkpoint_raises(tmp_path):
    hp = {"vocoder": "hifigan", "audio_num_mel_bins": 80}
    ckpt = tmp_path / "model_ckpt_steps_1000.ckpt"
    ckpt.write_bytes(b"not loaded")
    with pytest.raises(NotImplementedError, match="vocoder_ckpt"):
        HifiGAN({**hp, "vocoder_ckpt": str(ckpt)}, device="cpu")
    with pytest.raises(NotImplementedError, match="vocoder_ckpt"):
        HifiGAN({**hp, "vocoder_ckpt": str(tmp_path)}, device="cpu")  # non-empty directory
    # an absent path, or an empty directory, still builds seeded weights
    (tmp_path / "empty").mkdir()
    for path in (str(tmp_path / "missing"), str(tmp_path / "empty"), ""):
        assert HifiGAN({**hp, "vocoder_ckpt": path}, device="cpu").model is not None
