"""The port's Trainer beyond one step: checkpoints and resume, validation
against JAX ``Trainer.validate``, and ``fit``'s boundaries.

Resume: 2 steps, a save, a fresh task and Trainer restoring it, 2 more steps
give the same losses and parameters, bit for bit, as 4 steps in one go (the
AdamW moments and the trainer's generator, which draws the diffusion steps,
noise and dropout, are in the checkpoint). Validation: the JAX package's
weights through ``convert/from_jax.py`` and the diffusion draws JAX takes from
``PRNGKey(0)`` for every batch, passed in as ``tests/test_torch_train.py``
passes them; averages weighted by ``nsamples`` at rtol 1e-5, the loss-term
tolerance of that file."""

import jax
import numpy as np
import pytest
import torch

from diffsinger_tpu.data.dataset import FastSpeechDataset as JDataset
from diffsinger_tpu.parallel.mesh import make_mesh
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu.training.trainer import Trainer as JTrainer
from diffsinger_tpu_torch.convert.from_jax import task_state_dict
from diffsinger_tpu_torch.data.dataset import FastSpeechDataset
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer
from tests.helpers import make_synthetic_dataset, tiny_hparams

torch.set_num_threads(1)
VOCAB = 8  # 3 reserved ids and the helpers' 5 phones


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("fit") / "ds"), n_train=6,
                                  n_valid=3)


def _hp(data_dir, **kw):
    return tiny_hparams(data_dir, dropout=0.1, mel_loss="l1", **kw)


def _task(hp, seed=0):
    torch.manual_seed(seed)
    task = DiffSingerTask(hp, VOCAB, device="cpu", sil_ids=(7,))
    with torch.no_grad():
        task.denoise_fn.output_projection.weight.normal_(0.0, 0.05)
    return task


def _train_batches(hp):
    np.random.seed(0)
    return list(FastSpeechDataset(dict(hp), "train", shuffle=True).iter_batches(
        max_sentences=3))


def test_resume_is_bit_equal_to_an_uninterrupted_run(data_dir, tmp_path):
    hp = _hp(data_dir)
    batches = _train_batches(hp)
    assert len(batches) >= 2
    order = [batches[0], batches[1], batches[0], batches[1]]

    whole = Trainer(hp, _task(hp), device="cpu", work_dir=str(tmp_path / "a"))
    whole.initialize()
    want = [whole.train_step(b) for b in order]

    first = Trainer(hp, _task(hp), device="cpu", work_dir=str(tmp_path / "b"))
    first.initialize()
    got = [first.train_step(b) for b in order[:2]]
    first.save_checkpoint()
    resumed = Trainer(hp, _task(hp, seed=5), device="cpu", work_dir=str(tmp_path / "b"))
    resumed.initialize()
    assert resumed.global_step == 2 and resumed.optimizer.num_updates == 2
    got += [resumed.train_step(b) for b in order[2:]]
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert torch.equal(g[k], w[k]), (i, k)
    for k, v in whole.task.state_dict().items():
        assert torch.equal(resumed.task.state_dict()[k], v), k


def test_checkpoints_kept_and_best_valid(data_dir, tmp_path):
    hp = _hp(data_dir, num_ckpt_keep=2)
    trainer = Trainer(hp, _task(hp), device="cpu", work_dir=str(tmp_path))
    trainer.initialize()
    for step, val in zip(range(1, 6), (3.0, 2.0, 2.5, 1.0, 4.0)):
        trainer.global_step = step
        trainer.save_checkpoint(val)
    files = sorted(p.name for p in tmp_path.glob("model_ckpt_steps_*.ckpt"))
    assert files == ["model_ckpt_steps_4.ckpt", "model_ckpt_steps_5.ckpt"]
    assert np.load(tmp_path / "best_valid.npy").tolist() == [1.0]
    ckpt = torch.load(tmp_path / "model_ckpt_steps_5.ckpt", weights_only=False)
    assert set(ckpt) >= {"state_dict", "optimizer_states", "global_step", "generator_state"}
    assert set(ckpt["state_dict"]) == {"model"} and ckpt["best_val_loss"] == 1.0


def test_mismatched_checkpoint_raises(data_dir, tmp_path):
    hp = _hp(data_dir)
    Trainer(hp, _task(hp), device="cpu", work_dir=str(tmp_path)).save_checkpoint()
    wider = _hp(data_dir, residual_channels=16)
    with pytest.raises(RuntimeError, match="does not match.*shape mismatch=\\['denoise_fn"):
        Trainer(wider, _task(wider), device="cpu", work_dir=str(tmp_path)).initialize()
    raw = torch.load(tmp_path / "model_ckpt_steps_0.ckpt", weights_only=False)
    raw["state_dict"]["model"]["fs2.extra.weight"] = torch.zeros(2)
    del raw["state_dict"]["model"]["fs2.mel_out.bias"]
    torch.save(raw, tmp_path / "model_ckpt_steps_1.ckpt")
    with pytest.raises(RuntimeError, match=r"missing=\['fs2.mel_out.bias'\] "
                                           r"unexpected=\['fs2.extra.weight'\]"):
        Trainer(hp, _task(hp), device="cpu", work_dir=str(tmp_path)).initialize()


def _jax_draws(rng, batch, k_step):
    _, _, t_rng, noise_rng = jax.random.split(rng, 4)
    t = jax.random.randint(t_rng, (batch["mels"].shape[0],), 0, k_step)
    noise = jax.random.normal(noise_rng, batch["mels"].shape)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def test_validate_matches_jax(data_dir, tmp_path):
    hp = _hp(data_dir)
    jds = JDataset(dict(hp), "valid")
    jbatches = list(jds.iter_batches(max_sentences=2))
    assert [b["nsamples"] for b in jbatches] == [2, 1]  # weighting matters
    jtask = JTask(hp, VOCAB, sil_ids=(7,))
    params = jtask.init_params(jax.random.PRNGKey(0), {
        k: v for k, v in jbatches[0].items() if isinstance(v, np.ndarray)})
    jtrainer = JTrainer(hp, jtask, mesh=make_mesh(num_data=1, devices=jax.devices()[:1]),
                        work_dir=str(tmp_path))
    jtrainer.params = params
    want = jtrainer.validate(iter(jbatches))

    task = DiffSingerTask(hp, VOCAB, device="cpu", sil_ids=(7,))
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    trainer = Trainer(hp, task, device="cpu")
    batches = list(FastSpeechDataset(dict(hp), "valid").iter_batches(max_sentences=2))
    got = trainer.validate(batches, draws=lambda i, b: _jax_draws(
        jax.random.PRNGKey(0), b, hp["K_step"]))
    assert got.keys() == want.keys() and "total_loss" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # without draws: dropout off and a generator seeded 0 for every batch
    a, b = trainer.validate(batches), trainer.validate(batches)
    assert a == b and a.keys() == want.keys()
    assert trainer.validate(batches, max_batches=1) != a


def test_fit_boundaries(data_dir, tmp_path, monkeypatch):
    """Sanity validation at step 0, validation and a checkpoint at every
    val_check_interval crossing, log lines at log_interval, a final
    checkpoint; epochs reshuffle by seed."""
    hp = _hp(data_dir, max_updates=5, val_check_interval=2, log_interval=2,
             num_sanity_val_steps=1, max_sentences=3)
    calls = []
    validate, save = Trainer.validate, Trainer.save_checkpoint

    def rec_validate(self, batches, max_batches=None, plotter=None, draws=None):
        out = validate(self, batches, max_batches=max_batches, plotter=plotter)
        calls.append(("validate", self.global_step, max_batches))
        return out

    def rec_save(self, val_loss=None):
        calls.append(("save", self.global_step, val_loss is not None))
        return save(self, val_loss)

    monkeypatch.setattr(Trainer, "validate", rec_validate)
    monkeypatch.setattr(Trainer, "save_checkpoint", rec_save)
    trainer = Trainer(hp, _task(hp), device="cpu", work_dir=str(tmp_path))
    seeds = []
    train_ds = FastSpeechDataset(dict(hp), "train", shuffle=True)
    iter_batches = train_ds.iter_batches
    monkeypatch.setattr(train_ds, "iter_batches",
                        lambda **kw: seeds.append(kw.get("seed")) or iter_batches(**kw))
    trainer.fit(train_ds, FastSpeechDataset(dict(hp), "valid"))
    assert calls == [("validate", 0, 1), ("validate", 2, None), ("save", 2, True),
                     ("validate", 4, None), ("save", 4, True), ("save", 5, False)]
    assert trainer.global_step == 5 and seeds == list(range(len(seeds))) and len(seeds) >= 2
    assert [(s, k) for s, k, _ in trainer.history] == [(2, "train"), (2, "val"),
                                                       (4, "train"), (4, "val")]
    assert hp["num_ckpt_keep"] == 2
    assert sorted(p.name for p in tmp_path.glob("model_ckpt_steps_*.ckpt")) == [
        "model_ckpt_steps_4.ckpt", "model_ckpt_steps_5.ckpt"]
    assert (tmp_path / "codes").is_dir()
