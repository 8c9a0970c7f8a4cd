"""Checkpoints in the upstream torch layout, read by the port and by the JAX
package on the same weights:

  * ``find_latest_ckpt`` and ``load_torch_state_dict`` (the ``state_dict`` /
    ``model`` nestings, nested dicts, the ``model.`` prefix and the
    unprefixed fallback) against the JAX loader, key for key;
  * non-strict merging prints the keys it skips for their shape;
  * a DiffSpeech checkpoint the port's Trainer writes restores into the port
    and into JAX ``Trainer._restore_torch``: the same ``task.inference`` mel
    on shared noise (drawn with jax.random as JAX's sampler splits its key),
    within 1e-4 as ``tests/test_torch_serve.py`` holds its output;
  * a checkpoint that gives the task no parameter is refused, the step kept;
  * HiFiGAN directories (``config.yaml`` with weight-norm pairs, and the
    official ``config.json`` + ``generator_v1``) through both ``HifiGAN(hp)``:
    the same waveform within 5e-5 (``tests/test_torch_hifigan.py``);
  * a PE checkpoint with BatchNorm statistics through both ``_maybe_load_pe``:
    the same voicing and F0 within rtol 1e-4;
  * the ``fs2_ckpt`` warm start equal to JAX ``load_warm_start_params``;
  * Griffin-Lim equal to JAX's;
  * an FS2 run's checkpoint (the FS2 under ``model.``) warm-starts a
    diffusion task with every FS2 tensor and reads in JAX's ``convert_fs2``;
    a PE run's (PE keys and statistics) reads back through ``load_pe`` and
    JAX's ``convert_pe``; both resume bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from diffsinger_tpu.convert import checkpoint as jck
from diffsinger_tpu.inference import synthesize as jsyn
from diffsinger_tpu.inference.vocoder import GriffinLim as JGriffinLim
from diffsinger_tpu.inference.vocoder import HifiGAN as JHifiGAN
from diffsinger_tpu.models import pe as jpe
from diffsinger_tpu.parallel.mesh import make_mesh
from diffsinger_tpu.training.tasks import DiffSingerTask as JTask
from diffsinger_tpu.training.trainer import Trainer as JTrainer
from diffsinger_tpu_torch.convert import checkpoint as tck
from diffsinger_tpu_torch.convert.from_jax import (fs2_state_dict, hifigan_state_dict,
                                                   pe_state_dict, task_state_dict)
from diffsinger_tpu_torch.inference import synthesize as tsyn
from diffsinger_tpu_torch.inference.vocoder import GriffinLim, HifiGAN
from diffsinger_tpu_torch.tools.fixtures import (weight_norm_split, write_hifigan_dir,
                                                 write_task_ckpt)
from diffsinger_tpu_torch.training.tasks import DiffSingerTask
from diffsinger_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)
VOCAB, K = 16, 4


def _hp(**kw):
    return {**g._tiny_hp(), "timesteps": 8, "K_step": K, **kw}


def _batch(seed=3, b=2):
    batch = g._synthetic_batch(np.random.RandomState(seed), b=b, t_txt=16, t_mel=64)
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def _jax_params(hp, batch, key=0):
    params = JTask(hp, VOCAB).init_params(jax.random.PRNGKey(key), batch)
    r = np.random.RandomState(key + 7)
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {  # zero at init
        "kernel": jnp.asarray(r.randn(1, 32, 80).astype(np.float32) * 0.1),
        "bias": jnp.zeros((80,), jnp.float32)}
    return params


def jax_sampler_noise(rng, k, shape):
    rng, init_rng = jax.random.split(rng)
    draws = [jax.random.normal(init_rng, shape)]
    draws += [jax.random.normal(r, shape) for r in jax.random.split(rng, k)]
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


# ------------------------------------------------------------------ loaders
def test_find_latest_ckpt_matches_jax(tmp_path):
    for step in (5, 100, 20):
        (tmp_path / f"model_ckpt_steps_{step}.ckpt").write_bytes(b"")
    (tmp_path / "empty").mkdir()
    for path in (str(tmp_path), str(tmp_path / "model_ckpt_steps_5.ckpt"),
                 str(tmp_path / "empty"), str(tmp_path / "missing")):
        assert tck.find_latest_ckpt(path) == jck.find_latest_ckpt(path), path
    assert tck.find_latest_ckpt(str(tmp_path)).endswith("steps_100.ckpt")


@pytest.mark.parametrize("layout", ["flat_model_prefix", "nested_model", "nested_dicts",
                                    "unprefixed"])
def test_load_torch_state_dict_matches_jax(tmp_path, layout):
    rng = np.random.RandomState(0)
    sd = {"fs2.a.weight": torch.from_numpy(rng.randn(3, 2).astype(np.float32)),
          "denoise_fn.b": torch.from_numpy(rng.randn(4).astype(np.float32))}
    raw = {"flat_model_prefix": {"state_dict": {f"model.{k}": v for k, v in sd.items()},
                                 "global_step": 3},
           "nested_model": {"state_dict": {"model": dict(sd)}},
           "nested_dicts": {"model": {"generator": {"conv.weight": sd["fs2.a.weight"]}},
                            "steps": 9},
           "unprefixed": dict(sd)}[layout]
    path = tmp_path / "model_ckpt_steps_3.ckpt"
    torch.save(raw, path)
    for ckpt in (str(path), raw):
        for prefix in ("model.", ""):
            got = tck.load_torch_state_dict(ckpt, prefix=prefix)
            want = jck.load_torch_state_dict(ckpt, prefix=prefix)
            assert got.keys() == want.keys() and got, (layout, prefix)
            for k in got:
                np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_merge_prunes_shape_mismatches_with_a_printed_skip(capsys):
    task = DiffSingerTask(_hp(), VOCAB, device="cpu")
    sd = {k: torch.full_like(v, 0.5) for k, v in task.state_dict().items()}
    sd["fs2.encoder.embed_tokens.weight"] = torch.zeros(VOCAB + 4, 64)
    before = task.fs2.encoder.embed_tokens.weight.clone()
    n = tck.merge_state_dict(task, sd)
    assert n == len(sd) - 1
    assert "skip loading fs2.encoder.embed_tokens.weight" in capsys.readouterr().out
    assert torch.equal(task.fs2.encoder.embed_tokens.weight, before)
    assert float(task.denoise_fn.input_projection.weight[0, 0, 0]) == 0.5
    # the fold: weight = g * v / ||v|| over all dims but 0
    w = torch.randn(6, 3, 5)
    folded = tck.fold_weight_norm(weight_norm_split({"c.weight": w}, skip=()))
    torch.testing.assert_close(folded["c.weight"], w, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ DiffSpeech
def test_port_checkpoint_restores_in_port_and_jax(tmp_path):
    hp, batch = _hp(), _batch()
    params = _jax_params(hp, batch)
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    trainer = Trainer(hp, task, device="cpu", work_dir=str(tmp_path / "run"))
    trainer.initialize()  # the work_dir is empty: nothing to restore
    trainer.global_step = 7
    path = trainer.save_checkpoint()
    assert path.endswith("model_ckpt_steps_7.ckpt")

    task2 = DiffSingerTask(hp, VOCAB, device="cpu")  # another init: all overwritten
    restored = Trainer(hp, task2, device="cpu", work_dir=str(tmp_path / "run"))
    restored.initialize()
    assert restored.global_step == 7
    for k, v in task.state_dict().items():
        assert torch.equal(task2.state_dict()[k], v), k

    jtask = JTask(hp, VOCAB)
    jtrainer = JTrainer(hp, jtask, mesh=make_mesh(num_data=1, devices=jax.devices()[:1]),
                        work_dir=str(tmp_path / "run"))
    jtrainer.initialize(batch)
    assert jtrainer.global_step == 7
    key = jax.random.PRNGKey(3)
    want = jtask.inference(jtrainer.params, batch, key, use_gt_dur=True, use_gt_f0=True)
    noise = jax_sampler_noise(key, K, batch["mels"].shape)
    got = task2.inference(batch, use_gt_dur=True, use_gt_f0=True, noise=noise)
    want_mel = np.asarray(want["mel_out"])
    np.testing.assert_allclose(got["mel_out"].numpy(), want_mel, rtol=0, atol=1e-4)
    assert np.abs(want_mel).max() > 1.0


def test_released_checkpoint_restores_params_and_step_with_fresh_moments(tmp_path, capsys):
    """A checkpoint with no optimizer state (upstream's flat ``model.`` keys)
    gives params and step; the moments start fresh."""
    hp, batch = _hp(), _batch()
    params = _jax_params(hp, batch, key=1)
    write_task_ckpt(str(tmp_path), task_state_dict(jax.device_get(params)), step=150)
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    trainer = Trainer(hp, task, device="cpu", work_dir=str(tmp_path))
    trainer.initialize()
    assert trainer.global_step == 150 and trainer.optimizer.num_updates == 0
    assert not trainer.optimizer.adamw.state
    assert "optimizer moments re-initialized" in capsys.readouterr().out
    for k, v in task_state_dict(jax.device_get(params)).items():
        assert torch.equal(task.state_dict()[k], v), k


def test_checkpoint_without_task_parameters_is_refused(tmp_path, capsys):
    """A vocoder checkpoint in the task's work_dir: no key maps, nothing
    loads and global_step stays, as JAX refuses it."""
    voc = HifiGAN({"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4],
                   "upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
                   "resblock_dilation_sizes": [[1, 3]], "audio_num_mel_bins": 80},
                  device="cpu")
    write_task_ckpt(str(tmp_path), voc.model.state_dict(), step=900, prefix="")
    task = DiffSingerTask(_hp(), VOCAB, device="cpu")
    before = {k: v.clone() for k, v in task.state_dict().items()}
    trainer = Trainer(_hp(), task, device="cpu", work_dir=str(tmp_path))
    trainer.initialize()
    assert trainer.global_step == 0
    assert "contributed no parameters" in capsys.readouterr().out
    assert all(torch.equal(v, before[k]) for k, v in task.state_dict().items())
    jtrainer = JTrainer(_hp(), JTask(_hp(), VOCAB),
                        mesh=make_mesh(num_data=1, devices=jax.devices()[:1]),
                        work_dir=str(tmp_path))
    jtrainer.initialize(_batch())
    assert jtrainer.global_step == 0


# ------------------------------------------------------------------ vocoder
GEOM = {"resblock": "1", "upsample_rates": [4, 2, 2], "upsample_kernel_sizes": [8, 4, 4],
        "upsample_initial_channel": 32, "resblock_kernel_sizes": [3, 7, 11],
        "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
        "audio_sample_rate": 22050, "audio_num_mel_bins": 16, "hop_size": 16,
        "use_pitch_embed": False}


@pytest.mark.parametrize("layout", ["config_yaml", "config_json_generator_v1"])
def test_hifigan_directories_load_as_in_jax(tmp_path, layout):
    jvoc = JHifiGAN(GEOM)
    params = jvoc.model.init(jax.random.PRNGKey(0), np.zeros((1, 8, 16), np.float32))["params"]
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32) * 0.05), params)
    sd = hifigan_state_dict(params)
    d = tmp_path / "voc"
    if layout == "config_yaml":
        write_hifigan_dir(str(d), sd, GEOM)
    else:
        d.mkdir()
        cfg = {k: v for k, v in GEOM.items() if k != "audio_sample_rate"}
        (d / "config.json").write_text(json.dumps({**cfg, "sampling_rate": 22050,
                                                   "num_mels": 16}))
        torch.save({"generator": weight_norm_split(sd)}, d / "generator_v1")
    hp = {"vocoder": "hifigan", "vocoder_ckpt": str(d), "audio_sample_rate": 22050,
          "audio_num_mel_bins": 16, "hop_size": 16, "vocoder_pad_multiple": 8}
    want_voc, got_voc = JHifiGAN(hp), HifiGAN(hp, device="cpu")
    assert got_voc.has_weights and got_voc.cfg.upsample_rates == (4, 2, 2)
    mel = (np.random.RandomState(5).randn(21, 16) * 0.5 - 3).astype(np.float32)
    got, want = got_voc.spec2wav(mel), want_voc.spec2wav(mel)
    assert got.shape == want.shape == (21 * 16,)  # padded to 24 frames, cut back
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_griffin_lim_matches_jax():
    hp = {"audio_sample_rate": 22050, "fft_size": 1024, "hop_size": 256, "win_size": 1024,
          "audio_num_mel_bins": 80, "fmin": 80, "fmax": 7600}
    mel = (np.random.RandomState(6).randn(40, 80) * 0.5 - 3).astype(np.float32)
    np.testing.assert_array_equal(GriffinLim(hp, n_iter=4).spec2wav(mel),
                                  JGriffinLim(hp, n_iter=4).spec2wav(mel))
    # the HifiGAN wrapper without weights vocodes by Griffin-Lim
    voc = HifiGAN({**hp, "vocoder_ckpt": ""}, device="cpu")
    np.testing.assert_array_equal(voc.spec2wav(mel[:12]), GriffinLim(hp).spec2wav(mel[:12]))


# ------------------------------------------------------------------ PE
PE_HP = {"hidden_size": 32, "predictor_hidden": -1, "predictor_kernel": 5,
         "audio_num_mel_bins": 16, "pitch_type": "frame", "use_uv": True,
         "pitch_norm": "log", "pe_enable": True, "vocoder_pad_multiple": 16}


def test_pe_checkpoint_loads_as_in_jax(tmp_path):
    rng = np.random.RandomState(2)
    mel = (rng.randn(37, 16) * 0.5 - 2.0).astype(np.float32)
    jm = jpe.PitchExtractor(jpe.PEConfig.from_hparams(PE_HP))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel[None]))
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 2.0, a.shape).astype(np.float32)),
        variables["batch_stats"])
    stats = {name: {"mean": bn["mean"] - 1.2, "var": bn["var"]}
             for name, bn in stats["mel_prenet"].items()}
    variables = {"params": variables["params"], "batch_stats": {"mel_prenet": stats}}
    write_task_ckpt(str(tmp_path), pe_state_dict(variables), step=60000)
    hp = {**PE_HP, "pe_ckpt": str(tmp_path)}
    want = jsyn._maybe_load_pe(hp).predict(mel)
    pe = tsyn._maybe_load_pe(hp, device="cpu")
    got = pe.predict(mel)
    assert got.shape == want.shape == (37,)
    np.testing.assert_array_equal(got == 0, np.asarray(want) == 0)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4)
    assert float(pe.module.mel_prenet.layers[0][2].running_mean.abs().max()) > 0.1
    assert tsyn._maybe_load_pe({**hp, "pe_ckpt": str(tmp_path / "none")}, "cpu") is None
    assert tsyn._maybe_load_pe({**hp, "pe_enable": False}, "cpu") is None


# ------------------------------------------------------------------ warm start
def test_fs2_warm_start_matches_jax(tmp_path, capsys):
    hp, batch = _hp(), _batch()
    ckpt_params = _jax_params(hp, batch, key=2)
    sd = fs2_state_dict(jax.device_get(ckpt_params["fs2"]))
    sd["encoder.embed_tokens.weight"] = torch.zeros(VOCAB + 2, 64)  # pruned by shape
    write_task_ckpt(str(tmp_path / "fs2"), sd, step=150000)
    hp = _hp(fs2_ckpt=str(tmp_path / "fs2"))
    params = _jax_params(hp, batch, key=0)
    want = jck.load_warm_start_params(hp, params)
    task = DiffSingerTask(hp, VOCAB, device="cpu")
    task.load_state_dict(task_state_dict(jax.device_get(params)), strict=True)
    assert tck.load_warm_start(hp, task)
    out = capsys.readouterr().out
    assert out.count("skip loading") == 2  # the port and JAX each skip the embedding
    for k, v in task_state_dict(jax.device_get(want)).items():
        assert torch.equal(task.state_dict()[k], v), k
    assert not torch.equal(task.fs2.encoder.embed_tokens.weight.flatten()[:4],
                           torch.zeros(4))
    missing = _hp(fs2_ckpt=str(tmp_path / "absent"))
    assert not tck.load_warm_start(missing, task)
    assert "training from scratch" in capsys.readouterr().out


# ------------------------------------------------------------------ SVS
def test_svs_builds_its_parts_from_the_run_files(tmp_path):
    """Given no objects, BaseSVSInfer takes the task from work_dir's newest
    checkpoint, the vocoder from vocoder_ckpt and the PE from pe_ckpt."""
    from diffsinger_tpu_torch.inference import svs as tsvs
    from diffsinger_tpu_torch.models.pe import PEConfig, PitchExtractor
    from tests.test_torch_singing_serve import HP, VOC_HP

    hp = dict(HP, residual_layers=2, fs2_ckpt="", lr=0.001, decay_steps=50000)
    vocab = len(tsvs.CPOP_PHONE_LIST) + 3
    torch.manual_seed(0)
    task = DiffSingerTask(hp, vocab, device="cpu")
    run = Trainer(hp, task, device="cpu", work_dir=str(tmp_path / "run"))
    run.initialize()  # the work_dir is empty: nothing to restore
    run.global_step = 3
    run.save_checkpoint()
    voc_geom = {k: v for k, v in VOC_HP.items() if k not in ("vocoder", "vocoder_ckpt")}
    voc_model = HifiGAN(voc_geom, device="cpu").model
    write_hifigan_dir(str(tmp_path / "voc"), voc_model.state_dict(), voc_geom)
    pe = PitchExtractor(PEConfig.from_hparams(hp))
    with torch.no_grad():
        pe.mel_prenet.layers[0][2].running_mean.fill_(0.3)
    write_task_ckpt(str(tmp_path / "pe"), pe.state_dict(), step=10)
    infer = tsvs.DiffSingerE2EInfer(
        dict(hp, **{k: v for k, v in VOC_HP.items() if k != "vocoder_ckpt"},
             work_dir=str(tmp_path / "run"), vocoder_ckpt=str(tmp_path / "voc"),
             pe_ckpt=str(tmp_path / "pe"), pe_enable=True), device="cpu")
    fused = infer.fused
    for k, v in task.state_dict().items():
        assert torch.equal(fused.task.state_dict()[k], v), k
    assert fused.vocoder.has_weights and fused.vocoder.cfg.use_pitch_embed
    for k, v in voc_model.state_dict().items():
        torch.testing.assert_close(fused.vocoder.model.state_dict()[k], v, rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(fused.pe.mel_prenet.layers[0][2].running_mean,
                       torch.full((32,), 0.3))


# ------------------------------------------------------------------ FS2 and PE runs
def _fs2_task_and_trainer(hp, work_dir):
    from diffsinger_tpu_torch.training.tasks import FastSpeech2Task

    torch.manual_seed(0)
    task = FastSpeech2Task(hp, VOCAB, device="cpu", sil_ids=(3,))
    return task, Trainer(hp, task, device="cpu", work_dir=work_dir)


def test_fs2_run_checkpoint_warm_starts_diffusion_and_reads_in_jax(tmp_path, capsys):
    """An FS2 run saves its FS2 under ``model.`` as upstream's FastSpeech2Task:
    the diffusion task's ``fs2_ckpt`` warm start takes every FS2 tensor,
    JAX's ``convert_fs2`` reads the same file, and a fresh trainer resumes
    it bit for bit (params and AdamW moments)."""
    hp = {**_hp(), "task_cls": "fs2", "mel_loss": "ssim:0.5|l1:0.5"}
    task, trainer = _fs2_task_and_trainer(hp, str(tmp_path / "fs2"))
    trainer.initialize()
    trainer.train_step(_batch())
    path = trainer.save_checkpoint()
    saved = tck.load_torch_state_dict(path)
    assert set(saved) == set(task.fs2.state_dict())  # FS2 keys, no "fs2." prefix

    diff = DiffSingerTask(_hp(fs2_ckpt=str(tmp_path / "fs2")), VOCAB, device="cpu")
    assert tck.load_warm_start(diff.hp, diff)
    n = int(capsys.readouterr().out.split("(")[-1].split(" tensors")[0])
    assert n == len(task.fs2.state_dict())
    for k, v in task.fs2.state_dict().items():
        assert torch.equal(diff.fs2.state_dict()[k], v), k

    jtree = jck.convert_fs2(jck.load_torch_state_dict(path))
    back = fs2_state_dict(jtree)
    params = dict(task.fs2.named_parameters())
    assert set(back) == set(params)
    for k, v in back.items():
        assert torch.equal(v, params[k].detach()), k

    fresh, resumed = _fs2_task_and_trainer(hp, str(tmp_path / "fs2"))
    torch.manual_seed(1)
    resumed.initialize()
    assert resumed.global_step == 1
    for (k, v), (_, w) in zip(task.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(v, w), k
    a, b = trainer.optimizer.adamw.state_dict()["state"], \
        resumed.optimizer.adamw.state_dict()["state"]
    assert a.keys() == b.keys() and all(
        torch.equal(a[i][m], b[i][m]) for i in a for m in ("exp_avg", "exp_avg_sq"))


def test_pe_run_checkpoint_round_trips_through_load_pe(tmp_path):
    """A PE run saves its PE keys and BatchNorm statistics under ``model.``:
    ``synthesize.load_pe`` and JAX's ``convert_pe`` read them back, and a
    fresh trainer resumes the run bit for bit."""
    from diffsinger_tpu_torch.training.tasks import PitchExtractionTask

    hp = {**PE_HP, "task_cls": "pe", "lr": 1e-3, "decay_steps": 100, "seed": 3}
    rng = np.random.RandomState(4)
    batch = {"mels": (rng.randn(2, 24, 16) * 0.5 - 2).astype(np.float32),
             "mel2ph": np.ones((2, 24), np.int64),
             "f0": rng.uniform(6.5, 8.5, size=(2, 24)).astype(np.float32),
             "uv": (rng.rand(2, 24) < 0.2).astype(np.float32)}
    torch.manual_seed(0)
    task = PitchExtractionTask(hp, device="cpu")
    trainer = Trainer(hp, task, device="cpu", work_dir=str(tmp_path / "pe"))
    trainer.initialize()
    trainer.train_step(batch)
    trainer.train_step(batch)
    path = trainer.save_checkpoint()
    stats = {k: v for k, v in task.pe.state_dict().items() if "running" in k}
    assert len(stats) == 6 and float(stats["mel_prenet.layers.0.2.running_var"].min()) != 1.0

    loaded = tsyn.load_pe(path, hp)
    for k, v in task.pe.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    jstats = pe_state_dict({"params": {}, "batch_stats": jck.convert_pe(
        jck.load_torch_state_dict(path))["batch_stats"]})
    for k, v in stats.items():
        assert torch.equal(jstats[k], v), k

    torch.manual_seed(1)
    fresh = PitchExtractionTask(hp, device="cpu")
    resumed = Trainer(hp, fresh, device="cpu", work_dir=str(tmp_path / "pe"))
    resumed.initialize()
    assert resumed.global_step == 2
    for k, v in task.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # the two runs take the same next step
    assert torch.equal(trainer.generator.get_state(), resumed.generator.get_state())
    la, lb = trainer.train_step(batch), resumed.train_step(batch)
    assert all(torch.equal(la[k], lb[k]) for k in la)
    for k, v in task.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
