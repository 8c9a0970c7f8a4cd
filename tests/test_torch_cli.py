"""The port's command line as a user runs it, on the CPU: the mirror of
``tests/test_cli.py`` (config -> train a few steps with validation and
checkpoints -> --infer to the files on disk), once vocoding by Griffin-Lim,
once from a HiFiGAN ``vocoder_ckpt`` and once for an FS2 task; ``synthesize_dataset`` against the
JAX package's on the same test split, weights and draws; and
``set_hparams`` resolving the same dict as the JAX package's for the same
config, exp_name, overrides, ``--reset`` and saved ``config.yaml``."""

import glob
import os

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from diffsinger_tpu.config.hparams import set_hparams as jset_hparams
from diffsinger_tpu_torch import cli
from diffsinger_tpu_torch.config.hparams import set_hparams
from diffsinger_tpu_torch.inference.vocoder import get_vocoder_cls
from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator
from diffsinger_tpu_torch.tools.fixtures import write_hifigan_dir
from tests.helpers import make_synthetic_dataset, tiny_hparams

torch.set_num_threads(1)
# a small HiFiGAN at hop 256 (8 * 8 * 4)
VOC_GEOM = {"resblock": "1", "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],
            "upsample_initial_channel": 16, "resblock_kernel_sizes": [3, 7],
            "resblock_dilation_sizes": [[1, 3], [1, 3]], "audio_sample_rate": 22050,
            "audio_num_mel_bins": 80, "hop_size": 256, "use_pitch_embed": False}


def _config(tmp_path, **kw):
    data_dir = make_synthetic_dataset(str(tmp_path / "ds"))
    hp = tiny_hparams(data_dir)
    hp.update({
        "task_cls": "diff", "max_updates": 4, "val_check_interval": 2,
        "num_sanity_val_steps": 1, "num_valid_plots": 1, "log_interval": 2,
        "vocoder": "griffinlim", "audio_sample_rate": 22050,
        "fft_size": 1024, "win_size": 1024, "fmin": 80, "fmax": 7600,
        "use_gt_dur": True, "use_gt_f0": True, "save_gt": True,
        "mel_vmin": -6, "mel_vmax": 1.5, "test_input_dir": "",
        "num_test_samples": 0, "test_ids": [], "gen_dir_name": "",
        "out_wav_norm": False, "profile_infer": True, "pe_enable": False,
        "train_set_name": "train", "valid_set_name": "valid",
        "test_set_name": "test", "vocoder_pad_multiple": 64, **kw})
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(hp))
    return str(path)


def _check_run(work_dir, steps):
    ckpts = sorted(glob.glob(os.path.join(work_dir, "model_ckpt_steps_*.ckpt")))
    assert [int(p.rsplit("_", 1)[1][:-5]) for p in ckpts] == steps
    assert os.path.exists(os.path.join(work_dir, "best_valid.npy"))
    assert glob.glob(os.path.join(work_dir, "codes", "*", "diffsinger_tpu_torch", "cli.py"))


def _check_infer(gen_dir, data_dir, hop=256):
    from diffsinger_tpu_torch.data.indexed_dataset import IndexedDataset

    test = IndexedDataset(os.path.join(data_dir, "test"))
    assert len(test) == 2
    for i in range(len(test)):
        item = test[i]
        t_mel = len(item["mel"])
        mel = np.load(os.path.join(gen_dir, "P_mels_npy", f"{item['item_name']}.npy"))
        assert mel.shape == (t_mel, 80) and np.isfinite(mel).all()
        for kind in ("P", "G"):
            sr, wav = wavfile.read(os.path.join(gen_dir, "wavs", f"{kind}_{item['item_name']}.wav"))
            assert sr == 22050 and len(wav) >= t_mel * hop // 2
    return test


def test_cli_run_trains_and_infers_with_griffin_lim(tmp_path, monkeypatch, capsys):
    cfg = _config(tmp_path)
    monkeypatch.chdir(tmp_path)
    cli.run(["--config", cfg, "--exp_name", "cli_exp"], device="cpu")
    work_dir = os.path.join("checkpoints", "cli_exp")
    _check_run(work_dir, [2, 4])
    assert os.path.exists(os.path.join(work_dir, "config.yaml"))
    # --infer reads the saved config and the newest checkpoint
    cli.run(["--exp_name", "cli_exp", "--infer"], device="cpu")
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out and "RTF" in out
    gen_dirs = glob.glob(os.path.join(work_dir, "generated_4_*"))
    assert len(gen_dirs) == 1
    _check_infer(gen_dirs[0], str(tmp_path / "ds"))


def test_cli_train_and_infer_with_a_hifigan_checkpoint(tmp_path, capsys):
    torch.manual_seed(0)
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(VOC_GEOM))
    write_hifigan_dir(str(tmp_path / "voc"), gen.state_dict(), VOC_GEOM)
    cfg = _config(tmp_path, vocoder="hifigan", vocoder_ckpt=str(tmp_path / "voc"),
                  num_valid_plots=0)
    root = str(tmp_path / "checkpoints")
    hp = set_hparams(cfg, "voc_exp", ckpt_root=root)
    trainer = cli.train(hp, device="cpu")
    assert trainer.global_step == 4
    _check_run(hp["work_dir"], [2, 4])
    gen_dir = cli.infer(set_hparams(cfg, "voc_exp", infer=True, ckpt_root=root), device="cpu")
    assert os.path.basename(gen_dir).startswith("generated_4_")
    assert "loaded hifigan vocoder" in capsys.readouterr().out
    test = _check_infer(gen_dir, str(tmp_path / "ds"))
    # exactly T * hop samples: the vocoder, not Griffin-Lim, made them
    item = test[0]
    _, wav = wavfile.read(os.path.join(gen_dir, "wavs", f"P_{item['item_name']}.wav"))
    assert len(wav) == len(item["mel"]) * 256


def test_synthesize_dataset_matches_jax(tmp_path, monkeypatch):
    """``--infer``'s synthesis against JAX ``synthesize_dataset`` on the same
    test split, task weights and diffusion draws, with an NSF HiFiGAN
    (``vocoder_pad_multiple: 64`` pads mel and F0, the waveform is cut to
    T * hop) whose source draws are JAX's ``PRNGKey(0)`` ones: the same files;
    the G mels equal and the G waveforms (F0 through ``denorm_f0``) within
    5e-5, as ``tests/test_torch_hifigan.py`` holds the vocoder; the P mels and
    waveforms (the aligned frames, F0 from ``f0_denorm``) within 1e-4, as
    ``tests/test_torch_serve.py`` holds the whole synthesis."""
    import jax
    import jax.numpy as jnp

    from diffsinger_tpu import cli as jcli
    from diffsinger_tpu.data.dataset import FastSpeechDataset as JDataset
    from diffsinger_tpu.inference import synthesize as jsyn
    from diffsinger_tpu_torch.convert.from_jax import task_state_dict
    from diffsinger_tpu_torch.data.dataset import FastSpeechDataset
    from diffsinger_tpu_torch.inference import synthesize as tsyn
    from diffsinger_tpu_torch.inference.vocoder import HifiGAN, pad_frames
    from diffsinger_tpu_torch.tools.fixtures import write_task_ckpt
    from tests.test_torch_checkpoint import jax_sampler_noise
    from tests.test_torch_port_faults import jax_source_draws

    geom = {**VOC_GEOM, "use_pitch_embed": True}
    torch.manual_seed(0)
    gen = HifiGanGenerator(HifiGanConfig.from_hparams(geom))
    write_hifigan_dir(str(tmp_path / "voc"), gen.state_dict(), geom)
    cfg = _config(tmp_path, vocoder="hifigan", vocoder_ckpt=str(tmp_path / "voc"),
                  use_nsf=True, profile_infer=False)
    hp = set_hparams(cfg, "syn", ckpt_root=str(tmp_path / "checkpoints"))
    _, jtask = jcli._build(dict(hp))
    jds = JDataset(dict(hp), "test")
    params = jtask.init_params(jax.random.PRNGKey(0), next(jds.iter_batches()))
    params["denoiser"] = dict(params["denoiser"])
    params["denoiser"]["output_projection"] = {  # zero at init
        "kernel": jnp.asarray(np.random.RandomState(7).randn(1, 8, 80).astype(np.float32) * 0.1),
        "bias": jnp.zeros((80,), jnp.float32)}
    write_task_ckpt(hp["work_dir"], task_state_dict(jax.device_get(params)), step=5)

    wavs = {"jax": {}, "torch": {}}
    for side, mod in (("jax", jsyn), ("torch", tsyn)):
        def save(wav, mel, base_fn, gen_dir, hp_, f0=None, png=True, _side=side,
                 _orig=mod._save_result):
            wavs[_side][base_fn] = np.asarray(wav)
            return _orig(wav, mel, base_fn, gen_dir, hp_, f0, png=False)
        monkeypatch.setattr(mod, "_save_result", save)
    jdir = jsyn.synthesize_dataset(dict(hp), jtask, jds, params=params,
                                   out_dir=str(tmp_path / "jax_out"))

    # the port: JAX's per-utterance diffusion draws (its seed key split once
    # an utterance) and the NSF source JAX's wrapper draws from PRNGKey(0)
    _, task = cli._build(hp, "cpu")
    keys, run_inference = [jax.random.PRNGKey(int(hp["seed"]))], task.inference

    def inference(batch, **kw):
        keys[0], step_rng = jax.random.split(keys[0])
        noise = jax_sampler_noise(step_rng, int(hp["K_step"]), batch["mels"].shape)
        return run_inference(batch, noise=noise, **kw)

    task.inference = inference
    spec2wav = HifiGAN.spec2wav

    def nsf_spec2wav(self, mel, f0=None, **kw):
        t_wav = pad_frames(len(mel), hp) * 256
        return spec2wav(self, mel, f0=f0, source=jax_source_draws(jax.random.PRNGKey(0), 1,
                                                                  t_wav))

    monkeypatch.setattr(HifiGAN, "spec2wav", nsf_spec2wav)
    tdir = tsyn.synthesize_dataset(hp, task, FastSpeechDataset(hp, "test"), device="cpu")
    assert os.path.basename(tdir).startswith("generated_5_")

    for sub in ("wavs", "P_mels_npy", "G_mels_npy"):
        assert sorted(os.listdir(os.path.join(tdir, sub))) == \
            sorted(os.listdir(os.path.join(jdir, sub))), sub
    assert wavs["torch"].keys() == wavs["jax"].keys() and len(wavs["jax"]) == 4
    for name in sorted(os.listdir(os.path.join(jdir, "P_mels_npy"))):
        for kind, tol in (("P", 1e-4), ("G", 0.0)):
            got = np.load(os.path.join(tdir, f"{kind}_mels_npy", name))
            want = np.load(os.path.join(jdir, f"{kind}_mels_npy", name))
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f"{kind} {name}")
            wav_got, wav_want = wavs["torch"][f"{kind}_{name[:-4]}"], \
                wavs["jax"][f"{kind}_{name[:-4]}"]
            assert wav_got.shape == wav_want.shape == (len(want) * 256,)
            np.testing.assert_allclose(wav_got, wav_want, atol=1e-4 if kind == "P" else 5e-5,
                                       err_msg=f"{kind} {name}")
            assert np.abs(wav_want).max() > 1e-3


def test_cli_trains_and_infers_an_fs2_task(tmp_path, capsys):
    """``task_cls: fs2`` through the CLI: a FastSpeech2 with the ssim and l1
    mel losses trains, and ``--infer`` vocodes its decoder's mel to wavs."""
    cfg = _config(tmp_path, task_cls="fs2", num_valid_plots=0)
    root = str(tmp_path / "checkpoints")
    hp = set_hparams(cfg, "fs2_exp", ckpt_root=root)
    trainer = cli.train(hp, device="cpu")
    assert type(trainer.task).__name__ == "FastSpeech2Task"
    assert {"l1", "ssim", "pdur"} <= set(trainer.history[-1][2])
    _check_run(hp["work_dir"], [2, 4])
    gen_dir = cli.infer(set_hparams(cfg, "fs2_exp", infer=True, ckpt_root=root), device="cpu")
    assert os.path.basename(gen_dir).startswith("generated_4_")
    assert "restored checkpoint at step 4" in capsys.readouterr().out
    _check_infer(gen_dir, str(tmp_path / "ds"))


def test_cli_refusals(tmp_path):
    # multi_host starts a process group from torchrun's environment; without
    # one the run is refused before anything trains
    cfg = _config(tmp_path, multi_host=True)
    with pytest.raises(RuntimeError, match="torchrun"):
        cli.run(["--config", cfg, "--exp_name", "x", "--hparams", "max_updates=1"],
                device="cpu")
    assert get_vocoder_cls({"vocoder": "vocoders.pwg.PWG"}).__name__ == "PWG"
    with pytest.raises(KeyError):  # the JAX package registers no MelGAN vocoder either
        get_vocoder_cls({"vocoder": "melgan"})
    assert get_vocoder_cls({"vocoder": "vocoders.hifigan.HifiGAN"}).__name__ == "HifiGAN"


@pytest.mark.parametrize("case", ["fresh", "saved", "reset", "infer", "argv"])
def test_set_hparams_matches_jax(tmp_path, case):
    cfg = tmp_path / "cfg.yaml"
    base = tmp_path / "base.yaml"
    base.write_text(yaml.safe_dump({"lr": 0.5, "nested": {"a": 1, "b": 2}, "flag": False}))
    cfg.write_text(yaml.safe_dump({"base_config": ["./base.yaml"], "max_updates": 10,
                                   "nested": {"b": 3}, "name": "x"}))
    results = []
    for fn, root in ((set_hparams, tmp_path / "t"), (jset_hparams, tmp_path / "j")):
        kw = {"ckpt_root": str(root)}
        if fn is jset_hparams:
            kw["global_hparams"] = False
        if case != "fresh":  # an earlier run left its config.yaml
            fn(str(cfg), "exp", "max_updates=7", **kw)
        if case == "saved":
            hp = fn(str(cfg), "exp", "lr=0.25", **kw)
        elif case == "reset":
            hp = fn(str(cfg), "exp", "flag=true", reset=True, **kw)
        elif case == "infer":
            hp = fn("", "exp", "max_updates=9", infer=True, **kw)
        elif case == "argv":
            hp = fn(argv=["--exp_name", "exp", "--hparams", "nested={'a': 5},name=y",
                          "--validate"], **kw)
        else:
            hp = fn(str(cfg), "exp", "max_updates=20,new_key=5,nested={b: 4}", **kw)
        saved = yaml.safe_load((root / "exp" / "config.yaml").read_text())
        results.append((dict(hp), saved, str(root)))
    (t_hp, t_saved, t_root), (j_hp, j_saved, j_root) = results
    assert t_hp["work_dir"] == os.path.join(t_root, "exp")
    assert {**t_hp, "work_dir": ""} == {**j_hp, "work_dir": ""}
    assert {**t_saved, "work_dir": ""} == {**j_saved, "work_dir": ""}
    if case == "infer":
        assert t_hp["max_updates"] == 9 and t_saved["max_updates"] == 7  # not rewritten
