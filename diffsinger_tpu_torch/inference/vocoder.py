"""Vocoders (counterpart of diffsinger_tpu/inference/vocoder.py): the
registry, HiFiGAN (with NSF), ParallelWaveGAN and the Griffin-Lim fallback,
``BaseVocoder.wav2spec`` and the spectral-subtraction ``denoise``.

``HifiGAN.apply`` runs the serving forward, ``ops/hifigan_mrf.py:
hifigan_mrf_apply``: the MRF scales of at most 128 channels go through the
hand-written kernel, in float32 or, with ``vocoder_compute_dtype:
bfloat16``, in bf16. The JAX package's ``vocoder_backend`` values
(``module``, ``mrf``, ``packed``, ``fast``) name layouts of one function on
the TPU; here all four take that one path, and ``mrf`` / ``packed`` keep
their refusal of ``resblock: '2'`` (whose generator runs its convolutions
outside the kernel). NSF is on with ``use_nsf`` (or ``use_pitch_embed``
beside an explicit geometry), as the JAX wrapper keys it; an NSF call given
F0 draws its source from ``source`` (rand_ini, noise) or a
``torch.Generator``. The MRF weights are packed into the kernel layout at the
first ``apply`` and kept; ``load_state_dict`` and ``to`` repack.

``HifiGAN(hp)`` loads ``vocoder_ckpt``: the newest ``model_ckpt_steps_*.ckpt``
of that directory with the geometry of its ``config.yaml``, or the official
release layout (``config.json`` + ``generator_v1``); the generator sits under
``model_gen``, ``generator`` or ``model``, and weight-norm pairs are folded.
``PWG(hp)`` loads the newest ``model_ckpt_steps_*.ckpt`` or, failing that,
the official ``checkpoint-*steps.pkl`` with its mel statistics
(``stats.h5`` when ``h5py`` imports, else ``stats.npy``). ``spec2wav`` /
``spec2wav_batch`` vocode by Griffin-Lim (numpy + scipy on the host) when
neither a checkpoint nor the caller's ``load_state_dict`` gave the
generator its weights, as the JAX wrapper does when it has no params.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from diffsinger_tpu_torch.convert.checkpoint import (convert_pwg, find_latest_ckpt,
                                                     generator_state_dict, torch_load)
from diffsinger_tpu_torch.models.hifigan import HifiGanConfig, HifiGanGenerator, draw_source
from diffsinger_tpu_torch.models.pwg import ParallelWaveGANGenerator, PWGConfig
from diffsinger_tpu_torch.ops.hifigan_mrf import hifigan_mrf_apply, pack_mrf_scales
from diffsinger_tpu_torch.ops.mel import MelConfig, mel_filterbank, wav2spec
from diffsinger_tpu_torch.utils.device import resolve_device
from diffsinger_tpu_torch.utils.pitch import f0_to_coarse_np

VOCODERS: Dict[str, Type] = {}
# the JAX package's vocoder_backend values: layouts of one generator function
BACKENDS = ("module", "mrf", "packed", "fast")


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    return cls


def get_vocoder_cls(hp) -> Type:
    """Short names ('hifigan') or reference dotted paths
    ('vocoders.hifigan.HifiGAN')."""
    name = str(hp.get("vocoder", "hifigan")).split(".")[-1].lower()
    if name in VOCODERS:
        return VOCODERS[name]
    raise KeyError(f"unknown vocoder {hp.get('vocoder')}")


def pad_frames(t: int, hp) -> int:
    """A frame count rounded up to ``vocoder_pad_multiple`` (1: unchanged)."""
    mult = int(hp.get("vocoder_pad_multiple", 1))
    return t if mult <= 1 else -(-t // mult) * mult


def _to_tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, np.float32))
    return t.to(device, torch.float32)


def _vocoder_hparams(hp: Dict[str, Any]) -> Tuple[Dict[str, Any], Optional[str]]:
    """(the generator's hparams, the checkpoint to load) for ``vocoder_ckpt``."""
    base_dir = hp.get("vocoder_ckpt") or ""
    ckpt = find_latest_ckpt(base_dir) if base_dir else None
    gen_hp: Dict[str, Any] = dict(hp)
    if base_dir and os.path.exists(os.path.join(base_dir, "config.yaml")):
        import yaml

        with open(os.path.join(base_dir, "config.yaml")) as f:
            gen_hp.update(yaml.safe_load(f) or {})
    elif base_dir and ckpt is None and os.path.exists(os.path.join(base_dir, "config.json")):
        # the official HiFi-GAN release: config.json + generator_v1 whose
        # weights sit under 'generator'
        with open(os.path.join(base_dir, "config.json")) as f:
            cfg_json = json.load(f)
        if "sampling_rate" in cfg_json:
            cfg_json.setdefault("audio_sample_rate", cfg_json["sampling_rate"])
        gen_hp.update(cfg_json)
        if os.path.exists(os.path.join(base_dir, "generator_v1")):
            ckpt = os.path.join(base_dir, "generator_v1")
    gen_hp["use_pitch_embed"] = bool(hp.get("use_nsf", False)
                                     or gen_hp.get("use_pitch_embed", False))
    return gen_hp, ckpt


def _host(a) -> Optional[np.ndarray]:
    if a is None:
        return None
    return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float32)


class BaseVocoder:
    def spec2wav(self, mel, **kwargs) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def wav2spec(wav_fn: str, hp) -> Tuple[np.ndarray, np.ndarray]:
        """A wav file -> (waveform, log10 mel [T, M]), conditioned as the
        binarizer conditions it (``trim_long_sil``, ``loud_norm``)."""
        from diffsinger_tpu_torch.data.binarize import condition_wav
        from diffsinger_tpu_torch.utils.misc import load_wav

        cfg = MelConfig.from_hparams(hp)
        wav = condition_wav(load_wav(wav_fn, cfg.sample_rate), hp, cfg.sample_rate)
        return wav2spec(wav, cfg)


@register_vocoder
class HifiGAN(BaseVocoder):
    def __init__(self, hp: Dict[str, Any], device="cuda"):
        self.device = resolve_device(device)
        self.hp = hp
        gen_hp, ckpt = _vocoder_hparams(hp)
        self.cfg = HifiGanConfig.from_hparams(gen_hp)
        backend = str(hp.get("vocoder_backend", "module"))
        if backend not in BACKENDS:
            raise ValueError(f"vocoder_backend={backend}: one of {BACKENDS}")
        if backend in ("mrf", "packed") and self.cfg.resblock != "1":
            raise ValueError(f"vocoder_backend '{backend}' supports resblock '1' "
                             "(the released HiFiGAN v1 configs)")
        self.model = HifiGanGenerator(self.cfg).eval()
        self._packed = None
        self.has_weights = False
        if ckpt is not None:
            self.load_state_dict(generator_state_dict(torch_load(ckpt)))
            print(f"| loaded hifigan vocoder from {ckpt}")
        self.model.to(self.device)

    def load_state_dict(self, state_dict, strict: bool = True):
        out = self.model.load_state_dict(state_dict, strict=strict)
        self._packed = None
        self.has_weights = True
        return out

    def to(self, device) -> "HifiGAN":
        self.device = torch.device(device)
        self.model.to(self.device)
        self._packed = None
        return self

    @torch.no_grad()
    def apply(self, mel: torch.Tensor, f0: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              source: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """mel [B, T, M] (log10 domain) -> wav [B, T * hop]. With NSF and
        ``f0`` [B, T] (Hz), the source draws are ``source`` = (rand_ini
        [B, 1, 9], noise [B, T * hop, 9]) when given, else drawn from
        ``generator`` (a generator seeded 0 when that is None too)."""
        if self._packed is None:
            self._packed = pack_mrf_scales(self.model)
        mel = _to_tensor(mel, self.device)
        if not (self.cfg.use_pitch_embed and f0 is not None):
            return hifigan_mrf_apply(self.model, mel, self._packed)
        b, t = mel.shape[:2]
        if source is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            source = draw_source(b, t * self.cfg.total_upsample, self.device, generator)
        rand_ini, noise = (_to_tensor(a, self.device) for a in source)
        return hifigan_mrf_apply(self.model, mel, self._packed, f0=_to_tensor(f0, self.device),
                                 rand_ini=rand_ini, noise=noise)

    def spec2wav(self, mel, f0=None, generator: Optional[torch.Generator] = None,
                 source=None) -> np.ndarray:
        """mel [T, M], f0 [T] -> wav [T * hop]. The mel is padded to
        ``vocoder_pad_multiple`` frames with its minimum and F0 with zeros
        (unvoiced); NSF ``source`` draws then cover the padded length."""
        mel = _host(mel)
        if not self.has_weights:
            return GriffinLim(self.hp).spec2wav(mel)
        t = int(mel.shape[0])
        t_pad = pad_frames(t, self.hp)
        if t_pad != t:
            mel = np.pad(mel, ((0, t_pad - t), (0, 0)), constant_values=float(mel.min()))
            if f0 is not None:
                f0 = np.pad(_host(f0), (0, t_pad - t))
        f0_b = None if f0 is None else _to_tensor(f0, self.device)[None]
        wav = self.apply(mel[None], f0_b, generator=generator, source=source)
        return wav[0, : t * self.cfg.total_upsample].cpu().numpy()

    def spec2wav_batch(self, mels, lengths: Sequence[int], f0s=None,
                       generator: Optional[torch.Generator] = None,
                       source=None) -> List[np.ndarray]:
        """Batched vocoding of padded mels [B, T, M] (with NSF, F0 [B, T] and
        optional source draws for B x T * hop samples); returns the waveforms
        trimmed to ``lengths[i] * hop`` samples."""
        if not self.has_weights:
            gl = GriffinLim(self.hp)
            return [gl.spec2wav(np.asarray(m)[:n]) for m, n in zip(mels, lengths)]
        wav = self.apply(mels, f0s, generator=generator, source=source).cpu().numpy()
        hop = self.cfg.total_upsample
        return [wav[i, : int(n) * hop] for i, n in enumerate(lengths)]


def _load_pwg_stats(base_dir: str, fmt: str) -> Tuple[np.ndarray, np.ndarray]:
    """An official PWG release's mel statistics -> (mean, scale), each [M]:
    ``stats.h5`` (datasets ``mean`` and ``scale``) when the config's
    ``format`` is ``hdf5`` and ``h5py`` imports, else ``stats.npy`` (rows
    mean and scale), else ``stats.h5`` through ``h5py`` after all. Raises
    when neither file is there: a mel that is not standardized would give a
    wrong waveform without a word."""
    h5 = os.path.join(base_dir, "stats.h5")
    npy = os.path.join(base_dir, "stats.npy")

    def read_h5():
        import h5py

        with h5py.File(h5, "r") as f:
            return np.asarray(f["mean"], np.float32), np.asarray(f["scale"], np.float32)

    if fmt == "hdf5" and os.path.exists(h5):
        try:
            return read_h5()
        except ImportError:
            if not os.path.exists(npy):
                raise
    if os.path.exists(npy):
        stats = np.load(npy).astype(np.float32)
        return stats[0], stats[1]
    if os.path.exists(h5):
        return read_h5()
    raise FileNotFoundError(
        f"official PWG checkpoint in {base_dir} needs stats.h5/stats.npy "
        "(training-set mel mean/scale) — refusing to synthesize from "
        "un-standardized mels")


@register_vocoder
class PWG(BaseVocoder):
    """ParallelWaveGAN: the generator from ``vocoder_ckpt`` (its
    ``config.yaml`` gives the geometry; upstream's checkpoint or the official
    ``.pkl`` with its statistics). ``spec2wav`` standardizes the mel per bin
    for an official release, pads it to ``vocoder_pad_multiple`` frames and
    by ``aux_context_window`` frames at each edge (edge values), and feeds
    noise ``z`` at the audio rate (given, or drawn from a generator, seeded
    0 when none is given) and, for a pitch-embedding PWG, the coarse pitch of
    F0. Griffin-Lim without a checkpoint."""

    def __init__(self, hp: Dict[str, Any], device="cuda"):
        self.device = resolve_device(device)
        self.hp = hp
        base_dir = hp.get("vocoder_ckpt") or ""
        cfg_dict: Dict[str, Any] = {}
        if base_dir and os.path.exists(os.path.join(base_dir, "config.yaml")):
            import yaml

            with open(os.path.join(base_dir, "config.yaml")) as f:
                cfg_dict = yaml.safe_load(f) or {}
        self.cfg = PWGConfig.from_config_dict(cfg_dict)
        self.model = ParallelWaveGANGenerator(self.cfg).eval()
        self.has_weights = False
        self.scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (mean, scale)
        ckpt = find_latest_ckpt(base_dir) if base_dir else None
        if ckpt is None and base_dir:
            pkls = sorted(glob.glob(os.path.join(base_dir, "checkpoint-*steps.pkl")))
            ckpt = pkls[-1] if pkls else None
        if ckpt is not None:
            sd, official = convert_pwg(torch_load(ckpt))
            if official:
                self.scaler = _load_pwg_stats(base_dir, str(cfg_dict.get("format", "hdf5")))
            self.load_state_dict(sd)
            print(f"| loaded PWG vocoder from {ckpt}")
        self.model.to(self.device)

    def load_state_dict(self, state_dict, strict: bool = True):
        out = self.model.load_state_dict(state_dict, strict=strict)
        self.has_weights = True
        return out

    def to(self, device) -> "PWG":
        self.device = torch.device(device)
        self.model.to(self.device)
        return self

    @torch.no_grad()
    def spec2wav(self, mel, f0=None, z=None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """mel [T, M] (log10 domain), f0 [T] (Hz) -> wav [T * hop]. ``z``
        [T_pad * hop] covers the padded length."""
        mel = _host(mel)
        if not self.has_weights:
            return GriffinLim(self.hp).spec2wav(mel)
        w = self.cfg.aux_context_window
        hop = int(self.hp["hop_size"])
        t = int(mel.shape[0])
        if self.scaler is not None:
            mean, scale = self.scaler
            mel = (mel - mean) / scale
        t_pad = pad_frames(t, self.hp)
        f0 = _host(f0)
        if t_pad != t:
            mel = np.pad(mel, ((0, t_pad - t), (0, 0)), "edge")
            if f0 is not None:
                f0 = np.pad(f0, (0, t_pad - t))
        c = np.pad(mel, ((w, w), (0, 0)), "edge")[None]
        if z is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            z = torch.randn((1, t_pad * hop), generator=generator, device=self.device)
        else:
            z = _to_tensor(z, self.device).reshape(1, -1)
        pitch = None
        if self.cfg.use_pitch_embed and f0 is not None:
            pitch = torch.from_numpy(np.pad(f0_to_coarse_np(f0.copy()), (w, w), "edge")[None])
            pitch = pitch.to(self.device, torch.long)
        wav = self.model(z, _to_tensor(c, self.device), pitch)
        return wav[0, : t * hop].cpu().numpy()


@register_vocoder
class GriffinLim(BaseVocoder):
    """Phase-retrieval vocoder that needs no checkpoint (numpy + scipy on the
    host; ``device`` is accepted for the registry's call and not used)."""

    def __init__(self, hp, n_iter: int = 32, device=None):
        self.cfg = MelConfig.from_hparams(hp)
        self.n_iter = n_iter

    def spec2wav(self, mel, **kwargs) -> np.ndarray:
        from scipy.signal import istft, stft

        cfg = self.cfg
        mel = np.asarray(mel)
        min_frames = cfg.win_length // cfg.hop_size + 2
        if mel.shape[0] < min_frames:  # too short for an STFT frame: pad
            mel = np.pad(mel, ((0, min_frames - mel.shape[0]), (0, 0)),
                         constant_values=mel.min() if mel.size else -5.0)
        basis = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax)
        mag = np.maximum(1e-10, np.linalg.pinv(basis) @ (10.0 ** mel).T)  # [F, T]
        angles = np.exp(2j * np.pi * np.random.RandomState(0).rand(*mag.shape))
        nper, nov = cfg.win_length, cfg.win_length - cfg.hop_size
        for _ in range(self.n_iter):
            _, wav = istft(mag * angles, nperseg=nper, noverlap=nov, window="hann",
                           input_onesided=True)
            _, _, spec = stft(wav, nperseg=nper, noverlap=nov, window="hann", nfft=cfg.n_fft)
            spec = spec[:, : mag.shape[1]]
            if spec.shape[1] < mag.shape[1]:
                spec = np.pad(spec, ((0, 0), (0, mag.shape[1] - spec.shape[1])))
            angles = np.exp(1j * np.angle(spec))
        _, wav = istft(mag * angles, nperseg=nper, noverlap=nov, window="hann",
                       input_onesided=True)
        return wav.astype(np.float32)


def denoise(wav: np.ndarray, hp, v: float = 0.1) -> np.ndarray:
    """Spectral subtraction: every STFT magnitude lowered by ``v`` (floored
    at 0), the phase kept."""
    from scipy.signal import istft, stft

    cfg = MelConfig.from_hparams(hp)
    nper, nov = cfg.win_length, cfg.win_length - cfg.hop_size
    _, _, spec = stft(wav, nperseg=nper, noverlap=nov, nfft=cfg.n_fft)
    mag = np.maximum(np.abs(spec) - v, 0.0)
    _, out = istft(mag * np.exp(1j * np.angle(spec)), nperseg=nper, noverlap=nov)
    return out.astype(np.float32)
