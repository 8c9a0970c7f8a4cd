"""Serving path: text -> mel -> waveform on the card (counterpart of
diffsinger_tpu/inference/serve.py:FusedSynthesizer).

One call runs the FS2 conditioner (MIDI inputs for singing), the reverse
diffusion (DDPM or PLMS) over the DiffNet kernel, the optional
PitchExtractor, and the HiFiGAN (or NSF-HiFiGAN) vocoder over the MRF
kernel, with the mel kept on the device. Shapes are bucketed as in the JAX
synthesizer: text to ``txt_pad_multiple`` (16), mel frames to
``mel_pad_multiple`` (128), and requests of one mel bucket are stacked into
power-of-two batches of at most ``max_serve_batch`` (16); pad rows repeat
the first request and are dropped.

The F0 that drives an NSF vocoder comes from the PitchExtractor when one is
given (it reads the raw sampler mel, whose zero-masked padding frames it
turns to 0 Hz), else from the model's own ``f0_denorm`` when it has a pitch
predictor.

Under a data mesh (``mesh=``, every rank handed the same requests) each
data rank runs its contiguous rows of every device batch (the batch's rows
padded to a multiple of the data axis by repeating the first), the
sampler's noise and the NSF source draws are drawn (or given) for the
global batch and sliced, the silence floor is the global batch's minimum,
and the waveforms are all-gathered, so every rank returns the whole result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from diffsinger_tpu_torch.models.fs2 import SPK_EMBED_DIM
from diffsinger_tpu_torch.parallel.mesh import Mesh
from diffsinger_tpu_torch.utils import trace
from diffsinger_tpu_torch.utils.device import resolve_device


def _round_up(n: int, mult: int) -> int:
    return n if mult <= 1 else -(-n // mult) * mult


def _as_noise(noise) -> torch.Tensor:
    return noise if isinstance(noise, torch.Tensor) else torch.from_numpy(np.array(noise))


def _as_source(source):
    return None if source is None else tuple(_as_noise(a) for a in source)


class FusedSynthesizer:
    """Utterance synthesis for serving.

    hp: hparams (``txt_pad_multiple``, ``mel_pad_multiple``, ``max_serve_batch``,
    ``serve_wav_int16``, ``seed``, ``use_midi``, ``use_spk_embed``); task: a
    ``DiffSingerTask``;
    vocoder: a ``HifiGAN`` wrapper; pe: an optional ``PitchExtractor`` whose
    F0 drives an NSF vocoder. All are moved to ``device`` (default CUDA;
    raises when no CUDA device is present). ``mesh``: serve each batch's
    rows over its data axis (see the module docstring)."""

    # per-token keys padded to the text bucket; per-frame keys to the mel
    # bucket; speaker ids [B] and speaker embeddings [B, 256] stacked as given
    _TOKEN_KEYS = ("txt_tokens", "pitch_midi", "midi_dur", "is_slur")
    _MEL_KEYS = ("mel2ph", "f0", "uv")
    _FLAT_KEYS = ("spk_ids", "spk_embed")

    def __init__(self, hp: Dict[str, Any], task, vocoder, pe=None,
                 use_gt_dur: bool = False, use_gt_f0: bool = False, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else Mesh(1, 1)
        self.hp = hp
        self.task = task
        self.vocoder = vocoder
        self.pe = pe
        if task.device != self.device:
            task.to(self.device)
            task.device = self.device
        if vocoder.device != self.device:
            vocoder.to(self.device)
        if pe is not None:
            pe.to(self.device).eval()
        self.use_gt_dur = use_gt_dur
        self.use_gt_f0 = use_gt_f0
        self.txt_mult = int(hp.get("txt_pad_multiple", 16))
        self.mel_mult = int(hp.get("mel_pad_multiple", 128))
        self.max_b = int(hp.get("max_serve_batch", 16))
        self.wav_int16 = bool(hp.get("serve_wav_int16", False))
        self.hop = vocoder.cfg.total_upsample

    # ------------------------------------------------------------------ run
    @torch.no_grad()
    def _run(self, batch: Dict[str, Any], t_mel: int, noise=None, source=None,
             generator=None):
        """One device batch. ``noise`` fixes the sampler's draws and
        ``source`` (rand_ini, noise) the NSF source's; ``generator`` draws
        whatever is not fixed. On a data mesh ``batch``, ``noise`` and
        ``source`` are the global batch's and so is what returns."""
        mesh, rows = self.mesh, None
        if mesh.distributed:
            batch, noise, source, rows = self._local_rows(mesh, batch, noise, source)
        with mesh.active():
            out = self.task.inference(batch, t_mel=t_mel, use_gt_dur=self.use_gt_dur,
                                      use_gt_f0=self.use_gt_f0, noise=noise,
                                      generator=generator)
            mel = out["mel_out"]
            if self.pe is not None:
                # the raw sampler mel: its zeroed padding frames are the PE's
                # padding mask, so their F0 comes out 0 Hz
                with trace.span("ds.pe"):
                    f0 = self.pe(mel)["f0_denorm_pred"]
            else:
                f0 = out.get("f0_denorm")
            with trace.span("ds.vocoder"):
                # the sampler zero-masks mel2ph==0 frames, and 0 in the log10-mel
                # domain is loud: set bucket padding to the batch's silence floor
                # (one minimum over the whole padded batch) before vocoding
                pad_mask = (out["mel2ph"] > 0)[..., None]
                mel = torch.where(pad_mask, mel, mesh.data_min(mel.min()))
                wav = self.vocoder.apply(mel, f0=f0, generator=generator, source=source)
        # the host waits here for the batch's device work
        with trace.span("ds.serve.fetch"):
            wav, mel2ph = mesh.data_gather(wav)[:rows], mesh.data_gather(out["mel2ph"])[:rows]
            if self.wav_int16:
                wav = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
            return wav.cpu().numpy(), mel2ph.cpu().numpy()

    @staticmethod
    def _local_rows(mesh: Mesh, batch: Dict[str, Any], noise, source):
        """This data rank's rows of a global batch, of its given noise
        ([K, B, T, M]) and source draws ([B, ...] each), the batch padded to
        a multiple of the data axis by repeating its first row; and the
        global row count."""
        rows = int(batch["txt_tokens"].shape[0])
        target = -(-rows // mesh.num_data) * mesh.num_data
        start, stop = mesh.row_span(target)

        # global row of each local row: the batch's own, then copies of row 0
        take = torch.cat([torch.arange(rows), torch.zeros(target - rows, dtype=torch.long)])
        take = take[start:stop]

        def local(a, dim=0):
            if a.shape[dim] != rows:
                return a
            a = torch.as_tensor(a)
            return a.index_select(dim, take.to(a.device))

        batch = {k: local(v) if hasattr(v, "shape") and v.ndim >= 1 else v
                 for k, v in batch.items()}
        noise = None if noise is None else local(noise, 1)
        source = None if source is None else tuple(local(a) for a in source)
        return batch, noise, source, rows

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.hp.get("seed", 1234) if seed is None else seed))
        return gen

    # --------------------------------------------------------- micro-batch
    def _bucket_b(self, n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_b)

    def _stack_group(self, items, t_txt_b: int, t_mel_b: int) -> Dict[str, np.ndarray]:
        """Stack (idx, batch) single-utterance dicts into one padded batch."""
        b_pad = self._bucket_b(len(items))
        stacked: Dict[str, np.ndarray] = {}
        for keys, pad_to in ((self._TOKEN_KEYS, t_txt_b), (self._MEL_KEYS, t_mel_b),
                             (self._FLAT_KEYS, None)):
            for k in keys:
                if not hasattr(items[0][1].get(k), "shape"):
                    continue
                rows = []
                for _, b in items:
                    a = np.asarray(b[k])
                    if pad_to is not None and a.ndim == 2 and a.shape[1] < pad_to:
                        a = np.pad(a, ((0, 0), (0, pad_to - a.shape[1])))
                    rows.append(a)
                a = np.concatenate(rows, axis=0)
                if a.shape[0] < b_pad:  # pad batch rows (discarded after)
                    a = np.concatenate([a] + [a[:1]] * (b_pad - a.shape[0]), axis=0)
                stacked[k] = a
        if self.use_gt_dur and "mel2ph" not in stacked:
            raise ValueError("FusedSynthesizer(use_gt_dur=True) requires "
                             "'mel2ph' in every request batch")
        if self.use_gt_f0 and not {"f0", "uv"} <= stacked.keys():
            raise ValueError("FusedSynthesizer(use_gt_f0=True) requires "
                             "'f0' and 'uv' in every request batch")
        return stacked

    def plan(self, requests) -> List[tuple]:
        """The device batches ``synthesize_many`` runs, in order:
        (t_mel bucket, [(request index, batch), ...], padded batch size)."""
        groups: Dict[int, list] = {}
        for i, (batch, t_mel) in enumerate(requests):
            groups.setdefault(_round_up(t_mel, self.mel_mult), []).append((i, batch))
        out = []
        for t_mel_b, group in sorted(groups.items()):
            for s in range(0, len(group), self.max_b):
                items = group[s:s + self.max_b]
                out.append((t_mel_b, items, self._bucket_b(len(items))))
        return out

    def synthesize_many(self, requests, noises: Optional[Sequence] = None,
                        seed: Optional[int] = None,
                        sources: Optional[Sequence] = None) -> List[np.ndarray]:
        """``requests``: (batch, t_mel) pairs, each batch a single-utterance
        dict. Requests are grouped by mel bucket, chunked, padded to a common
        text bucket and a power-of-two batch, and each chunk runs as one
        device batch. ``noises`` optionally fixes the sampler noise, one
        array per batch of :meth:`plan` ([K+1, B_pad, T_bucket, M] for DDPM,
        [1, B_pad, T_bucket, M] for PLMS), and ``sources`` the NSF source
        draws, one (rand_ini [B_pad, 1, 9], noise [B_pad, T_bucket * hop, 9])
        pair per batch; a generator seeded from ``seed`` (default
        ``hp['seed']``) draws what is not given. Returns the waveforms,
        trimmed to their frames * hop, in input order."""
        plan = self.plan(requests)
        for name, given in (("noise array", noises), ("source pair", sources)):
            if given is not None and len(given) != len(plan):
                raise ValueError(f"need one {name} per batch ({len(plan)})")
        gen = self._generator(seed)
        wavs: Dict[int, np.ndarray] = {}
        for g, (t_mel_b, items, _) in enumerate(plan):
            with trace.span("ds.serve.batch"):
                with trace.span("ds.serve.stack"):
                    t_txt_b = _round_up(max(int(b["txt_tokens"].shape[1]) for _, b in items),
                                        self.txt_mult)
                    stacked = self._stack_group(items, t_txt_b, t_mel_b)
                noise = None if noises is None else _as_noise(noises[g])
                source = None if sources is None else _as_source(sources[g])
                wav, mel2ph = self._run(stacked, t_mel_b, noise=noise, source=source,
                                        generator=gen)
                for j, (i, _) in enumerate(items):
                    n = int((mel2ph[j] > 0).sum()) or t_mel_b
                    wavs[i] = wav[j][: n * self.hop]
        return [wavs[i] for i in range(len(requests))]

    def warmup(self, t_mel_buckets, batch_sizes=(1,), t_txt: Optional[int] = None):
        """Run each (mel bucket, batch size) once on dummy inputs, so the first
        real request does not pay the kernel build and library set-up."""
        t_txt = _round_up(t_txt or self.txt_mult, self.txt_mult)
        gen = self._generator(0)
        for t_mel in t_mel_buckets:
            t_mel_b = _round_up(t_mel, self.mel_mult)
            for b in batch_sizes:
                batch = {"txt_tokens": np.ones((b, t_txt), np.int64),
                         "spk_ids": np.zeros((b,), np.int64)}
                if self.hp.get("use_spk_embed"):
                    batch["spk_embed"] = np.zeros((b, SPK_EMBED_DIM), np.float32)
                if self.hp.get("use_midi"):
                    batch["pitch_midi"] = np.full((b, t_txt), 60, np.int64)
                    batch["midi_dur"] = np.full((b, t_txt), 0.2, np.float32)
                    batch["is_slur"] = np.zeros((b, t_txt), np.int64)
                if self.use_gt_dur:
                    batch["mel2ph"] = np.ones((b, t_mel_b), np.int64)
                if self.use_gt_f0:
                    batch["f0"] = np.full((b, t_mel_b), 200.0, np.float32)
                    batch["uv"] = np.zeros((b, t_mel_b), np.float32)
                self._run(batch, t_mel_b, generator=gen)

    def __call__(self, batch: Dict[str, Any], t_mel: int, noise=None,
                 seed: Optional[int] = None, source=None) -> np.ndarray:
        """One request as given (batch rows are not padded); returns the
        trimmed waveform of its first item. ``noise`` and ``source`` fix the
        draws as in :meth:`synthesize_many`."""
        t_mel_b = _round_up(t_mel, self.mel_mult)
        with trace.span("ds.serve.batch"):
            with trace.span("ds.serve.stack"):
                t_txt = int(batch["txt_tokens"].shape[1])
                t_txt_pad = _round_up(t_txt, self.txt_mult)
                if t_txt_pad != t_txt:
                    batch = dict(batch)
                    for k in self._TOKEN_KEYS:
                        if hasattr(batch.get(k), "shape"):
                            batch[k] = np.pad(np.asarray(batch[k]),
                                              ((0, 0), (0, t_txt_pad - t_txt)))
            noise = None if noise is None else _as_noise(noise)
            wav, mel2ph = self._run(batch, t_mel_b, noise=noise, source=_as_source(source),
                                    generator=self._generator(seed))
            n = int((mel2ph[0] > 0).sum()) or t_mel_b
            return wav[0][: n * self.hop]
