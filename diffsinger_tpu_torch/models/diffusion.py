"""Gaussian shallow diffusion over mel-spectrograms: the epsilon-prediction
training loss and the DDPM and PLMS samplers (counterpart of
diffsinger_tpu/models/diffusion.py).

Loss and sampler are pure functions over a ``denoise_fn(x, t, cond)`` closure:
the sampler calls the one the object is built with, the loss the one it is
handed, so a caller that differentiates the denoiser names its own. The
reverse loop is a Python loop.
  * DDPM (``pndm_speedup`` 0): K steps, one denoiser call each. Noise comes
    from an explicit ``noise`` tensor [K+1, B, T, M] (the start draw first,
    then one draw per reverse step in loop order) or from a
    ``torch.Generator``.
  * PLMS (``pndm_speedup`` = interval): the steps ``arange(0, K, interval)``
    in reverse; the first is the order-1 warm-up with two denoiser calls, the
    rest ramp through Adams-Bashforth orders 2, 3 and 4 over the last three
    epsilon estimates, so K / interval steps make K / interval + 1 calls. The
    only draw is the start, ``noise`` [1, B, T, M].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from diffsinger_tpu_torch.parallel.mesh import draw as draw_rows, global_mean

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def linear_beta_schedule(timesteps: int, max_beta: float = 0.01) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 100
    k_step: int = 100
    loss_type: str = "l1"
    schedule_type: str = "cosine"
    max_beta: float = 0.01
    spec_min: Tuple[float, ...] = ()
    spec_max: Tuple[float, ...] = ()
    keep_bins: int = 80
    pndm_speedup: int = 0  # 0: DDPM
    gaussian_start: bool = False

    @classmethod
    def from_hparams(cls, hp: Dict[str, Any]) -> "DiffusionConfig":
        return cls(
            timesteps=int(hp.get("timesteps", 100)),
            k_step=int(hp.get("K_step", hp.get("timesteps", 100))),
            loss_type=hp.get("diff_loss_type", "l1"),
            schedule_type=hp.get("schedule_type", "cosine"),
            max_beta=float(hp.get("max_beta", 0.01)),
            spec_min=tuple(hp.get("spec_min", []) or []),
            spec_max=tuple(hp.get("spec_max", []) or []),
            keep_bins=int(hp.get("keep_bins", 80)),
            pndm_speedup=int(hp.get("pndm_speedup") or 0),
            gaussian_start=bool(hp.get("gaussian_start", False)),
        )


_TABLES = ("alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
           "posterior_mean_coef1", "posterior_mean_coef2",
           "posterior_log_variance_clipped", "_spec_min", "_spec_max")


class GaussianDiffusion:
    """Schedule plus sampling functions around a denoiser closure. The
    coefficient tables are float64 numpy; each device gets them once as
    float32 tensors, so a reverse step makes no host-to-device copy."""

    def __init__(self, cfg: DiffusionConfig, denoise_fn: DenoiseFn):
        self.cfg = cfg
        self.denoise_fn = denoise_fn
        if cfg.schedule_type == "linear":
            betas = linear_beta_schedule(cfg.timesteps, cfg.max_beta)
        else:
            betas = cosine_beta_schedule(cfg.timesteps)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        self.alphas_cumprod = alphas_cumprod
        self.sqrt_alphas_cumprod = np.sqrt(alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / alphas_cumprod - 1)
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        self.posterior_log_variance_clipped = np.log(np.maximum(posterior_variance,
                                                                1e-20))
        self.posterior_mean_coef1 = (betas * np.sqrt(alphas_cumprod_prev)
                                     / (1.0 - alphas_cumprod))
        self.posterior_mean_coef2 = ((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                     / (1.0 - alphas_cumprod))
        if cfg.spec_min and cfg.spec_max:
            self._spec_min = np.asarray(cfg.spec_min, np.float32)[: cfg.keep_bins]
            self._spec_max = np.asarray(cfg.spec_max, np.float32)[: cfg.keep_bins]
        else:  # identity codec when stats are absent
            self._spec_min = np.full((cfg.keep_bins,), -1.0, np.float32)
            self._spec_max = np.full((cfg.keep_bins,), 1.0, np.float32)
        self._on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _tables(self, device: torch.device) -> Dict[str, torch.Tensor]:
        tables = self._on_device.get(device)
        if tables is None:
            tables = self._on_device[device] = {
                name: torch.as_tensor(getattr(self, name), dtype=torch.float32,
                                      device=device) for name in _TABLES}
        return tables

    def _extract(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Per-timestep coefficients of table ``name`` for t [B], shaped [B, 1, 1]."""
        return self._tables(t.device)[name][t][:, None, None]

    def norm_spec(self, x: torch.Tensor) -> torch.Tensor:
        tables = self._tables(x.device)
        lo, hi = tables["_spec_min"], tables["_spec_max"]
        return (x - lo) / (hi - lo) * 2 - 1

    def denorm_spec(self, x: torch.Tensor) -> torch.Tensor:
        tables = self._tables(x.device)
        lo, hi = tables["_spec_min"], tables["_spec_max"]
        return (x + 1) / 2 * (hi - lo) + lo

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        return (self._extract("sqrt_alphas_cumprod", t) * x_start
                + self._extract("sqrt_one_minus_alphas_cumprod", t) * noise)

    def p_losses(self, denoise_fn: DenoiseFn, x_start: torch.Tensor, t: torch.Tensor,
                 cond, noise: torch.Tensor,
                 nonpadding: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Epsilon-prediction loss of ``denoise_fn``; x_start is the normalized
        mel [B, T, M]."""
        eps_hat = denoise_fn(self.q_sample(x_start, t, noise), t, cond)
        if self.cfg.loss_type == "l1":
            err = (noise - eps_hat).abs()
        elif self.cfg.loss_type == "l2":
            err = (noise - eps_hat) ** 2
        else:
            raise NotImplementedError(self.cfg.loss_type)
        if nonpadding is not None:
            err = err * nonpadding[:, :, None]
        # over the global batch's elements under a data mesh
        return global_mean(err)

    def training_loss(self, denoise_fn: DenoiseFn, ref_mels: torch.Tensor,
                      t: torch.Tensor, cond, noise: torch.Tensor,
                      nonpadding: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``norm_spec`` of the target mel, then :meth:`p_losses`."""
        return self.p_losses(denoise_fn, self.norm_spec(ref_mels), t, cond, noise,
                             nonpadding)

    def p_sample_step(self, x: torch.Tensor, t: torch.Tensor, cond,
                      noise: torch.Tensor, clip_denoised: bool = True) -> torch.Tensor:
        """One DDPM reverse step."""
        eps = self.denoise_fn(x, t, cond)
        x_recon = (self._extract("sqrt_recip_alphas_cumprod", t) * x
                   - self._extract("sqrt_recipm1_alphas_cumprod", t) * eps)
        if clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        mean = (self._extract("posterior_mean_coef1", t) * x_recon
                + self._extract("posterior_mean_coef2", t) * x)
        log_var = self._extract("posterior_log_variance_clipped", t)
        nonzero = (t > 0).to(x.dtype)[:, None, None]
        return mean + nonzero * torch.exp(0.5 * log_var) * noise

    def _plms_x_pred(self, x: torch.Tensor, eps: torch.Tensor, t: torch.Tensor,
                     interval: int) -> torch.Tensor:
        """x_t -> x_{t - interval} given an epsilon estimate; the target's
        alpha-bar is 1 once t < interval."""
        a_t = self._extract("alphas_cumprod", t)
        a_prev = torch.where((t < interval)[:, None, None], torch.ones_like(a_t),
                             self._extract("alphas_cumprod",
                                           torch.clamp(t - interval, min=0)))
        a_t_sq, a_prev_sq = torch.sqrt(a_t), torch.sqrt(a_prev)
        x_delta = (a_prev - a_t) * (
            (1 / (a_t_sq * (a_t_sq + a_prev_sq))) * x
            - 1 / (a_t_sq * (torch.sqrt((1 - a_prev) * a_t)
                             + torch.sqrt((1 - a_t) * a_prev))) * eps)
        return x + x_delta

    def _plms_loop(self, x: torch.Tensor, cond_ctx) -> torch.Tensor:
        interval = int(self.cfg.pndm_speedup)
        ts = np.arange(0, self.cfg.k_step, interval)[::-1]
        b = x.shape[0]

        def t_vec(t: int) -> torch.Tensor:
            return torch.full((b,), int(t), dtype=torch.long, device=x.device)

        # warm-up (order 1): the one step that calls the denoiser twice
        t0 = t_vec(ts[0])
        eps0 = self.denoise_fn(x, t0, cond_ctx)
        x_pred = self._plms_x_pred(x, eps0, t0, interval)
        eps_prev = self.denoise_fn(x_pred, torch.clamp(t0 - interval, min=0), cond_ctx)
        x = self._plms_x_pred(x, (eps0 + eps_prev) / 2, t0, interval)
        ring = [eps0]  # earlier epsilon estimates, newest first, at most three
        for t in ts[1:]:
            tv = t_vec(t)
            eps = self.denoise_fn(x, tv, cond_ctx)
            if len(ring) == 1:
                eps_prime = (3 * eps - ring[0]) / 2
            elif len(ring) == 2:
                eps_prime = (23 * eps - 16 * ring[0] + 5 * ring[1]) / 12
            else:
                eps_prime = (55 * eps - 59 * ring[0] + 37 * ring[1] - 9 * ring[2]) / 24
            x = self._plms_x_pred(x, eps_prime, tv, interval)
            ring = [eps] + ring[:2]
        return x

    def denoiser_calls(self) -> int:
        """Denoiser calls of one :meth:`sample`."""
        if self.cfg.pndm_speedup:
            return len(range(0, self.cfg.k_step, int(self.cfg.pndm_speedup))) + 1
        return self.cfg.k_step

    def sample(self, cond: torch.Tensor, fs2_mel: Optional[torch.Tensor] = None,
               tgt_nonpadding: Optional[torch.Tensor] = None, cond_ctx=None,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full reverse diffusion from the shallow boost at K_step-1 (or from
        Gaussian noise), DDPM or PLMS by ``pndm_speedup``. cond [B, T, H];
        fs2_mel [B, T, M] boost mel. ``cond_ctx`` replaces what reaches
        ``denoise_fn`` (e.g. the hoisted per-layer conditioner projections).
        Returns the denormalized mel."""
        cfg = self.cfg
        b, t_mel, _ = cond.shape
        shape = (b, t_mel, cfg.keep_bins)
        k = cfg.k_step
        if cond_ctx is None:
            cond_ctx = cond
        n_draws = 1 if cfg.pndm_speedup else k + 1
        if noise is not None and tuple(noise.shape) != (n_draws,) + shape:
            raise ValueError(f"noise must be {(n_draws,) + shape}, got {tuple(noise.shape)}")

        def draw(i: int) -> torch.Tensor:
            if noise is not None:
                return noise[i].to(cond.device, torch.float32)
            # drawn for the global batch under a data mesh
            return draw_rows(torch.randn, shape, generator=generator, device=cond.device)

        if cfg.gaussian_start or fs2_mel is None:
            x = draw(0)
        else:
            x = self.q_sample(self.norm_spec(fs2_mel),
                              torch.full((b,), k - 1, dtype=torch.long,
                                         device=cond.device), draw(0))
        if cfg.pndm_speedup:
            x = self._plms_loop(x, cond_ctx)
        else:
            for i, t_step in enumerate(range(k - 1, -1, -1)):
                t_vec = torch.full((b,), t_step, dtype=torch.long, device=cond.device)
                x = self.p_sample_step(x, t_vec, cond_ctx, draw(i + 1))
        x = self.denorm_spec(x)
        if tgt_nonpadding is not None:
            x = x * tgt_nonpadding[:, :, None]
        return x
