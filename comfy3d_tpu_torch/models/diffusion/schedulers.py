"""Diffusion samplers: the noise schedule and deterministic DDIM.

Port of `comfy3d_tpu/models/diffusion/schedulers.py`, DDIM only. The
schedule is the JAX package's: `alphas` (ᾱ_t) are made in float64 numpy
and cast to float32 once; timesteps use "leading" (or "trailing") spacing
with no offset. A step is (model output, step index, sample) → sample, and
`sample_loop` runs the steps as a plain Python loop:

    sched = make_scheduler("DDIMScheduler", SchedulerConfig(), num_steps)
    latents = sample_loop(sched, denoise_fn, latents * sched.init_sigma)

The other samplers of the reference's registry (EulerAncestral, Euler,
DDPM, DDIMParallel, LCM, KDPM2, KDPM2Ancestral) are not ported yet:
`make_scheduler` raises for them rather than run a different sampler.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "epsilon"       # or "v_prediction"
    timestep_spacing: str = "leading"      # or "trailing"
    # >0: MV-Adapter's shifted-SNR schedule, snr(t)·scale^{-t/(N-1)}
    snr_shift_scale: float = 0.0


def make_alphas(cfg: SchedulerConfig) -> np.ndarray:
    """ᾱ_t for t = 0 … N-1, in float64."""
    if cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                            cfg.num_train_timesteps) ** 2
    elif cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end,
                            cfg.num_train_timesteps)
    else:
        raise ValueError(cfg.beta_schedule)
    abar = np.cumprod(1.0 - betas)
    if cfg.snr_shift_scale and cfg.snr_shift_scale > 0:
        snr = abar / (1.0 - abar)
        w = np.arange(cfg.num_train_timesteps) \
            / (cfg.num_train_timesteps - 1)
        snr = snr * cfg.snr_shift_scale ** (-w)
        abar = snr / (1.0 + snr)
    return abar


def make_timesteps(cfg: SchedulerConfig, num_steps: int) -> np.ndarray:
    """The sampled timesteps, largest first (int64)."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "trailing":
        ts = np.round(np.arange(n, 0, -n / num_steps)).astype(np.int64) - 1
    else:
        step = n // num_steps
        ts = (np.arange(0, num_steps) * step).round()[::-1].astype(
            np.int64)
    return ts


def _predict_x0_eps(model_out, sample, alpha_t, cfg: SchedulerConfig):
    """→ (x0, eps) from the model output under the prediction type;
    `alpha_t` is a float32 0-d tensor."""
    sqrt_a = torch.sqrt(alpha_t)
    sqrt_1ma = torch.sqrt(1.0 - alpha_t)
    if cfg.prediction_type == "epsilon":
        eps = model_out
        x0 = (sample - sqrt_1ma * eps) / sqrt_a
    elif cfg.prediction_type == "v_prediction":
        x0 = sqrt_a * sample - sqrt_1ma * model_out
        eps = sqrt_a * model_out + sqrt_1ma * sample
    else:
        raise ValueError(cfg.prediction_type)
    return x0, eps


class DDIM:
    """Deterministic DDIM (eta = 0). `timesteps` is an int64 numpy array;
    `alphas` a float32 tensor, moved to the sample's device at each step."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 num_steps: int = 50):
        self.cfg = cfg
        self.num_steps = num_steps
        self.timesteps = make_timesteps(cfg, num_steps)
        self.alphas = torch.as_tensor(make_alphas(cfg).astype(np.float32))

    @property
    def loop_steps(self) -> int:
        return self.num_steps

    @property
    def init_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample, i: int):
        return sample

    def _alpha(self, t: int, like: torch.Tensor) -> torch.Tensor:
        return self.alphas[t].to(like.device)

    def step(self, model_out, i: int, sample):
        alpha_t = self._alpha(int(self.timesteps[i]), sample)
        if i + 1 < self.num_steps:
            alpha_prev = self._alpha(int(self.timesteps[i + 1]), sample)
        else:
            alpha_prev = torch.ones((), device=sample.device)
        x0, eps = _predict_x0_eps(model_out, sample, alpha_t, self.cfg)
        return torch.sqrt(alpha_prev) * x0 \
            + torch.sqrt(1 - alpha_prev) * eps


# the reference's scheduler registry (`DIFFUSERS_SCHEDULER_DICT`): the port
# has DDIM; the others raise, naming the ROADMAP item that brings them
SCHEDULERS = {"DDIMScheduler": DDIM}
NOT_PORTED = ("EulerAncestralDiscreteScheduler", "EulerDiscreteScheduler",
              "DDPMScheduler", "DDIMParallelScheduler", "LCMScheduler",
              "KDPM2AncestralDiscreteScheduler", "KDPM2DiscreteScheduler")


def make_scheduler(name, cfg: SchedulerConfig = SchedulerConfig(),
                   num_steps: int = 50):
    """A scheduler by registry name (a trailing comma, as in the
    reference's keys, is tolerated). Only "DDIMScheduler" is ported; any
    other name, None included (the JAX package's EulerAncestral default),
    raises NotImplementedError."""
    key = str(name).rstrip(",").strip() if name else ""
    cls = SCHEDULERS.get(key)
    if cls is None:
        raise NotImplementedError(
            f"scheduler {name!r} is not ported; only 'DDIMScheduler' is "
            f"(the others, {', '.join(NOT_PORTED)}, are ROADMAP A.6.5)")
    return cls(cfg, num_steps)


def sample_loop(sched, denoise_fn, latents):
    """The whole denoise loop. `denoise_fn(x_scaled, i, t)` → model output
    (guidance folded in by the caller), with `t` the step's timestep as a
    Python int. The caller scales the initial latents by
    `sched.init_sigma`."""
    lat = latents
    for i in range(sched.loop_steps):
        x_in = sched.scale_model_input(lat, i)
        out = denoise_fn(x_in, i, int(sched.timesteps[i]))
        lat = sched.step(out, i, lat)
    return lat
