"""Diffusion samplers: the noise schedules and the reference's registry.

Port of `comfy3d_tpu/models/diffusion/schedulers.py`: EulerAncestral,
Euler, DDIM, DDPM, DDIMParallel, LCM, KDPM2 and KDPM2Ancestral. The
schedule is the JAX package's: `alphas` (ᾱ_t) and sigmas are made in
float64 numpy and cast to float32 once; timesteps use "leading" (or
"trailing") spacing with no offset. Scalar arithmetic runs on float32 0-d
tensors on the CPU, which broadcast onto a sample on any device.

A step is (model output, step index, sample) → sample. The stochastic
samplers (`stochastic = True`) take the step's noise as a tensor of the
sample's shape; the caller draws it. KDPM2's pair of evaluations per
interval runs over `loop_steps = 2·N − 1` indices with an `aux` tensor
(the held first-substep sample), through the protocol every sampler has:

    sched = make_scheduler(name, cfg, num_steps)
    aux = sched.init_aux(latents)
    for i in range(sched.loop_steps):
        out = model(sched.scale_model_input(latents, i), sched.timesteps[i])
        latents, aux = sched.step_aux(out, i, latents, aux, noise=...)

`sample_loop` runs that loop; the caller scales the initial latents by
`sched.init_sigma`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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


def _f32(a) -> torch.Tensor:
    """A float64 numpy table → float32 tensor, cast once."""
    return torch.as_tensor(np.asarray(a).astype(np.float32))


def _sigma_table(cfg: SchedulerConfig, num_steps: int):
    """(timesteps, the float64 sigmas √((1−ᾱ)/ᾱ) of every train step)."""
    alphas = make_alphas(cfg)
    return make_timesteps(cfg, num_steps), np.sqrt((1 - alphas) / alphas)


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


def _sigma_x0(model_out, sample, sigma, cfg: SchedulerConfig):
    """x0 in sigma space (the Euler family's)."""
    if cfg.prediction_type == "epsilon":
        return sample - sigma * model_out
    if cfg.prediction_type == "v_prediction":
        return sample / (sigma ** 2 + 1) \
            - (sigma / torch.sqrt(sigma ** 2 + 1)) * model_out
    raise ValueError(cfg.prediction_type)


class _FirstOrder:
    """`loop_steps` / `init_aux` / `step_aux` of a sampler without
    cross-step memory; a stochastic one's `step` takes `noise`."""

    stochastic = False

    @property
    def loop_steps(self) -> int:
        return self.num_steps

    def init_aux(self, latents):
        return None

    def step_aux(self, model_out, i: int, sample, aux, noise=None):
        if self.stochastic:
            return self.step(model_out, i, sample, noise), aux
        return self.step(model_out, i, sample), aux


class DDIM(_FirstOrder):
    """Deterministic DDIM (eta = 0). `timesteps` is an int64 numpy array,
    `alphas` a float32 tensor."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 num_steps: int = 50):
        self.cfg = cfg
        self.num_steps = num_steps
        self.timesteps = make_timesteps(cfg, num_steps)
        self.alphas = _f32(make_alphas(cfg))

    @property
    def init_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample, i: int):
        return sample

    def _alpha_pair(self, i: int):
        """(ᾱ at step i, ᾱ at step i + 1, 1 after the last step)."""
        alpha_t = self.alphas[int(self.timesteps[i])]
        if i + 1 < self.num_steps:
            return alpha_t, self.alphas[int(self.timesteps[i + 1])]
        return alpha_t, torch.ones(())

    def step(self, model_out, i: int, sample):
        alpha_t, alpha_prev = self._alpha_pair(i)
        x0, eps = _predict_x0_eps(model_out, sample, alpha_t, self.cfg)
        return torch.sqrt(alpha_prev) * x0 \
            + torch.sqrt(1 - alpha_prev) * eps

    def add_noise(self, x0, noise, i: int):
        a = self.alphas[int(self.timesteps[i])]
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise


class _SigmaSampler(_FirstOrder):
    """The Euler family's sigma space: karras=False sigmas from the alpha
    schedule (then 0), the model input scaled by 1/√(σ² + 1)."""

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 num_steps: int = 50):
        self.cfg = cfg
        self.num_steps = num_steps
        ts, sig_all = _sigma_table(cfg, num_steps)
        self.timesteps = ts
        self.sigmas = _f32(np.concatenate([sig_all[ts], [0.0]]))

    @property
    def init_sigma(self):
        return torch.sqrt(self.sigmas[0] ** 2 + 1.0)

    def scale_model_input(self, sample, i: int):
        return sample / torch.sqrt(self.sigmas[i] ** 2 + 1.0)

    def add_noise(self, x0, noise, i: int):
        return x0 + self.sigmas[i] * noise


class EulerAncestral(_SigmaSampler):
    """Euler-ancestral in sigma space (diffusers
    EulerAncestralDiscreteScheduler): each interval split into σ_down (the
    Euler step) and σ_up (the noise). At the last step σ_next = 0 makes
    σ_up 0; the step's noise is taken all the same."""

    stochastic = True

    def step(self, model_out, i: int, sample, noise=None):
        sigma, sigma_next = self.sigmas[i], self.sigmas[i + 1]
        x0 = _sigma_x0(model_out, sample, sigma, self.cfg)
        sigma_up = torch.sqrt(torch.clamp_min(
            sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
            / torch.clamp_min(sigma ** 2, 1e-12), 0.0))
        sigma_down = torch.sqrt(torch.clamp_min(
            sigma_next ** 2 - sigma_up ** 2, 0.0))
        d = (sample - x0) / torch.clamp_min(sigma, 1e-12)
        prev = sample + d * (sigma_down - sigma)
        if noise is not None:
            prev = prev + sigma_up * noise
        return prev


class DDPM(DDIM):
    """Ancestral DDPM (diffusers DDPMScheduler, variance_type
    fixed_small): the posterior mean over the selected timestep pairs plus
    β̃ noise (none after the last step). MV-Adapter's sampler."""

    stochastic = True

    def step(self, model_out, i: int, sample, noise=None):
        alpha_t, alpha_prev = self._alpha_pair(i)
        cur_alpha = alpha_t / alpha_prev
        cur_beta = 1.0 - cur_alpha
        x0, _ = _predict_x0_eps(model_out, sample, alpha_t, self.cfg)
        c_x0 = torch.sqrt(alpha_prev) * cur_beta / (1.0 - alpha_t)
        c_xt = torch.sqrt(cur_alpha) * (1.0 - alpha_prev) / (1.0 - alpha_t)
        prev = c_x0 * x0 + c_xt * sample
        if noise is not None:
            var = torch.clamp_min((1.0 - alpha_prev) / (1.0 - alpha_t)
                                  * cur_beta, 1e-20)
            scale = torch.sqrt(var) if i + 1 < self.num_steps \
                else torch.zeros(())
            prev = prev + scale * noise
        return prev


class DDIMParallel(DDIM):
    """diffusers `DDIMParallelScheduler`: plain DDIM for sequential
    sampling; `batch_step` steps K (output, index, sample) triples at
    once, for ParaDiGMS-style parallel denoising."""

    def batch_step(self, model_outs, idxs, samples):
        """model_outs [K, ...]; idxs K step indices; samples [K, ...] →
        each index's previous sample (eta = 0, no noise)."""
        return torch.stack([self.step(o, int(i), x)
                            for o, i, x in zip(model_outs, idxs, samples)])


class Euler(_SigmaSampler):
    """diffusers `EulerDiscreteScheduler` (non-ancestral, karras=False):
    the deterministic Euler step in sigma space."""

    def step(self, model_out, i: int, sample):
        sigma = self.sigmas[i]
        x0 = _sigma_x0(model_out, sample, sigma, self.cfg)
        d = (sample - x0) / torch.clamp_min(sigma, 1e-12)
        return sample + d * (self.sigmas[i + 1] - sigma)


class LCM(_FirstOrder):
    """Latent-consistency sampling (diffusers `LCMScheduler`): each step
    blends the x0 prediction with the sample through the boundary
    scalings c_skip / c_out (σ_data 0.5, timestep scaling 10), then
    re-noises to the next timestep; the last step returns the blend."""

    stochastic = True
    sigma_data: float = 0.5
    timestep_scaling: float = 10.0

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 num_steps: int = 4):
        self.cfg = cfg
        self.num_steps = num_steps
        self.timesteps = make_timesteps(cfg, num_steps)
        self.alphas = _f32(make_alphas(cfg))

    @property
    def init_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample, i: int):
        return sample

    def step(self, model_out, i: int, sample, noise=None):
        alpha_t = self.alphas[int(self.timesteps[i])]
        x0, _ = _predict_x0_eps(model_out, sample, alpha_t, self.cfg)
        st = self.timestep_scaling * torch.tensor(
            float(self.timesteps[i]), dtype=torch.float32)
        c_skip = self.sigma_data ** 2 / (st ** 2 + self.sigma_data ** 2)
        c_out = st / torch.sqrt(st ** 2 + self.sigma_data ** 2)
        denoised = c_out * x0 + c_skip * sample
        if i + 1 >= self.num_steps:
            return denoised
        alpha_next = self.alphas[int(self.timesteps[i + 1])]
        if noise is None:
            noise = torch.zeros_like(sample)
        return torch.sqrt(alpha_next) * denoised \
            + torch.sqrt(1.0 - alpha_next) * noise

    def add_noise(self, x0, noise, i: int):
        a = self.alphas[int(self.timesteps[i])]
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise


class KDPM2:
    """2nd-order DPM (k-diffusion "sample_dpm_2", diffusers
    `KDPM2DiscreteScheduler`): each interval evaluates the model at σ_i
    and at the log-space midpoint σ_interp, over an interleaved index space
    of `loop_steps = 2·N − 1` evaluations (σ_0, interp_0, σ_1, …; the last
    interval, ending at σ = 0, takes one Euler step from σ_{N−1}). `aux`
    holds the first substep's sample."""

    ancestral = stochastic = False

    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 num_steps: int = 50):
        self.cfg = cfg
        self.num_steps = num_steps
        ts, sig_all = _sigma_table(cfg, num_steps)
        sig = sig_all[ts].astype(np.float64)          # descending
        nxt = np.concatenate([sig[1:], [0.0]])
        if self.ancestral:
            # the ancestral split of each interval, then the midpoint to
            # σ_down (k-diffusion sample_dpm_2_ancestral)
            up = np.sqrt(np.maximum(
                nxt ** 2 * (sig ** 2 - nxt ** 2)
                / np.maximum(sig ** 2, 1e-20), 0.0))
            down = np.sqrt(np.maximum(nxt ** 2 - up ** 2, 0.0))
            self.sigmas_up = _f32(up)
        else:
            down = nxt
        with np.errstate(divide="ignore"):
            interp = np.exp(0.5 * (np.log(np.maximum(sig, 1e-20))
                                   + np.log(np.maximum(down, 1e-20))))
        interp = np.where(down <= 0, 0.0, interp)

        eval_sig = np.empty(2 * num_steps - 1)
        eval_sig[0::2] = sig
        eval_sig[1::2] = interp[:-1]
        self.eval_sigmas = _f32(eval_sig)
        # the timestep of each evaluation: the nearest train step's sigma
        ts_eval = np.empty(2 * num_steps - 1, np.int64)
        ts_eval[0::2] = ts
        ts_eval[1::2] = np.abs(sig_all[None, :]
                               - interp[:-1, None]).argmin(axis=1)
        self.timesteps = ts_eval
        self.sigmas = _f32(sig)
        self.sigmas_interp = _f32(interp)
        self.sigmas_down = _f32(down)

    @property
    def loop_steps(self) -> int:
        return 2 * self.num_steps - 1

    @property
    def init_sigma(self):
        return torch.sqrt(self.eval_sigmas[0] ** 2 + 1.0)

    def init_aux(self, latents):
        return torch.zeros_like(latents)

    def scale_model_input(self, sample, i: int):
        return sample / torch.sqrt(self.eval_sigmas[i] ** 2 + 1.0)

    def step_aux(self, model_out, i: int, sample, aux, noise=None):
        outer = i // 2
        sigma = self.sigmas[outer]
        sigma_mid = self.sigmas_interp[outer]
        sigma_end = self.sigmas_down[outer]
        last_interval = outer == self.num_steps - 1
        x0 = _sigma_x0(model_out, sample, self.eval_sigmas[i], self.cfg)
        if self.ancestral and noise is None:
            noise = torch.zeros_like(sample)
        if i % 2 == 0:
            # first substep: hold the sample, move to the midpoint (the
            # last interval: one Euler step straight to its end)
            d1 = (sample - x0) / torch.clamp_min(sigma, 1e-12)
            if not last_interval:
                return sample + d1 * (sigma_mid - sigma), sample
            prev = sample + d1 * (sigma_end - sigma)
            if self.ancestral:
                prev = prev + self.sigmas_up[outer] * noise
            return prev, sample
        # second substep: the midpoint's slope applied from the held sample
        d2 = (sample - x0) / torch.clamp_min(sigma_mid, 1e-12)
        prev = aux + d2 * (sigma_end - sigma)
        if self.ancestral:
            prev = prev + self.sigmas_up[outer] * noise
        return prev, torch.zeros_like(sample)

    def add_noise(self, x0, noise, i: int):
        return x0 + self.eval_sigmas[i] * noise


class KDPM2Ancestral(KDPM2):
    """diffusers `KDPM2AncestralDiscreteScheduler` (k-diffusion
    sample_dpm_2_ancestral): KDPM2 whose intervals end at the ancestral
    σ_down, with σ_up noise."""

    ancestral = stochastic = True


# the reference's scheduler registry (`DIFFUSERS_SCHEDULER_DICT`, trailing
# commas of its keys stripped)
SCHEDULERS = {
    "EulerAncestralDiscreteScheduler": EulerAncestral,
    "EulerDiscreteScheduler": Euler,
    "DDIMScheduler": DDIM,
    "DDPMScheduler": DDPM,
    "DDIMParallelScheduler": DDIMParallel,
    "LCMScheduler": LCM,
    "KDPM2AncestralDiscreteScheduler": KDPM2Ancestral,
    "KDPM2DiscreteScheduler": KDPM2,
}


def make_scheduler(name, cfg: SchedulerConfig = SchedulerConfig(),
                   num_steps: int = 50):
    """A scheduler by registry name (a trailing comma, as in the
    reference's keys, is tolerated). None, an empty or an unknown name →
    EulerAncestral, the zoo-wide default."""
    cls = SCHEDULERS.get(str(name).rstrip(",").strip()) if name else None
    return (cls or EulerAncestral)(cfg, num_steps)


def sample_loop(sched, denoise_fn, latents,
                noise: Optional[Callable[[int], torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
    """The whole denoise loop. `denoise_fn(x_scaled, i, t)` → model output
    (guidance folded in by the caller), with `t` the step's timestep as a
    Python int. A stochastic sampler's noise for step i is `noise(i)`, or,
    without `noise`, a draw of the latents' shape from `generator` (default:
    seed 0) on the latents' device. The caller scales the initial latents
    by `sched.init_sigma`."""
    if sched.stochastic and noise is None:
        if generator is None:
            generator = torch.Generator(latents.device).manual_seed(0)

        def noise(i):
            return torch.randn(latents.shape, generator=generator,
                               device=latents.device, dtype=latents.dtype)
    lat, aux = latents, sched.init_aux(latents)
    for i in range(sched.loop_steps):
        x_in = sched.scale_model_input(lat, i)
        out = denoise_fn(x_in, i, int(sched.timesteps[i]))
        lat, aux = sched.step_aux(out, i, lat, aux,
                                  noise(i) if sched.stochastic else None)
    return lat
