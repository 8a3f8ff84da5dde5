"""The diffusion substrate: the conditional UNet, the VAE and the samplers
(ports of `comfy3d_tpu/models/diffusion/{unet,vae,schedulers}.py`)."""

from . import schedulers, unet, vae
from .schedulers import DDIM, SchedulerConfig, make_scheduler, sample_loop
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig

__all__ = ["schedulers", "unet", "vae", "DDIM", "SchedulerConfig",
           "make_scheduler", "sample_loop", "UNet2DCondition", "UNetConfig",
           "AutoencoderKL", "VAEConfig"]
