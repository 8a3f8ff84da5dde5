"""The diffusion substrate: the conditional UNet, the VAE and the samplers
(ports of `comfy3d_tpu/models/diffusion/{unet,vae,schedulers}.py`), and the
diffusers `config.json` readers (`config`)."""

from . import config, schedulers, unet, vae
from .config import unet_config_from_json, vae_config_from_json
from .schedulers import DDIM, SchedulerConfig, make_scheduler, sample_loop
from .unet import UNet2DCondition, UNetConfig
from .vae import AutoencoderKL, VAEConfig

__all__ = ["config", "schedulers", "unet", "vae", "unet_config_from_json",
           "vae_config_from_json", "DDIM", "SchedulerConfig",
           "make_scheduler", "sample_loop", "UNet2DCondition", "UNetConfig",
           "AutoencoderKL", "VAEConfig"]
