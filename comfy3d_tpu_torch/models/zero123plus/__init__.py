from .pipeline import (Zero123Plus, Zero123PlusConfig, Zero123PlusPipeline,
                       scale_image, scale_latents, unscale_image,
                       unscale_latents)

__all__ = ["Zero123Plus", "Zero123PlusConfig", "Zero123PlusPipeline",
           "scale_image", "scale_latents", "unscale_image", "unscale_latents"]
