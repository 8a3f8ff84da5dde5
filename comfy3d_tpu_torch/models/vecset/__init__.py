"""Vecset (latent-set) substrate of Hunyuan3D-2's shape generation: the
Fourier embedding and attention blocks (`blocks`), `ShapeVAE` with its
dense and octree volume decodes (`vae`), the flow-matching DiT (`dit`) and
its Euler schedule (`scheduler`)."""

from .blocks import (CrossAttentionDecoder, FourierConfig, VecTransformer,
                     fourier_embed)
from .dit import DiTConfig, Hunyuan3DDiT
from .scheduler import flow_match_sigmas, flow_match_step
from .vae import ShapeVAE, ShapeVAEConfig

__all__ = ["CrossAttentionDecoder", "DiTConfig", "FourierConfig",
           "Hunyuan3DDiT", "ShapeVAE", "ShapeVAEConfig", "VecTransformer",
           "flow_match_sigmas", "flow_match_step", "fourier_embed"]
