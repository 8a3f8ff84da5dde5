from .dit import DiTBlock, TripoSGDiT, TripoSGDiTConfig
from .pipeline import TripoSG, TripoSGConfig, TripoSGPipeline
from .vae import TripoSGVAE, TripoSGVAEConfig

__all__ = ["DiTBlock", "TripoSG", "TripoSGConfig", "TripoSGPipeline",
           "TripoSGDiT", "TripoSGDiTConfig", "TripoSGVAE", "TripoSGVAEConfig"]
