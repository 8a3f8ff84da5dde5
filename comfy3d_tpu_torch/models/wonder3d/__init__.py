from .pipeline import Wonder3D, Wonder3DConfig, Wonder3DPipeline

__all__ = ["Wonder3D", "Wonder3DConfig", "Wonder3DPipeline"]
