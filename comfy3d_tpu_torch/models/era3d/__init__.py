from .pipeline import Era3D, Era3DConfig, Era3DPipeline

__all__ = ["Era3D", "Era3DConfig", "Era3DPipeline"]
