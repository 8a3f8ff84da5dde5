from .model import TripoSR, TripoSRConfig
from .pipeline import TripoSRPipeline

__all__ = ["TripoSR", "TripoSRConfig", "TripoSRPipeline"]
