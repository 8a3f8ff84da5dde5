from .model import LGMConfig, LGMUNet, decode_gaussians, plucker_rays
from .pipeline import LGMPipeline

__all__ = ["LGMConfig", "LGMUNet", "LGMPipeline", "decode_gaussians",
           "plucker_rays"]
