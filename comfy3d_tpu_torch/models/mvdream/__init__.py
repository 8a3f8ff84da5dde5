from .pipeline import (CameraEmbed, MVDream, MVDreamConfig, MVDreamPipeline,
                       orbit_c2w_flat)

__all__ = ["CameraEmbed", "MVDream", "MVDreamConfig", "MVDreamPipeline",
           "orbit_c2w_flat"]
