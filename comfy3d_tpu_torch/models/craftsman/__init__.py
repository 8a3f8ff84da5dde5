from .pipeline import (Craftsman, CraftsmanConfig, CraftsmanPipeline,
                       DenoiserConfig, SimpleDenoiser)

__all__ = ["Craftsman", "CraftsmanConfig", "CraftsmanPipeline",
           "DenoiserConfig", "SimpleDenoiser"]
