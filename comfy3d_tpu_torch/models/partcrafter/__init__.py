from .pipeline import (PartCrafter, PartCrafterConfig, PartCrafterDiT,
                       PartCrafterDiTConfig, PartCrafterPipeline, merge_parts)

__all__ = ["PartCrafter", "PartCrafterConfig", "PartCrafterDiT",
           "PartCrafterDiTConfig", "PartCrafterPipeline", "merge_parts"]
