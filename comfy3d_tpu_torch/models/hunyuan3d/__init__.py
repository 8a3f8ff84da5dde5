from .pipeline import (Hunyuan3DShape, Hunyuan3DShapeConfig,
                       Hunyuan3DShapePipeline)

__all__ = ["Hunyuan3DShape", "Hunyuan3DShapeConfig", "Hunyuan3DShapePipeline"]
